"""The order-by/limit kernel's and the key-mix kernel's plain versions
against the JAX package, on the CPU, with inputs made from a seed with numpy:

- K46 `order_limit_ref` against JAX `CompiledSelector._order_limit` (its
  jitted lexsort and limit), and `order_limit_partitioned_ref` against
  `jax.vmap` of it over [P]-tiled rows (each partition's own rows valid),
  `_flatten`ed as the JAX partition flattens: the same kept rows in the same
  order (every valid row in JAX's order, the invalid rows after them in
  row order). Keys of int32, int64, float32 and bool, asc and desc, 1-4 of them,
  with the edge values the encoding must keep (INT_MIN/MAX, -0.0 beside
  0.0, +-inf, NaN of either sign, ties); offset alone, limit alone, both,
  neither, and a limit with no key; R = 1, 33 and 513; and at the radix
  sort's tile edges (R 2,047/2,048/2,049: one block up to 2,048 rows, the
  grid above) with one key varying in every byte (int64 over its whole
  range, float32 over every bit pattern).
- The wrapper's packed key types (`_order_codes`).
- K47 `mix_keys_ref` against JAX `mix_keys` over JAX `_as_key_col`'s
  encoding (floats by their int32 bits), 1-8 columns of every key dtype
  with negative, extreme and float keys: bit for bit.

Everything compares exactly.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.groupby import _as_key_col as jax_as_key_col  # noqa: E402
from siddhi_tpu.core.selector import CompiledSelector as JaxSelector  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.ops import group as jgroup  # noqa: E402
from siddhi_tpu_torch.core.selector import (  # noqa: E402
    _order_codes,
    order_limit,
    order_limit_partitioned,
    order_limit_partitioned_ref,
    order_limit_ref,
)
from siddhi_tpu_torch.ops import group  # noqa: E402

_BIG = 2**31 - 1
I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)
NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]


def _key(rng, dtype: str, r: int) -> np.ndarray:
    """A key lane of `dtype` with its edge values mixed in and many ties."""
    if dtype == "int32":
        base = rng.integers(-3, 4, r).astype(np.int32)
        edges = np.array([I32.min, I32.max, 0, -1, 1], np.int32)
    elif dtype == "int64":
        base = rng.integers(-3, 4, r).astype(np.int64)
        edges = np.array([I64.min, I64.max, 0, -1, 2**40], np.int64)
    elif dtype == "float32":
        base = rng.choice(np.array([-1.5, 0.25, 2.0], np.float32), r)
        edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, NEG_NAN, 1e-38], np.float32)
    else:
        return rng.random(r) < 0.5
    pick = rng.random(r) < 0.4
    base[pick] = rng.choice(edges, int(pick.sum()))
    return base


def _jax_order(valid, keys, desc, offset, limit, rowid):
    """JAX `_order_limit` over one chunk: (kept mask, row ids in order)."""
    ns = types.SimpleNamespace(
        order_by=[(lambda _env, _k=k: _k, d) for k, d in zip(keys, desc)],
        limit=limit, offset=offset)
    b = JaxBatch(ts=jnp.zeros(valid.shape, jnp.int64), kind=jnp.zeros(valid.shape, jnp.int8),
                 valid=valid, cols={"row": rowid})
    out = JaxSelector._order_limit(ns, b, None)
    return out.valid, out.cols["row"]


def _lohi(offset, limit):
    lo = 0 if offset is None else offset
    return lo, _BIG if limit is None else lo + limit


CASES = [  # (R, key dtypes, desc flags, offset, limit)
    (1, ["float32"], [True], None, 1),
    (33, ["int32"], [False], 2, None),
    (33, ["float32", "int64"], [True, False], None, 5),
    (33, ["bool", "float32"], [True, False], 1, 3),
    (513, ["int64", "int32", "float32"], [True, True, False], None, None),
    (513, ["float32", "bool", "int32", "int64"], [False, False, True, True], 7, 20),
    (513, ["int32", "float32"], [False, True], 0, 513),
    (513, [], [], 3, 10),
]


@pytest.mark.parametrize("r,dtypes,desc,offset,limit", CASES)
def test_order_limit_matches_jax(r, dtypes, desc, offset, limit):
    rng = np.random.default_rng(r * 7 + len(dtypes))
    valid = rng.random(r) < 0.85
    keys = [_key(rng, d, r) for d in dtypes]
    jvalid, jrows = jax.jit(lambda v, ks: _jax_order(
        v, ks, desc, offset, limit, jnp.arange(r, dtype=jnp.int32)))(
        jnp.asarray(valid), [jnp.asarray(k) for k in keys])
    lo, hi = _lohi(offset, limit)
    perm, kept = order_limit_ref(torch.from_numpy(valid), [torch.from_numpy(k) for k in keys],
                                 desc, lo, hi)
    rows = np.arange(r) if perm is None else perm.numpy()
    # the same kept mask, and the same rows where it holds (the invalid rows,
    # never delivered, follow in row order in the port)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(rows[kept.numpy()], np.asarray(jrows)[np.asarray(jvalid)])
    n_valid = int(valid.sum())
    if perm is not None:
        np.testing.assert_array_equal(rows[:n_valid], np.asarray(jrows)[:n_valid])
        np.testing.assert_array_equal(rows[n_valid:], np.flatnonzero(~valid))
    # the wrapper takes the plain version for tensors on the CPU
    perm2, kept2 = order_limit(torch.from_numpy(valid), [torch.from_numpy(k) for k in keys],
                               desc, lo, hi)
    assert torch.equal(kept2, kept) and (perm is None) == (perm2 is None)


@pytest.mark.parametrize("p", [1, 8, 33])
@pytest.mark.parametrize("r,dtypes,desc,offset,limit", CASES[1:])
def test_order_limit_partitioned_matches_jax_vmap(p, r, dtypes, desc, offset, limit):
    """Each partition's rows through JAX `_order_limit` under `jax.vmap` over
    [P, R] tiles, `_flatten`ed (position first, then partition): the kept
    rows, in order, are the port's kept rows placed by (rank, slot)."""
    rng = np.random.default_rng(r + 100 * p + len(dtypes))
    part = rng.integers(0, p, r).astype(np.int64)
    valid = rng.random(r) < 0.85
    keys = [_key(rng, d, r) for d in dtypes]
    tiles = jnp.asarray(valid[None, :] & (part[None, :] == np.arange(p)[:, None]))
    jvalid, jrows = jax.jit(jax.vmap(lambda v, ks: _jax_order(
        v, ks, desc, offset, limit, jnp.arange(r, dtype=jnp.int32)), in_axes=(0, None)))(
        tiles, [jnp.asarray(k) for k in keys])
    # `_flatten`: swap to [R, P], then position-major
    flat_valid = np.asarray(jvalid).T.reshape(-1)
    want = np.asarray(jrows).T.reshape(-1)[flat_valid]
    lo, hi = _lohi(offset, limit)
    args = (torch.from_numpy(valid), [torch.from_numpy(k) for k in keys], desc,
            torch.from_numpy(part), p, lo, hi)
    perm, kept = order_limit_partitioned_ref(*args)
    rows = np.arange(r) if perm is None else perm.numpy()
    np.testing.assert_array_equal(rows[kept.numpy()], want)
    perm2, kept2 = order_limit_partitioned(*args)
    assert torch.equal(kept2, kept)


def _every_byte(rng, dtype: str, r: int) -> np.ndarray:
    """A key whose sort words vary in every byte: int64 over its whole range,
    or float32 over every bit pattern (NaN of both signs, -0.0, subnormals,
    +-inf mixed in)."""
    if dtype == "int64":
        k = rng.integers(I64.min, I64.max, r, endpoint=True).astype(np.int64)
        edges = np.array([I64.min, I64.max, 0, -1], np.int64)
    else:
        k = rng.integers(0, 2**32, r, dtype=np.uint64).astype(np.uint32).view(np.float32)
        edges = np.concatenate([
            np.array([np.nan, -0.0, 0.0, 1e-40, -1e-40, np.inf, -np.inf], np.float32),
            np.array([0xFFC00000, 0x7F800001, 1, 0x80000001], np.uint32).view(np.float32)])
    pick = rng.random(r) < 0.05
    k[pick] = rng.choice(edges, int(pick.sum()))
    return k


@pytest.mark.parametrize("r,dtype,desc,p", [(2047, "int64", True, None),
                                            (2048, "float32", False, None),
                                            (2049, "float32", True, None),
                                            (2049, "int64", False, 8)])
def test_order_limit_sort_edges_match_jax(r, dtype, desc, p):
    """One key varying in every byte at the radix sort's tile edges, against
    JAX `_order_limit` (flat) or its vmap (`_flatten`ed): every valid row
    in JAX's order."""
    rng = np.random.default_rng(r + len(dtype))
    valid = rng.random(r) < 0.85
    key = _every_byte(rng, dtype, r)
    rowid = jnp.arange(r, dtype=jnp.int32)
    if p is None:
        jvalid, jrows = jax.jit(lambda v, k: _jax_order(v, [k], [desc], None, None, rowid))(
            jnp.asarray(valid), jnp.asarray(key))
        perm, kept = order_limit_ref(torch.from_numpy(valid), [torch.from_numpy(key)], [desc], 0,
                                     _BIG)
        np.testing.assert_array_equal(kept.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(perm.numpy()[kept.numpy()],
                                      np.asarray(jrows)[np.asarray(jvalid)])
        return
    part = rng.integers(0, p, r).astype(np.int64)
    tiles = jnp.asarray(valid[None, :] & (part[None, :] == np.arange(p)[:, None]))
    jvalid, jrows = jax.jit(jax.vmap(lambda v, k: _jax_order(v, [k], [desc], None, None, rowid),
                                     in_axes=(0, None)))(tiles, jnp.asarray(key))
    want = np.asarray(jrows).T.reshape(-1)[np.asarray(jvalid).T.reshape(-1)]
    perm, kept = order_limit_partitioned_ref(torch.from_numpy(valid), [torch.from_numpy(key)],
                                             [desc], torch.from_numpy(part), p, 0, _BIG)
    np.testing.assert_array_equal(perm.numpy()[kept.numpy()], want)


def test_order_codes_pack_type_and_desc():
    """Key j's type code in bits 3j..3j+1 and its desc flag in bit 3j+2, as
    csrc/order_limit.cu unpacks them."""
    keys = [torch.zeros(2, dtype=d) for d in (torch.int32, torch.int64, torch.bool,
                                              torch.float32, torch.float32)]
    desc = [False, True, True, False, True]
    codes = _order_codes(keys, desc)
    assert [(codes >> (3 * j)) & 3 for j in range(5)] == [0, 1, 2, 3, 3]
    assert [(codes >> (3 * j + 2)) & 1 for j in range(5)] == [0, 1, 1, 0, 1]
    assert codes >> 15 == 0 and _order_codes([], []) == 0


def test_partitioned_rows_of_no_partition_go_last():
    """Rows of slot P (no partition) rank among themselves after every
    partition's rows at each position, as a slot of their own."""
    valid = torch.tensor([True, False, True, True, False])
    part = torch.tensor([2, 2, 0, 1, 0])
    key = torch.tensor([5, 1, 3, 3, 9], dtype=torch.int32)
    perm, kept = order_limit_partitioned_ref(valid, [key], [True], part, 2, 0, _BIG)
    # partition 0: rows 2 (valid), 4; partition 1: row 3; slot 2: rows 0, 1
    assert perm.tolist() == [2, 3, 0, 4, 1]
    assert kept.tolist() == [True, True, True, False, False]


# ---------------------------------------------------------------------------
# K47: mix_keys
# ---------------------------------------------------------------------------

KEY_TYPES = {"int32": JaxAttrType.INT, "int64": JaxAttrType.LONG, "bool": JaxAttrType.BOOL,
             "float32": JaxAttrType.FLOAT, "string": JaxAttrType.STRING}


def _edges(c: np.ndarray, edges: list) -> np.ndarray:
    k = min(len(c), len(edges))
    c[:k] = np.asarray(edges, c.dtype)[:k]
    return c


def _mix_col(rng, dtype: str, n: int) -> np.ndarray:
    if dtype == "int32":
        c = rng.integers(I32.min, I32.max, n, endpoint=True).astype(np.int32)
        return _edges(c, [I32.min, -1, I32.max])
    if dtype == "string":  # interned ids
        return rng.integers(0, 50, n).astype(np.int32)
    if dtype == "int64":
        c = rng.integers(I64.min, I64.max, n, endpoint=True).astype(np.int64)
        return _edges(c, [I64.min, -1, I64.max])
    if dtype == "float32":
        c = rng.normal(0, 1e3, n).astype(np.float32)
        return _edges(c, [0.0, -0.0, np.nan, -np.inf, NEG_NAN, 1e-38])
    return rng.random(n) < 0.5


@pytest.mark.parametrize("ncols", range(1, 9))
def test_mix_keys_matches_jax(ncols):
    rng = np.random.default_rng(40 + ncols)
    order = ["int32", "float32", "int64", "bool", "string"]
    dtypes = [order[(ncols + i) % len(order)] for i in range(ncols)]
    for n in (1, 33, 513):
        cols = [_mix_col(rng, d, n) for d in dtypes]
        want = np.asarray(jgroup.mix_keys(
            [jax_as_key_col(jnp.asarray(c), KEY_TYPES[d]) for c, d in zip(cols, dtypes)]))
        got = group.mix_keys_ref([torch.from_numpy(c) for c in cols])
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(group.mix_keys([torch.from_numpy(c) for c in cols]).numpy(),
                                      want)
