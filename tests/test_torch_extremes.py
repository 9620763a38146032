"""The running and keyed extremes (K18, K19), the windowed extreme's key lane
(K3) and the distinct count (K20) against the JAX package, on the CPU, with
inputs made from a seed with numpy. All exact: min/max pick one of their
inputs whatever the order, and counts are integers. NaN (the null float)
propagates through min/max and equals nothing in a distinct count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.core.aggregators import DistinctCountAggregator as JaxDistinct  # noqa: E402
from siddhi_tpu.core.aggregators import ExtremeAggregator as JaxExtreme  # noqa: E402
from siddhi_tpu.core.aggregators import FlowInfo as JaxFlowInfo  # noqa: E402
from siddhi_tpu.core.executor import CompiledExpr as JaxExpr  # noqa: E402
from siddhi_tpu.core.executor import Env as JaxEnv  # noqa: E402
from siddhi_tpu.core.groupby import GroupCtx as JaxGroupCtx  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.ops import group as jgroup  # noqa: E402
from siddhi_tpu.ops import prefix as jprefix  # noqa: E402
from siddhi_tpu_torch.core.aggregators import distinct_count, window_extreme  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.core.windows import (  # noqa: E402
    BatchWindow,
    SlidingWindow,
    batch_window_step,
    length_window_step,
    time_batch_step,
)
from siddhi_tpu_torch.ops import group, prefix  # noqa: E402

DTYPES = {"float32": np.float32, "int32": np.int32, "int64": np.int64}


def _values(rng, n, dtype, nan_share=0.05):
    if dtype == "float32":
        v = rng.uniform(-100, 100, n).astype(np.float32)
        v[rng.random(n) < nan_share] = np.nan
        return v
    info = np.iinfo(DTYPES[dtype])
    v = rng.integers(-(10**6), 10**6, n).astype(DTYPES[dtype])
    v[rng.random(n) < nan_share] = info.min  # the null sentinel
    return v


# ---------------------------------------------------------------------------
# K18: running_extreme
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 33, 513, 4097])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("is_min", [True, False])
def test_running_extreme(b, dtype, is_min):
    rng = np.random.default_rng(b + len(dtype) + is_min)
    vals = _values(rng, b, dtype)
    if dtype == "float32" and b > 8:
        vals[b // 2] = np.nan  # a null inside a segment
    active = rng.random(b) < 0.8
    reset = (rng.random(b) < 0.03) & ~active
    if b > 8:
        reset[b // 3] = True
        active[b // 3] = False
    base = _values(rng, 1, dtype, nan_share=0.0)[0]
    want_run, want_carry = jax.jit(jprefix.running_extreme, static_argnums=4)(
        jnp.asarray(vals), jnp.asarray(active), jnp.asarray(reset), jnp.asarray(base), is_min)
    run, carry = prefix.running_extreme(torch.from_numpy(vals), torch.from_numpy(active),
                                        torch.from_numpy(reset), torch.tensor(base), is_min)
    assert run.dtype == torch.from_numpy(vals).dtype and carry.shape == ()
    np.testing.assert_array_equal(run.numpy(), np.asarray(want_run))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(want_carry))


# ---------------------------------------------------------------------------
# K19: keyed_running_extreme
# ---------------------------------------------------------------------------


@jax.jit
def _jax_assign_lanes(keys, used, n, bk, active, reset):
    nk, nu, nn, slot, grp, over = jgroup.assign_slots(keys, used, n, bk, active, reset)
    return nk, nu, nn, slot, (grp.perm, grp.inv, grp.seg_start), over


_jax_keyed_extreme = jax.jit(
    lambda v, a, lanes, r, carry, slot, is_min: jgroup.keyed_running_extreme(
        v, a, jgroup.SortedGroups(*lanes), r, carry, slot, is_min),
    static_argnums=6)


@pytest.mark.parametrize("rows", [1, 33, 513, 4097])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["resets", "no_reset", "overflow", "forever"])
def test_keyed_running_extreme(rows, dtype, case):
    """Per-row keyed running min and max and the new [G] carry, with and
    without resets and past G (keys over capacity get the dead lane); and
    the forever form: segments split at resets, the reset lane zeroed, so
    one slot ends several segments."""
    rng = np.random.default_rng(rows * 7 + len(dtype) + len(case))
    g = 64
    nkeys = 100 if case == "overflow" else 20
    keys = rng.integers(0, nkeys, rows).astype(np.int64) * 104729 - 7
    active = rng.random(rows) < 0.85
    reset = (rng.random(rows) < (0.01 if case == "resets" else 0.0)) & ~active
    if case in ("resets", "forever") and rows > 8:
        reset[rows // 3] = True
        active[rows // 3] = False
    table = (np.zeros(g, np.int64), np.zeros(g, bool), np.int32(0))
    jt = _jax_assign_lanes(*(jnp.asarray(x) for x in table), jnp.asarray(keys),
                           jnp.asarray(active), jnp.asarray(reset))
    pt = group.assign_slots(*(torch.from_numpy(np.array(x)) for x in table),
                            torch.from_numpy(keys), torch.from_numpy(active),
                            torch.from_numpy(reset))
    vals = _values(rng, rows, dtype)
    carry = _values(rng, g, dtype, nan_share=0.02)
    ext_reset = np.zeros_like(reset) if case == "forever" else reset
    for is_min in (True, False):
        jrun, jcarry = _jax_keyed_extreme(jnp.asarray(vals), jnp.asarray(active), jt[4],
                                          jnp.asarray(ext_reset), jnp.asarray(carry), jt[3],
                                          is_min)
        run, new_carry = group.keyed_running_extreme(
            torch.from_numpy(vals), torch.from_numpy(active), pt[4],
            torch.from_numpy(ext_reset), torch.from_numpy(carry), pt[3], is_min)
        np.testing.assert_array_equal(run.numpy(), np.asarray(jrun))
        jc, pc = np.asarray(jcarry), new_carry.numpy()
        if case == "forever":
            # one reset, two eras: a slot that ends a segment in both gets
            # two carry writers; JAX keeps either (its compact scatter
            # sorts unstably when rows > G), the port the later era's,
            # whose key the renumbered slot table holds (ROADMAP.md
            # section 3)
            writers = _writers_per_slot(pt[4], pt[3].numpy(), g)
            multi = writers > 1
            assert multi.any() or rows < 200
            np.testing.assert_array_equal(pc[~multi], jc[~multi])
        else:
            np.testing.assert_array_equal(pc, jc)


def _writers_per_slot(grp, slot, g):
    """How many segments of the batch end at each slot."""
    first = grp.first.numpy()
    heads = np.unique(first[slot < g])
    return np.bincount(slot[heads][slot[heads] < g], minlength=g)


# ---------------------------------------------------------------------------
# membership from real window steps: length, lengthBatch, timeBatch
# ---------------------------------------------------------------------------

SCHEMA = [("symbol", AttrType.STRING), ("price", AttrType.FLOAT), ("volume", AttrType.LONG),
          ("hot", AttrType.BOOL)]


def _membership(window: str, seed: int, b: int = 33):
    """(birth, death, element columns, rows) after three carried steps of a
    port window (each held to the JAX step by its own tests): values with
    repeats, NaN and null sentinels."""
    rng = np.random.default_rng(seed)
    schema = StreamSchema("S", SCHEMA)
    if window == "length":
        win = SlidingWindow(schema, "S", 8, "cpu")
    elif window == "lengthBatch":
        win = BatchWindow(schema, "S", 8, "cpu")
    else:
        win = BatchWindow(schema, "S", None, "cpu", capacity=16, duration_ms=10)
    state = win.init_state()
    t0 = 1_700_000_000_000
    for _ in range(3):
        price = rng.choice([1.5, -0.0, 0.0, 7.25, np.nan, 3.0], b).astype(np.float32)
        cols = {
            "symbol": rng.integers(0, 4, b).astype(np.int32),  # 0: the null string
            "price": price,
            "volume": rng.choice([5, 9, np.iinfo(np.int64).min, 11], b).astype(np.int64),
            "hot": rng.random(b) < 0.5,
        }
        ts = t0 + np.cumsum(rng.integers(0, 4, b)).astype(np.int64)
        t0 = int(ts[-1]) + 1
        batch = EventBatch(ts=torch.from_numpy(ts), kind=torch.zeros(b, dtype=torch.int8),
                           valid=torch.from_numpy(rng.random(b) < 0.9),
                           cols={k: torch.from_numpy(v) for k, v in cols.items()})
        if window == "length":
            out, birth, death, new_state = length_window_step(state, batch, 8)
            elems = {k: torch.cat([state["cols"][k], batch.cols[k]]) for k in cols}
        elif window == "lengthBatch":
            out, birth, death, new_state = batch_window_step(state, batch, 8, True)
            elems = {k: torch.cat([state["cur_cols"][k], state["prev_cols"][k], batch.cols[k]])
                     for k in cols}
        else:
            out, birth, death, new_state, _ = time_batch_step(
                state, batch, batch.ts, torch.tensor(t0), 16, 10, None, None, 1, True)
            elems = {k: torch.cat([state["cur_cols"][k], state["prev_cols"][k], batch.cols[k]])
                     for k in cols}
        state = new_state
    return birth, death, elems, out.valid.shape[0]


def _member(birth, death, rows):
    p = np.arange(rows)[:, None]
    return (birth.numpy()[None, :] <= p) & (p < death.numpy()[None, :])


def _group(rng, elems, rows, elem_key):
    """A JAX GroupCtx whose element keys are one of the element columns and
    whose row keys are drawn from the same values."""
    ek = elems[elem_key].to(torch.int64)
    rk = torch.from_numpy(rng.choice(np.unique(ek.numpy()), rows).astype(np.int64))
    kk = ("S", None, "__key")
    ctx = JaxGroupCtx(slot=jnp.zeros(rows, jnp.int32), key=jnp.asarray(rk.numpy()),
                      sorted=None, capacity=4, key_of=lambda env: env.read(kk))
    return ek, rk, ctx, kk


@pytest.mark.parametrize("window", ["length", "lengthBatch", "timeBatch"])
@pytest.mark.parametrize("col,t", [("price", "FLOAT"), ("symbol", "STRING"),
                                   ("volume", "LONG"), ("hot", "BOOL")])
@pytest.mark.parametrize("grouped", [False, True])
def test_distinct_count(window, col, t, grouped):
    birth, death, elems, rows = _membership(window, seed=len(window) + len(col))
    member = _member(birth, death, rows)
    key = ("S", None, col)
    env = {key: jnp.asarray(elems[col].numpy())}
    group_ctx, ek, rk = None, None, None
    if grouped:
        ek, rk, group_ctx, kk = _group(np.random.default_rng(3), elems, rows,
                                       "hot" if col == "symbol" else "symbol")
        env[kk] = jnp.asarray(ek.numpy())
    jagg = JaxDistinct(JaxExpr(JaxAttrType[t], lambda e: e.read(key)))
    info = JaxFlowInfo(sign=jnp.zeros(rows, jnp.int8), active=jnp.zeros(rows, bool),
                       reset=jnp.zeros(rows, bool), member=jnp.asarray(member),
                       member_env=JaxEnv(env), group=group_ctx)
    _, want = jagg.apply(jagg.init(), info, JaxEnv({}))
    got = distinct_count(elems[col].contiguous(), birth, death, rows, ek, rk)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want).max() >= (1 if col == "hot" and grouped else 2)


@pytest.mark.parametrize("window", ["length", "lengthBatch", "timeBatch"])
@pytest.mark.parametrize("t", ["FLOAT", "INT", "LONG"])
@pytest.mark.parametrize("is_min", [True, False])
def test_window_extreme_keyed(window, t, is_min):
    """K3's key lane against the JAX grouped windowed branch: an element
    counts toward a row only inside the row's group."""
    birth, death, elems, rows = _membership(window, seed=11 + len(window))
    member = _member(birth, death, rows)
    rng = np.random.default_rng(len(t) + is_min)
    vals = torch.from_numpy(_values(rng, birth.shape[0], {"FLOAT": "float32", "INT": "int32",
                                                          "LONG": "int64"}[t]))
    key = ("S", None, "x")
    ek, rk, ctx, kk = _group(rng, elems, rows, "symbol")
    jagg = JaxExtreme(JaxExpr(JaxAttrType[t], lambda e: e.read(key)), is_min, forever=False)
    info = JaxFlowInfo(sign=jnp.zeros(rows, jnp.int8), active=jnp.zeros(rows, bool),
                       reset=jnp.zeros(rows, bool), member=jnp.asarray(member),
                       member_env=JaxEnv({key: jnp.asarray(vals.numpy()),
                                          kk: jnp.asarray(ek.numpy())}),
                       group=ctx)
    _, want = jagg.apply(jagg.init(), info, JaxEnv({}))
    got = window_extreme(vals, birth, death, rows, is_min, AttrType[t], ek, rk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
