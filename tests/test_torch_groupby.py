"""The group-by slice's kernel-bearing functions against the JAX package, on
the CPU, with inputs made from a seed with numpy: the lengthBatch step (K6),
slot assignment (K7), the keyed running sum (K8), both keep-last forms (K9),
and the plain routines behind them (composite key mix, scatter-set with dead
lanes, segmented scans).

Tolerances: ints, bools, slots, tables, masks and every window lane match
exactly. Float32 running sums match to a relative 2e-4 (the rule of
bench.py:_rows_match) of the largest magnitude seen so far in the lane,
floor 1.0: the port and the JAX blocked scan add in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.event import StreamSchema as JaxSchema  # noqa: E402
from siddhi_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.core.windows import BatchWindow as JaxBatchWindow  # noqa: E402
from siddhi_tpu.ops import group as jgroup  # noqa: E402
from siddhi_tpu.ops import prefix as jprefix  # noqa: E402
from siddhi_tpu.ops import scatter as jscatter  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.core.windows import (  # noqa: E402
    BatchWindow,
    batch_window_rows,
    batch_window_step,
)
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from siddhi_tpu_torch.ops import group, prefix, scatter  # noqa: E402

RTOL = 2e-4
ATTRS = [("symbol", "STRING"), ("price", "FLOAT"), ("volume", "LONG"), ("hot", "BOOL")]


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return a.shape == b.shape
    scale = np.maximum.accumulate(np.maximum(np.abs(a), np.abs(b)).reshape(-1))
    return a.shape == b.shape and np.all(np.abs(a - b).reshape(-1) <= RTOL * np.maximum(1.0, scale))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# K6: the lengthBatch step
# ---------------------------------------------------------------------------


def _feed(rng, b, start_ts):
    """One partial batch: holes in `valid`, a few TIMER rows."""
    valid = rng.random(b) < 0.8
    kind = np.where(rng.random(b) < 0.05, 2, 0).astype(np.int8)
    return {
        "ts": start_ts + np.arange(b, dtype=np.int64) * 3,
        "kind": kind,
        "valid": valid,
        "cols": {
            "symbol": rng.integers(1, 6, b).astype(np.int32),
            "price": rng.uniform(0, 100, b).astype(np.float32),
            "volume": rng.integers(-(2**40), 2**40, b).astype(np.int64),
            "hot": rng.random(b) < 0.5,
        },
    }


def _run_batch_window(b, n, emit_expired, steps, seed):
    rng = np.random.default_rng(seed)
    jwin = JaxBatchWindow(JaxSchema("S", [(a, JaxAttrType[t]) for a, t in ATTRS]), "S",
                          capacity=n, length=n)
    jwin.emit_expired = emit_expired
    jstate = jwin.init_state()

    @jax.jit
    def jax_step(st, jb):
        st, flow = jwin.apply(st, JaxFlow(batch=jb, ref="S", now=jnp.int64(0)))
        return st, flow.batch, flow.member

    win = BatchWindow(StreamSchema("S", [(a, AttrType[t]) for a, t in ATTRS]), "S", n, "cpu")
    state = win.init_state()
    np.testing.assert_equal(state_to_numpy(state), _np_tree(jstate))
    flushes = 0
    for step in range(steps):
        f = _feed(rng, b, 1_700_000_000_000 + 100_000 * step)
        jb = JaxBatch(ts=jnp.asarray(f["ts"]), kind=jnp.asarray(f["kind"]),
                      valid=jnp.asarray(f["valid"]),
                      cols={k: jnp.asarray(v) for k, v in f["cols"].items()})
        jstate, jout, jmember = jax_step(jstate, jb)
        batch = EventBatch(ts=torch.from_numpy(f["ts"]), kind=torch.from_numpy(f["kind"]),
                           valid=torch.from_numpy(f["valid"]),
                           cols={k: torch.from_numpy(v) for k, v in f["cols"].items()})
        out, birth, death, state = batch_window_step(state, batch, n, emit_expired)
        rows = batch_window_rows(b, n, emit_expired)
        v = np.asarray(jout.valid)
        assert out.valid.shape == (rows,) and v.shape == (rows,)
        np.testing.assert_array_equal(out.valid.numpy(), v)
        assert not v[v.sum():].any()  # valid rows first, padding after
        for got, want in [(out.ts, jout.ts), (out.kind, jout.kind)] + [
            (out.cols[a], jout.cols[a]) for a, _ in ATTRS
        ]:
            np.testing.assert_array_equal(got.numpy()[v], np.asarray(want)[v])
            assert not got.numpy()[~v].any()  # padding is zero
        np.testing.assert_equal(state_to_numpy(state), _np_tree(jstate))
        if emit_expired:
            p = torch.arange(rows)[:, None]
            member = (birth[None, :] <= p) & (p < death[None, :])
            np.testing.assert_array_equal(member.numpy(), np.asarray(jmember))
        else:
            assert birth is None and jmember is None
        flushes += int((out.kind.numpy()[v] == 3).sum())
    return flushes


@pytest.mark.parametrize("b,n", [(1, 1), (33, 1), (33, 4), (513, 4), (4097, 1024), (4097, 4)])
@pytest.mark.parametrize("emit_expired", [True, False])
def test_batch_window_step(b, n, emit_expired):
    """Carried buckets over 4 batches, several flushes in a batch, the
    EXPIRED lanes on and off: every valid lane, the padding, the new
    buffers and the expanded membership equal the JAX step's."""
    flushes = _run_batch_window(b, n, emit_expired, 4, seed=b * 7 + n)
    assert flushes >= (1 if b * 4 * 0.7 >= n else 0)


def test_batch_window_step_main_shape():
    """The tumbling_groupby shape: B=32768, lengthBatch(1024), no EXPIRED
    lanes, 33,826 flow rows."""
    assert batch_window_rows(32768, 1024, False) == 33826
    assert _run_batch_window(32768, 1024, False, 2, seed=5) > 40


# ---------------------------------------------------------------------------
# mix_keys, scatter, segmented scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_mix_keys(ncols):
    rng = np.random.default_rng(ncols)
    cols = [rng.integers(-(2**31), 2**31 - 1, 4097).astype(np.int32)]
    cols.append(rng.integers(-(2**62), 2**62, 4097).astype(np.int64))
    cols.append(np.array([0, -1, 1, 2**31 - 1] * 1024 + [7], np.int32))
    cols = cols[:ncols]
    want = np.asarray(jgroup.mix_keys([jnp.asarray(c) for c in cols]))
    got = group.mix_keys([torch.from_numpy(c) for c in cols])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["set_at", "compact_set_at"])
@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
def test_scatter_dead_lanes(fn, dtype):
    """Any index >= G is a dead lane; live writers are unique per slot. The
    port's one `set_at` carries both JAX functions' semantics."""
    rng = np.random.default_rng(3)
    g, b = 16, 100
    dst = rng.integers(-50, 50, g).astype(dtype)
    src = rng.integers(-50, 50, b).astype(dtype)
    idx = np.full(b, g + 5, np.int32)
    live = rng.choice(b, 10, replace=False)
    idx[rng.choice(b, 10, replace=False)[:3]] = g  # the == G sentinel too
    idx[live] = rng.choice(g, 10, replace=False)
    want = np.asarray(getattr(jscatter, fn)(jnp.asarray(dst), jnp.asarray(idx), jnp.asarray(src)))
    got = scatter.set_at(torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 33, 513, 4097])
def test_segmented_scans(n):
    rng = np.random.default_rng(n)
    seg = rng.random(n) < 0.1
    seg[0] = True
    fv = rng.uniform(-100, 100, n).astype(np.float32)
    iv = rng.integers(-1000, 1000, n).astype(np.int64)
    js, ts_ = jnp.asarray(seg), torch.from_numpy(seg)
    jit = jax.jit
    assert _close(prefix.segmented_cumsum(torch.from_numpy(fv), ts_).numpy(),
                  jit(jprefix.segmented_cumsum)(jnp.asarray(fv), js))
    np.testing.assert_array_equal(prefix.segmented_cumsum(torch.from_numpy(iv), ts_).numpy(),
                                  np.asarray(jit(jprefix.segmented_cumsum)(jnp.asarray(iv), js)))
    for is_min in (True, False):
        want = jit(jprefix.segmented_cum_extreme, static_argnums=2)(jnp.asarray(iv), js, is_min)
        np.testing.assert_array_equal(
            prefix.segmented_cum_extreme(torch.from_numpy(iv), ts_, is_min).numpy(),
            np.asarray(want))
    np.testing.assert_array_equal(prefix.segmented_carry(torch.from_numpy(iv), ts_).numpy(),
                                  np.asarray(jit(jprefix.segmented_carry)(jnp.asarray(iv), js)))
    mask = rng.random(n) < 0.3
    for size in (1, n // 2 + 1, n + 3):
        want = jit(jprefix.first_indices, static_argnums=1)(jnp.asarray(mask), size)
        np.testing.assert_array_equal(
            prefix.first_indices(torch.from_numpy(mask), size).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K7-K9 over one scenario: assign_slots, keyed_running_sum, keep-last
# ---------------------------------------------------------------------------

# SortedGroups is not a pytree: the jitted wrappers pass its three lanes


def _grp(lanes):
    return jgroup.SortedGroups(*lanes)


@jax.jit
def _jax_assign_lanes(keys, used, n, bk, active, reset):
    nk, nu, nn, slot, grp, over = jgroup.assign_slots(keys, used, n, bk, active, reset)
    return nk, nu, nn, slot, (grp.perm, grp.inv, grp.seg_start), over


def _jax_assign(*args):
    out = _jax_assign_lanes(*args)
    return (*out[:4], _grp(out[4]), out[5])


_jax_keyed_sum_lanes = jax.jit(
    lambda c, lanes, r, carry, slot: jgroup.keyed_running_sum(c, _grp(lanes), r, carry, slot))
_jax_keep_sorted_lanes = jax.jit(
    lambda lanes, kind, valid: jgroup.keep_last_in_sorted(_grp(lanes), kind, valid))
_jax_keep_group = jax.jit(lambda seg, valid: jgroup.keep_last_per_group([seg], valid))


def _lanes(grp):
    return (grp.perm, grp.inv, grp.seg_start)

# case -> (G, distinct keys, reset probability, active probability)
SCENARIOS = {
    "resets": (1024, 8, 0.01, 0.85),  # several eras, inactive rows
    "no_reset": (1024, 8, 0.0, 0.9),
    "full": (16, 16, 0.0, 1.0),  # the table fills exactly
    "overflow": (16, 40, 0.0, 1.0),  # keys past G: dead lane + flag
    "overflow_resets": (16, 40, 0.002, 0.95),
    "keys1000": (1024, 1000, 0.0, 0.95),
    "keys2000": (1024, 2000, 0.0, 0.95),
}


def _scenario(rows, case, seed):
    g, nkeys, p_reset, p_active = SCENARIOS[case]
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, nkeys, rows).astype(np.int64) * 104729 - 7)
    active = rng.random(rows) < p_active
    reset = (rng.random(rows) < p_reset) & ~active
    if p_reset and rows > 8:
        reset[rows // 3] = reset[2 * rows // 3] = True  # several eras
        active[rows // 3] = active[2 * rows // 3] = False
    return g, keys, active, reset


def _jax_first(grp):
    perm = np.asarray(grp.perm)
    first_s = np.asarray(jprefix.segmented_carry(grp.perm, grp.seg_start))
    first = np.empty_like(first_s)
    first[perm] = first_s
    return first


def _assign_both(table, keys, active, reset):
    jt = _jax_assign(*(jnp.asarray(x) for x in table), jnp.asarray(keys), jnp.asarray(active),
                     jnp.asarray(reset))
    pt = group.assign_slots(*(torch.from_numpy(np.array(x)) for x in table),
                            torch.from_numpy(keys), torch.from_numpy(active),
                            torch.from_numpy(reset))
    return jt, pt


@pytest.mark.parametrize("rows,case", [
    (1, "resets"), (33, "resets"), (513, "resets"), (4097, "resets"), (33826, "resets"),
    (513, "no_reset"), (513, "full"), (513, "overflow"), (4097, "overflow_resets"),
    (4097, "keys1000"), (4097, "keys2000"),
])
def test_assign_slots(rows, case):
    """Two carried calls: slot, the new table, the count and the overflow
    flag bit for bit; the segment ids equal the JAX sorted view's heads on
    active rows; the reset bounds are the first and last RESET rows."""
    g = SCENARIOS[case][0]
    table = (np.zeros(g, np.int64), np.zeros(g, bool), np.int32(0))
    overflows = []
    for call in range(2):
        _g, keys, active, reset = _scenario(rows, case, seed=rows + 31 * call)
        jt, pt = _assign_both(table, keys, active, reset)
        for got, want in zip(pt[:4], jt[:4]):
            np.testing.assert_array_equal(np.asarray(got.numpy()), np.asarray(want))
        assert bool(pt[5]) == bool(jt[5])
        overflows.append(bool(pt[5]))
        first = pt[4].first.numpy()
        np.testing.assert_array_equal(first[active], _jax_first(jt[4])[active])
        assert (first[~active] == np.arange(rows)[~active]).all()
        idx = np.nonzero(reset)[0]
        bounds = [idx.min() if idx.size else rows, idx.max() if idx.size else -1]
        np.testing.assert_array_equal(pt[4].bounds.numpy(), bounds)
        table = tuple(np.array(x) for x in jt[:3])
    if case.startswith("overflow") or case == "keys2000":
        assert any(overflows)
    elif case in ("full", "keys1000", "no_reset"):
        assert not any(overflows)
    if case == "full":
        assert int(table[2]) == g and table[1].all()


@pytest.mark.parametrize("rows", [1, 33, 513, 4097, 33826])
@pytest.mark.parametrize("dtype", ["float32", "int64"])
@pytest.mark.parametrize("case", ["resets", "no_reset", "overflow"])
def test_keyed_running_sum(rows, dtype, case):
    """Per-row keyed running sums and the new [G] carry: ints exact, float32
    within the stated tolerance, with and without resets and past G."""
    g, keys, active, reset = _scenario(rows, case, seed=rows * 3 + len(case))
    rng = np.random.default_rng(rows)
    table = (np.zeros(g, np.int64), np.zeros(g, bool), np.int32(0))
    jt, pt = _assign_both(table, keys, active, reset)
    sign = np.where(active, np.where(rng.random(rows) < 0.8, 1, -1), 0)
    if dtype == "float32":
        contrib = np.where(active, rng.uniform(0, 100, rows) * sign, 0).astype(np.float32)
        carry = rng.uniform(-500, 500, g).astype(np.float32)
    else:
        contrib = np.where(active, rng.integers(1, 1000, rows) * sign, 0).astype(np.int64)
        carry = rng.integers(-5000, 5000, g).astype(np.int64)
    jrun, jcarry = _jax_keyed_sum_lanes(jnp.asarray(contrib), _lanes(jt[4]), jnp.asarray(reset),
                                        jnp.asarray(carry), jt[3])
    run, new_carry = group.keyed_running_sum(torch.from_numpy(contrib), pt[4],
                                             torch.from_numpy(reset), torch.from_numpy(carry),
                                             pt[3])
    assert run.dtype == torch.from_numpy(contrib).dtype and new_carry.shape == (g,)
    if dtype == "float32":
        # the order of each group's rows, so the tolerance scale is per group
        order = np.lexsort((np.arange(rows), pt[4].first.numpy()))
        assert _close(run.numpy()[order], np.asarray(jrun)[order])
        assert _close(new_carry.numpy(), np.asarray(jcarry))
    else:
        np.testing.assert_array_equal(run.numpy(), np.asarray(jrun))
        np.testing.assert_array_equal(new_carry.numpy(), np.asarray(jcarry))


@pytest.mark.parametrize("rows", [1, 33, 513, 4097, 33826])
@pytest.mark.parametrize("case", ["resets", "no_reset"])
def test_keep_last(rows, case):
    """The grouped collapse (last valid row per (group, kind)) and the
    ungrouped one (last valid row per flush-chunk id), exact."""
    g, keys, active, reset = _scenario(rows, case, seed=rows + 99)
    rng = np.random.default_rng(rows + 1)
    table = (np.zeros(g, np.int64), np.zeros(g, bool), np.int32(0))
    jt, pt = _assign_both(table, keys, active, reset)
    kind = np.where(reset, 3, np.where(rng.random(rows) < 0.3, 1, 0)).astype(np.int8)
    valid = active & (rng.random(rows) < 0.8)
    want = _jax_keep_sorted_lanes(_lanes(jt[4]), jnp.asarray(kind), jnp.asarray(valid))
    got = group.keep_last_in_sorted(pt[4], torch.from_numpy(kind), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seg = (np.cumsum(reset) + (kind == 1)).astype(np.int32)
    want = _jax_keep_group(jnp.asarray(seg), jnp.asarray(valid))
    got = group.keep_last_per_group(torch.from_numpy(seg), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() <= max(1, int(seg.max()) + 1)


def test_batch_window_state_round_trip():
    """The lengthBatch state layout (buffers, counts, the time branches'
    scalars) carries leaf for leaf between the packages."""
    schema = [(a, JaxAttrType[t]) for a, t in ATTRS]
    jstate = JaxBatchWindow(JaxSchema("S", schema), "S", capacity=7, length=7).init_state()
    tree = _np_tree(jstate)
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    np.testing.assert_equal(back, tree)
    port = BatchWindow(StreamSchema("S", [(a, AttrType[t]) for a, t in ATTRS]), "S", 7, "cpu")
    np.testing.assert_equal(state_to_numpy(port.init_state()), tree)
