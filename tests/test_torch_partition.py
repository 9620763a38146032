"""The partition slice's plain kernels against the JAX package on the CPU,
with inputs made from a seed with numpy: the partitioned length-window step
(K29, `partition_length_window_step_ref`) and the windowed min/max of a
partition (K30, `partition_window_extreme_ref`) against `jax.vmap` of
`SlidingWindow.apply` (length) and of the windowed `ExtremeAggregator.apply`
over [P]-tiled states with siddhi_tpu/core/partition.py's masks (`active &
slot == p | TIMER`), then `_flatten` and compaction: every output lane, the
rings and totals, the expanded membership and the extremes, exactly, over
four carried batches with holes, TIMER rows, NaN, -0.0, int32/int64 nulls
and rows of no partition (keys past capacity). Also the keyed K8/K19 use
(slot = partition slot, no resets) against vmapped `running_sum` /
`running_extreme` (float32 within a relative 2e-4, the rest exact). And the
partitioned sliding time window (K31, time / timeLength / disordered
externalTime, rings evicting at capacity), the partitioned batch window
(K32, lengthBatch / timeBatch with and without a start time /
externalTimeBatch with an idle timeout, with and without the EXPIRED lanes)
and the per-partition group-slot assignment (K33, RESET eras and overflow
per partition) against `jax.vmap` of `SlidingWindow.apply`,
`BatchWindow.apply` and `assign_slots` with the same masks: every lane, the
state, next_timer, the expanded membership and the flags, exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.core.aggregators import ExtremeAggregator as JaxExtreme  # noqa: E402
from siddhi_tpu.core.aggregators import FlowInfo as JaxFlowInfo  # noqa: E402
from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.event import StreamSchema as JaxSchema  # noqa: E402
from siddhi_tpu.core.executor import CompiledExpr as JaxExpr  # noqa: E402
from siddhi_tpu.core.executor import Env as JaxEnv  # noqa: E402
from siddhi_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from siddhi_tpu.core.partition import _flatten, _tile  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.core.windows import SlidingWindow as JaxSlidingWindow  # noqa: E402
from siddhi_tpu.ops import prefix as jprefix  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch  # noqa: E402
from siddhi_tpu_torch.core.groupby import partition_ctx  # noqa: E402
from siddhi_tpu_torch.core.partition import _tile as port_tile  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.ops import group  # noqa: E402
from siddhi_tpu_torch.ops.partition import (  # noqa: E402
    partition_length_window_step,
    partition_window_extreme,
)

ATTRS = [("symbol", "STRING"), ("price", "FLOAT"), ("qty", "INT"), ("volume", "LONG")]
VALUE_COLS = [("price", "FLOAT"), ("qty", "INT"), ("volume", "LONG")]
JSCHEMA = JaxSchema("S", [(n, JaxAttrType[t]) for n, t in ATTRS])
PRICES = np.array([np.nan, -0.0, 0.0, 1.5, 2.5, 7.0, -3.0, 40.0], np.float32)


def _jtile(tree, p):
    """The JAX package's [P]-tiled state tree (`init_state` of its
    PartitionedQueryRuntime)."""
    return jax.tree_util.tree_map(lambda x: _tile(x, p), tree)


def _jax_step(p: int, w: int):
    """jit of one partitioned length-window step with the six windowed
    extremes, vmapped over the [P]-tiled rings as siddhi_tpu/core/
    partition.py `_vmapped` runs it."""
    win = JaxSlidingWindow(JSCHEMA, "S", capacity=w)
    aggs = {(c, m): JaxExtreme(JaxExpr(JaxAttrType[t], lambda e, _k=("S", None, c): e.read(_k)),
                               is_min=m, forever=False)
            for c, t in VALUE_COLS for m in (True, False)}

    @jax.jit
    def step(states, ts, kind, valid, cols, slot):
        active = valid & (kind == 0) & (slot < p)
        is_timer = valid & (kind == 2)

        def one(state, q):
            b2 = JaxBatch(ts, kind, (active & (slot == q)) | is_timer, cols)
            st, fl = win.apply(state, JaxFlow(batch=b2, ref="S", now=jnp.int64(0)))
            out = fl.batch
            info = JaxFlowInfo(sign=jnp.zeros(out.valid.shape, jnp.int8),
                               active=jnp.zeros(out.valid.shape, bool),
                               reset=jnp.zeros(out.valid.shape, bool),
                               member=fl.member, member_env=fl.member_env)
            ext = {f"{c}_{int(m)}": a.apply(a.init(), info, JaxEnv({}))[1]
                   for (c, m), a in aggs.items()}
            return st, out, fl.member, ext

        return jax.vmap(one)(states, jnp.arange(p))

    return step, win


def _batch(rng, b, p, t0):
    """numpy lanes: slots in [0, P] (P: a key past capacity), holes, a few
    TIMER and EXPIRED rows, NaN/-0.0 prices, int nulls."""
    kind = np.where(rng.random(b) < 0.08, 2, np.where(rng.random(b) < 0.03, 1, 0)).astype(
        np.int8)
    qty = rng.integers(-50, 50, b).astype(np.int32)
    qty[rng.random(b) < 0.05] = np.iinfo(np.int32).min
    vol = rng.integers(-(10**9), 10**9, b).astype(np.int64)
    vol[rng.random(b) < 0.05] = np.iinfo(np.int64).min
    return {"ts": t0 + np.arange(b, dtype=np.int64), "kind": kind,
            "valid": rng.random(b) < 0.85,
            "slot": np.where(rng.random(b) < 0.1, p, rng.integers(0, p, b)).astype(np.int32),
            "cols": {"symbol": rng.integers(1, 6, b).astype(np.int32),
                     "price": PRICES[rng.integers(0, len(PRICES), b)], "qty": qty,
                     "volume": vol}}


def _port_batch(d):
    return EventBatch(ts=torch.from_numpy(d["ts"]), kind=torch.from_numpy(d["kind"]),
                      valid=torch.from_numpy(d["valid"]),
                      cols={n: torch.from_numpy(c) for n, c in d["cols"].items()})


CASES = [(1, 1, 1), (1, 33, 4), (8, 33, 2), (8, 513, 50), (33, 33, 1), (33, 513, 4),
         (8, 1, 50), (33, 1, 2)]


@pytest.mark.parametrize("p,b,w", CASES)
def test_partition_length_window_step(p, b, w):
    """Four carried batches; each step's rows, rings, membership and
    extremes against the vmapped JAX step, flattened and compacted."""
    rng = np.random.default_rng(100 * p + 10 * w + b)
    step, win = _jax_step(p, w)
    jstates = _jtile(win.init_state(), p)
    state = {"cols": {n: torch.from_numpy(np.array(c)) for n, c in jstates["cols"].items()},
             **{k: torch.from_numpy(np.array(jstates[k])) for k in ("ts", "wts", "seq", "total")}}
    for i in range(4):
        d = _batch(rng, b, p, 1000 * i)
        jstates2, jout, jmember, jext = step(
            jstates, jnp.asarray(d["ts"]), jnp.asarray(d["kind"]), jnp.asarray(d["valid"]),
            {n: jnp.asarray(c) for n, c in d["cols"].items()}, jnp.asarray(d["slot"]))
        batch = _port_batch(d)
        slot = torch.from_numpy(d["slot"])
        out, birth, death, new_state, m = partition_length_window_step(state, batch, slot, w, p)

        flat = _flatten(jout)
        keep = np.asarray(flat.valid)
        n = int(keep.sum())
        assert out.valid.shape == (2 * b,)
        assert out.valid[:n].all() and not out.valid[n:].any()
        np.testing.assert_array_equal(out.ts[:n].numpy(), np.asarray(flat.ts)[keep])
        np.testing.assert_array_equal(out.kind[:n].numpy(), np.asarray(flat.kind)[keep])
        for c in d["cols"]:
            np.testing.assert_array_equal(out.cols[c][:n].numpy(), np.asarray(flat.cols[c])[keep])
        # rows of JAX's flat [2B * P]: (position, partition)
        fi = np.nonzero(keep)[0]
        q, pos = fi % p, fi // p
        np.testing.assert_array_equal(m.slot[:n].numpy(), q)
        np.testing.assert_array_equal(m.slot[n:].numpy(), np.full(2 * b - n, p))
        assert all(int(m.first[r]) == int(np.nonzero(q == q[r])[0][0]) for r in range(n))
        # the expanded membership of each row: its slot's elements
        jm = np.asarray(jmember)  # [P, 2B, W + B]
        ids = np.concatenate([np.arange(w)[None, :] + w * q[:, None],
                              np.broadcast_to(p * w + np.arange(b), (n, b))], axis=1)
        rr = np.arange(n)[:, None]
        bn, dn, es = birth.numpy()[ids], death.numpy()[ids], m.elem_slot.numpy()[ids]
        got_member = (es == q[:, None]) & (bn <= rr) & (rr < dn)
        np.testing.assert_array_equal(got_member, jm[q, pos])
        # the rings after the batch
        for c in d["cols"]:
            np.testing.assert_array_equal(new_state["cols"][c].numpy(),
                                          np.asarray(jstates2["cols"][c]))
        for k in ("ts", "wts", "seq", "total"):
            np.testing.assert_array_equal(new_state[k].numpy(), np.asarray(jstates2[k]))
        # K30 on the same membership
        for c, t in VALUE_COLS:
            vals = torch.cat([state["cols"][c].reshape(-1), batch.cols[c]])
            for is_min in (True, False):
                got = partition_window_extreme(vals, birth, death, m.slot, m.rowlist,
                                               m.slot_start, w, is_min, AttrType[t])
                want = np.asarray(jext[f"{c}_{int(is_min)}"]).swapaxes(0, 1).reshape(-1)[keep]
                np.testing.assert_array_equal(got[:n].numpy(), want)
        state, jstates = new_state, jstates2


def test_out_of_slot_order_inner_batch():
    """An inner-stream batch: rows already in (position, slot) order, so the
    slots arrive out of slot order; each slot's rows rank in row order."""
    p, w, b = 4, 2, 12
    step, win = _jax_step(p, w)
    rng = np.random.default_rng(5)
    d = _batch(rng, b, p, 0)
    d["slot"] = np.array([3, 1, 0, 3, 1, 2, 3, 0, 1, 3, 2, 0], np.int32)
    d["kind"][:] = 0
    d["valid"][:] = True
    jst = _jtile(win.init_state(), p)
    _st2, jout, _m, _e = step(jst, jnp.asarray(d["ts"]), jnp.asarray(d["kind"]),
                              jnp.asarray(d["valid"]),
                              {n: jnp.asarray(c) for n, c in d["cols"].items()},
                              jnp.asarray(d["slot"]))
    state = {"cols": {n: torch.from_numpy(np.array(c)) for n, c in jst["cols"].items()},
             **{k: torch.from_numpy(np.array(jst[k])) for k in ("ts", "wts", "seq", "total")}}
    out, *_rest, m = partition_length_window_step(state, _port_batch(d),
                                                  torch.from_numpy(d["slot"]), w, p)
    flat = _flatten(jout)
    keep = np.asarray(flat.valid)
    n = int(keep.sum())
    np.testing.assert_array_equal(out.ts[:n].numpy(), np.asarray(flat.ts)[keep])
    np.testing.assert_array_equal(out.kind[:n].numpy(), np.asarray(flat.kind)[keep])
    assert m.slot[:4].tolist() == [0, 1, 2, 3]  # position 0 of every slot first


# ---------------------------------------------------------------------------
# the keyed K8 / K19 use: slot = partition slot, no resets
# ---------------------------------------------------------------------------


@jax.jit
def _jax_vmapped_sum(masks, contrib, carry):
    return jax.vmap(lambda m, c: jprefix.running_sum(
        jnp.where(m, contrib, 0), jnp.zeros_like(m), c))(masks, carry)


_jax_vmapped_extreme = jax.jit(
    lambda masks, vals, carry, is_min: jax.vmap(lambda m, c: jprefix.running_extreme(
        vals, m, jnp.zeros_like(m), c, is_min))(masks, carry), static_argnums=3)


@pytest.mark.parametrize("p,b", [(1, 33), (33, 513)])
@pytest.mark.parametrize("dtype", ["float32", "int64", "int32"])
def test_keyed_reductions_as_partitions(p, b, dtype):
    """The windowless partitioned step's aggregators: `keyed_running_sum`
    and `keyed_running_extreme` over the rows with the partition slots of
    K7 (keys past capacity dead) equal JAX's running_sum/running_extreme
    vmapped over [P] carries with the partition masks."""
    rng = np.random.default_rng(p * 31 + b + len(dtype))
    keys = rng.integers(0, p + 3, b).astype(np.int64) * 7919
    valid = rng.random(b) < 0.9
    zeros = np.zeros(b, bool)
    table = (torch.zeros(p, dtype=torch.int64), torch.zeros(p, dtype=torch.bool),
             torch.zeros((), dtype=torch.int32))
    *_t, slot, grp, _over = group.assign_slots(*table, torch.from_numpy(keys),
                                               torch.from_numpy(valid), torch.from_numpy(zeros))
    ctx = partition_ctx(slot, grp.first, p, _over)
    sl = slot.numpy()
    live = sl < p
    np_dtype = {"float32": np.float32, "int64": np.int64, "int32": np.int32}[dtype]
    if dtype == "int32":
        vals = rng.integers(-1000, 1000, b).astype(np.int32)
    else:
        vals = rng.uniform(-100, 100, b).astype(np_dtype) if dtype == "float32" else \
            rng.integers(-(10**6), 10**6, b).astype(np.int64)
    masks = jnp.asarray(valid & live)[None, :] & (jnp.asarray(sl)[None, :]
                                                  == jnp.arange(p)[:, None])
    cols = np.arange(b)
    if dtype != "int32":
        contrib = np.where(valid & live, vals, 0).astype(np_dtype)
        carry = (rng.uniform(-10, 10, p) if dtype == "float32" else
                 rng.integers(-100, 100, p)).astype(np_dtype)
        want_run, want_carry = _jax_vmapped_sum(masks, jnp.asarray(contrib), jnp.asarray(carry))
        run, new_carry = group.keyed_running_sum(torch.from_numpy(contrib), ctx.groups,
                                                 torch.from_numpy(zeros),
                                                 torch.from_numpy(carry), ctx.slot)
        got, want = run.numpy()[live], np.asarray(want_run)[sl[live], cols[live]]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(new_carry.numpy(), np.asarray(want_carry), rtol=2e-4,
                                       atol=2e-4)
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(new_carry.numpy(), np.asarray(want_carry))
    for is_min in (True, False):
        ident = np.asarray(jprefix.extreme_identity(np_dtype, is_min))
        carry = np.where(rng.random(p) < 0.5, ident, rng.integers(-50, 50, p)).astype(np_dtype)
        want_run, want_carry = _jax_vmapped_extreme(masks, jnp.asarray(vals),
                                                    jnp.asarray(carry), is_min)
        run, new_carry = group.keyed_running_extreme(
            torch.from_numpy(vals), torch.from_numpy(valid & live), ctx.groups,
            torch.from_numpy(zeros), torch.from_numpy(carry), ctx.slot, is_min)
        np.testing.assert_array_equal(run.numpy()[live], np.asarray(want_run)[sl[live],
                                                                                cols[live]])
        np.testing.assert_array_equal(new_carry.numpy(), np.asarray(want_carry))


def test_tile_matches_jax():
    tree = {"a": np.arange(3, dtype=np.int32), "b": [np.float32(2.5), np.int64(-1)]}
    want = jax.tree_util.tree_map(np.asarray, _jtile(jax.tree_util.tree_map(jnp.asarray, tree), 5))
    got = port_tile({"a": torch.arange(3, dtype=torch.int32),
                     "b": [torch.tensor(2.5), torch.tensor(-1)]}, 5)
    np.testing.assert_array_equal(got["a"].numpy(), want["a"])
    np.testing.assert_array_equal(got["b"][0].numpy(), want["b"][0])
    np.testing.assert_array_equal(got["b"][1].numpy(), want["b"][1])


# ---------------------------------------------------------------------------
# K31 / K32 / K33: the partitioned time window, batch window and per-
# partition group-slot assignment against jax.vmap of the JAX functions
# ---------------------------------------------------------------------------

from siddhi_tpu.core.windows import BatchWindow as JaxBatchWindow  # noqa: E402
from siddhi_tpu.ops import group as jgroup  # noqa: E402
from siddhi_tpu_torch.core.windows import (  # noqa: E402
    NO_TIMER,
    TIMER_BUCKET,
    TIMER_NONE,
    TIMER_TIMEOUT,
)
from siddhi_tpu_torch.ops.partition import (  # noqa: E402
    partition_batch_window_step,
    partition_time_window_step,
)


def _jax_window_vmap(win, p: int):
    """jit of one step of `win` vmapped over [P]-tiled states with
    partition.py's masks; the next timers min-reduced (`_reduce_paux`)."""

    @jax.jit
    def step(states, ts, kind, valid, cols, slot, now):
        active = valid & (kind == 0) & (slot < p)
        is_timer = valid & (kind == 2)

        def one(state, q):
            b2 = JaxBatch(ts, kind, (active & (slot == q)) | is_timer, cols)
            st, fl = win.apply(state, JaxFlow(batch=b2, ref="S", now=now))
            nt = fl.aux.get("next_timer", jnp.int64(NO_TIMER))
            return st, fl.batch, fl.member, nt

        sts, outs, members, nts = jax.vmap(one)(states, jnp.arange(p))
        return sts, outs, members, nts.min()

    return step


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def state_np(tree):
    if isinstance(tree, dict):
        return {k: state_np(v) for k, v in tree.items()}
    return tree.numpy()


def _check_flat(out, jout, p):
    """The port's rows against `_flatten` of the vmapped output, compacted;
    returns (q, pos) of each row in the JAX [P, K] output."""
    flat = _flatten(jout)
    keep = np.asarray(flat.valid)
    n = int(keep.sum())
    assert out.valid.shape == (max(n, 1),)
    assert out.valid[:n].all() and not out.valid[n:].any()
    np.testing.assert_array_equal(out.ts[:n].numpy(), np.asarray(flat.ts)[keep])
    np.testing.assert_array_equal(out.kind[:n].numpy(), np.asarray(flat.kind)[keep])
    for c in out.cols:
        np.testing.assert_array_equal(out.cols[c][:n].numpy(), np.asarray(flat.cols[c])[keep])
    fi = np.nonzero(keep)[0]
    return n, fi % p, fi // p


def _check_members(n, q, pos, birth, death, elem_slot, jmember, ids):
    rr = np.arange(n)[:, None]
    bn, dn, es = birth.numpy()[ids], death.numpy()[ids], elem_slot.numpy()[ids]
    got = (es == q[:, None]) & (bn <= rr) & (rr < dn)
    np.testing.assert_array_equal(got, np.asarray(jmember)[q, pos])


def _time_batch(rng, b, p, t0, spread, disorder):
    d = _batch(rng, b, p, t0)
    d["ts"] = t0 + np.sort(rng.integers(0, spread, b)).astype(np.int64)
    if disorder:  # an externalTime attribute out of order
        d["cols"]["volume"] = d["ts"] + rng.integers(-disorder, disorder + 1, b)
    return d


# (P, B, W, t, window): time(t) on ts, timeLength(t, W), externalTime on
# `volume` (disordered); W small enough that rings evict at capacity
TW_CASES = [(1, 1, 4, 5, "time"), (8, 33, 4, 20, "time"), (33, 33, 2, 10, "timelength"),
            (8, 513, 16, 40, "ext"), (33, 513, 4, 25, "ext"), (5, 513, 64, 100, "time")]


@pytest.mark.parametrize("p,b,w,t,kind", TW_CASES)
def test_partition_time_window_step(p, b, w, t, kind):
    """Four carried batches of arrivals with TIMER, EXPIRED, invalid and
    no-partition rows: K31's rows, rings, next timer and membership against
    the vmapped JAX SlidingWindow (time path), flattened and compacted."""
    rng = np.random.default_rng(7 * p + b + w)
    ext = kind == "ext"
    win = JaxSlidingWindow(JSCHEMA, "S", capacity=w, duration_ms=t,
                           time_attr="volume" if ext else None, use_scheduler=not ext)
    step = _jax_window_vmap(win, p)
    jstates = _jtile(win.init_state(), p)
    state = _torch_tree(jstates)
    for i in range(4):
        d = _time_batch(rng, b, p, 3 * t * i, 3 * t, t // 2 if ext else 0)
        jst2, jout, jmember, jnext = step(
            jstates, jnp.asarray(d["ts"]), jnp.asarray(d["kind"]), jnp.asarray(d["valid"]),
            {n: jnp.asarray(c) for n, c in d["cols"].items()}, jnp.asarray(d["slot"]),
            jnp.int64(0))
        batch = _port_batch(d)
        bwts = batch.cols["volume"] if ext else batch.ts
        out, birth, death, new_state, next_timer, m = partition_time_window_step(
            state, batch, bwts, torch.from_numpy(d["slot"]), w, t, p)
        n, q, pos = _check_flat(out, jout, p)
        np.testing.assert_array_equal(m.slot[:n].numpy(), q)
        ids = np.concatenate([np.arange(w)[None, :] + w * q[:, None],
                              np.broadcast_to(p * w + np.arange(b), (n, b))], axis=1)
        _check_members(n, q, pos, birth, death, m.elem_slot, jmember, ids)
        np.testing.assert_equal(state_np(new_state), jax.tree_util.tree_map(np.asarray, jst2))
        if not ext:
            assert int(next_timer) == int(jnext)
        state, jstates = new_state, jst2


# (P, B, w, n, t, window, emit_expired): lengthBatch(n); timeBatch(t) with
# or without a start time; externalTimeBatch(volume, t) with an idle timeout
BW_CASES = [(1, 1, 4, 4, None, "length", True), (8, 33, 4, 4, None, "length", False),
            (33, 513, 8, 8, None, "length", True), (8, 33, 4, None, 10, "timebatch", True),
            (33, 513, 16, None, 25, "timebatch_start", False),
            (8, 513, 16, None, 25, "timebatch", True), (5, 33, 8, None, 10, "ext", True),
            (8, 513, 64, None, 40, "ext_timeout", True),
            (33, 33, 4, None, 10, "ext_timeout", False)]


@pytest.mark.parametrize("p,b,w,n,t,kind,emit", BW_CASES)
def test_partition_batch_window_step(p, b, w, n, t, kind, emit):
    """Four carried batches (arrivals, TIMER rows reaching every slot, a
    clock around the idle deadline): K32's rows, buffers, counts, bucket
    starts, deadlines, next timer and membership against the vmapped JAX
    BatchWindow, flattened and compacted."""
    rng = np.random.default_rng(11 * p + b + w)
    ext = kind.startswith("ext")
    start = 7 if kind == "timebatch_start" else None
    timeout = 15 if kind == "ext_timeout" else None
    sched = kind.startswith("timebatch")
    win = JaxBatchWindow(JSCHEMA, "S", capacity=w, length=n, duration_ms=t,
                         time_attr="volume" if ext else None, use_scheduler=sched,
                         start_time=start, timeout_ms=timeout)
    win.emit_expired = emit
    mode = TIMER_TIMEOUT if timeout else TIMER_BUCKET if sched else TIMER_NONE
    step = _jax_window_vmap(win, p)
    jstates = _jtile(win.init_state(), p)
    state = _torch_tree(jstates)
    now = 1000
    for i in range(4):
        d = _time_batch(rng, b, p, 3 * (t or 4) * i, 3 * (t or 4), 0)
        d["cols"]["volume"] = d["ts"].copy()
        if timeout is not None:
            dls = np.asarray(jstates["timeout_deadline"])
            live = dls[dls != NO_TIMER]
            now = int(live.min()) + int(rng.choice([-3, 3])) if live.size else now + 7
        jst2, jout, jmember, jnext = step(
            jstates, jnp.asarray(d["ts"]), jnp.asarray(d["kind"]), jnp.asarray(d["valid"]),
            {c: jnp.asarray(a) for c, a in d["cols"].items()}, jnp.asarray(d["slot"]),
            jnp.int64(now))
        batch = _port_batch(d)
        out, birth, death, new_state, next_timer, m = partition_batch_window_step(
            state, batch, batch.cols["volume"] if ext else batch.ts, torch.tensor(now),
            torch.from_numpy(d["slot"]), p, w, n, t, start, timeout, mode, emit)
        cnt, q, pos = _check_flat(out, jout, p)
        np.testing.assert_array_equal(m.slot[:cnt].numpy(), q)
        if emit:
            ids = np.concatenate([np.arange(2 * w)[None, :] + 2 * w * q[:, None],
                                  np.broadcast_to(2 * p * w + np.arange(b), (cnt, b))], axis=1)
            _check_members(cnt, q, pos, birth, death, m.elem_slot, jmember, ids)
        else:
            assert birth is None and jmember is None
        np.testing.assert_equal(state_np(new_state), jax.tree_util.tree_map(np.asarray, jst2))
        if sched or timeout:
            assert int(next_timer) == int(jnext)
        state, jstates = new_state, jst2


@jax.jit
def _jax_assign_vmap(keys, used, n, bk, active, reset, pslot):
    p = keys.shape[0]

    def one(k, u, c, q):
        nk, nu, nn, slot, grp, over = jgroup.assign_slots(
            k, u, c, bk, active & (pslot == q), reset & (pslot == q))
        return nk, nu, nn, slot, (grp.perm, grp.seg_start), over

    return jax.vmap(one)(keys, used, n, jnp.arange(p))


# (P, rows, G, distinct keys, RESET share)
K33_CASES = [(1, 1, 4, 3, 0.0), (4, 33, 4, 10, 0.1), (8, 513, 8, 12, 0.02),
             (33, 513, 16, 40, 0.0), (3, 513, 16, 40, 0.01)]


@pytest.mark.parametrize("p,rows,g,nkeys,rp", K33_CASES)
def test_partition_assign_slots(p, rows, g, nkeys, rp):
    """Three carried calls: each row's slot (its partition's lane of the
    vmap), the P tables, counts and per-partition overflow flags exactly;
    the segment heads equal the JAX sorted view's on active rows."""
    rng = np.random.default_rng(p * rows + g)
    jt = (jnp.zeros((p, g), jnp.int64), jnp.zeros((p, g), bool), jnp.zeros(p, jnp.int32))
    pt = tuple(torch.from_numpy(np.array(x)) for x in jt)
    for call in range(3):
        keys = rng.integers(0, nkeys, rows).astype(np.int64) * 7919 - 3
        u = rng.random(rows)
        reset = u < rp
        active = (u >= rp) & (u < 0.92)
        pslot = np.where(rng.random(rows) < 0.05, p, rng.integers(0, p, rows)).astype(np.int32)
        nk, nu, nn, jslot, (perm, seg_start), jover = _jax_assign_vmap(
            *jt, jnp.asarray(keys), jnp.asarray(active), jnp.asarray(reset), jnp.asarray(pslot))
        out = group.partition_assign_slots(*pt, torch.from_numpy(keys),
                                           torch.from_numpy(active), torch.from_numpy(reset),
                                           torch.from_numpy(pslot), p)
        for got, want in zip(out[:3], (nk, nu, nn)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(out[5].numpy(), np.asarray(jover))
        member = (active | reset) & (pslot < p)
        ps = np.minimum(pslot, p - 1)
        want_slot = np.where(member, np.asarray(jslot)[ps, np.arange(rows)], g)
        np.testing.assert_array_equal(out[3].numpy(), want_slot)
        first = out[4].numpy()
        for q in range(p):
            sel = active & (pslot == q)
            pm, ss = np.asarray(perm)[q], np.asarray(seg_start)[q]
            heads = np.asarray(jprefix.segmented_carry(jnp.asarray(pm), jnp.asarray(ss)))
            jfirst = np.empty_like(heads)
            jfirst[pm] = heads
            np.testing.assert_array_equal(first[sel], jfirst[sel])
        assert (first[~active] == np.arange(rows)[~active]).all()
        jt = (nk, nu, nn)
        pt = out[:3]
