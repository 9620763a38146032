"""The join slice of partitions: the plain K38-K41 against the JAX package on
the CPU, with inputs made from a seed with numpy, against `jax.vmap` over P
lanes of the JAX functions on [P]-tiled states with
siddhi_tpu/core/partition.py's masks (`active & slot == p | TIMER`), then
`_flatten` and compaction:

- the keyed ring view (K38, `partition_ring_view_ref`) against
  `SlidingWindow.view` on rings with holes;
- the keyed join step (`CompiledJoin.step_partitioned`: K29's plain step,
  the ring view and the keyed probe compaction K39,
  `partition_join_assemble_ref`) against `CompiledJoin.step` for every join
  type, CURRENT and EXPIRED probes, a windowless and a unidirectional side
  and a capacity that overflows in single slots: the joined rows, both
  refs' columns and timestamps, each row's slot and first row, the flag and
  both sides' rings;
- the keyed sort window (K40, `partition_sort_window_step_ref`) against
  `SortWindow.apply` with two comparators over NaN/-0.0 keys, and the keyed
  frequent window (K41, `partition_frequent_window_step_ref`) against
  `FrequentWindow.apply` with -0.0/0.0 keys and more than N new keys a call.

P 1/8/33, B 1/33/513, three carried batches (the joins: six steps
alternating sides); every lane, state leaf, flag and count exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from siddhi_tpu.core.windows import SlidingWindow as JaxSlidingWindow  # noqa: E402
from siddhi_tpu.core.windows_special import FrequentWindow as JaxFrequent  # noqa: E402
from siddhi_tpu.core.windows_special import SortWindow as JaxSort  # noqa: E402
from siddhi_tpu_torch.core.groupby import partition_ctx, slot_first  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.core.windows_special import _key_col  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from siddhi_tpu_torch.ops.partition import (  # noqa: E402
    partition_frequent_window_step,
    partition_ring_view,
    partition_sort_window_step,
)
from tests.test_torch_partition import ATTRS, JSCHEMA, _batch, _jtile, _port_batch  # noqa: E402

SHAPES = [(1, 1), (8, 33), (33, 513), (1, 513), (33, 1), (8, 513)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_rows(lanes: dict, valid):
    """The JAX package's `_flatten` (position first, slot second) of [P, K]
    lanes, the valid rows kept; also each kept row's slot and its slot's
    first kept row."""
    v = np.asarray(valid)
    p = v.shape[0]
    flat_valid = np.swapaxes(v, 0, 1).reshape(-1)
    out = {k: np.swapaxes(np.asarray(a), 0, 1).reshape(-1)[flat_valid] for k, a in lanes.items()}
    slot = np.tile(np.arange(p, dtype=np.int32), v.shape[1])[flat_valid]
    first = np.array([int(np.argmax(slot == q)) for q in slot], dtype=np.int32)
    return out, slot, first


def _assert_rows(want: dict, got: dict, n: int):
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape[0] >= max(n, 1)
        assert np.array_equal(g[:n], w, equal_nan=True), k


# ---------------------------------------------------------------------------
# K38: the keyed ring view
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,w", [(1, 1), (8, 4), (33, 50)])
def test_partition_ring_view(p, w):
    """Rings of every fill: empty, partly full, wrapped, and time rings
    with holes (seq -1 inside the live range)."""
    rng = np.random.default_rng(7 * p + w)
    total = rng.integers(0, 3 * w + 1, p).astype(np.int64)
    seq = np.full((p, w), -1, np.int64)
    for q in range(p):
        live = np.arange(max(0, total[q] - w), total[q])
        live = live[rng.random(live.shape[0]) < 0.8]
        seq[q, rng.permutation(w)[:live.shape[0]]] = live
    state = {"cols": {"price": rng.standard_normal((p, w)).astype(np.float32),
                      "qty": rng.integers(-9, 9, (p, w)).astype(np.int32),
                      "ok": rng.random((p, w)) < 0.5},
             "ts": rng.integers(0, 10**6, (p, w)).astype(np.int64),
             "wts": np.zeros((p, w), np.int64), "seq": seq, "total": total}
    win = JaxSlidingWindow(JSCHEMA, "S", capacity=w)
    want = jax.jit(jax.vmap(win.view))(jax.tree_util.tree_map(jnp.asarray, state))
    got = partition_ring_view(state_from_numpy(state, "cpu"))
    np.testing.assert_equal(state_to_numpy(got), _np_tree(want))


# ---------------------------------------------------------------------------
# K39: the keyed join step, through CompiledJoin.step_partitioned
# ---------------------------------------------------------------------------

JOIN_HEAD = """
define stream L (sym string, price float, v long);
define stream R (who string, sym string, n int, ok bool);
"""
JOIN_APPS = {
    "inner": "from L#window.length(4) join R#window.length(3) on L.sym == R.sym",
    "left_outer": "from L#window.length(4) left outer join R#window.length(4) "
                  "on L.sym == R.sym and R.n > 0",
    "right_outer": "from L#window.length(2) right outer join R#window.length(4) "
                   "on L.sym == R.sym",
    "full_outer": "from L[price > 20]#window.length(4) full outer join R#window.length(3) "
                  "on L.sym == R.sym",
    "windowless": "from L join R#window.length(4) on L.sym == R.sym",
    "unidirectional": "from L#window.length(4) unidirectional join R#window.length(4) "
                      "on L.sym == R.sym",
    "no_on": "from L#window.length(3) join R#window.length(3)",
}
# (app, output events, join capacity per slot, P, B); capacity 5 and 7
# overflow in single slots
JOIN_CASES = [
    ("inner", "", 4096, 8, 33),
    ("left_outer", "all events ", 4096, 33, 33),
    ("right_outer", "", 4096, 1, 513),
    ("full_outer", "all events ", 5, 8, 513),
    ("windowless", "", 4096, 33, 1),
    ("unidirectional", "all events ", 4096, 8, 33),
    ("no_on", "all events ", 7, 33, 513),
]


def _join_cores(app, cap, events):
    ql = (f"@app:joinCapacity(size='{cap}')" + JOIN_HEAD + "@info(name='q') "
          + JOIN_APPS[app] + " select L.sym as s, R.who as who insert " + events + "into Out;")
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql)
    prt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)
    return jrt.queries["q"].join, prt.queries["q"].join


def _side_feed(rng, side, b, p, clock):
    kind = np.where(rng.random(b) < 0.05, 2, np.where(rng.random(b) < 0.03, 1, 0)).astype(
        np.int8)
    if side == "l":
        cols = {"sym": rng.integers(1, 4, b).astype(np.int32),
                "price": rng.uniform(0, 100, b).astype(np.float32),
                "v": rng.integers(-(2**40), 2**40, b).astype(np.int64)}
    else:
        cols = {"who": rng.integers(1, 50, b).astype(np.int32),
                "sym": rng.integers(1, 4, b).astype(np.int32),
                "n": rng.integers(-5, 5, b).astype(np.int32),
                "ok": rng.random(b) < 0.5}
    return {"ts": clock + np.arange(b, dtype=np.int64) * 3, "kind": kind,
            "valid": rng.random(b) < 0.85, "cols": cols,
            "slot": np.where(rng.random(b) < 0.1, p, rng.integers(0, p, b)).astype(np.int32)}


def _jax_join_step(jjoin, p: int, side: str):
    @jax.jit
    def step(states, ts, kind, valid, cols, slot, now):
        active = valid & (kind == 0)
        is_timer = valid & (kind == 2)

        def one(st, q):
            b2 = JaxBatch(ts, kind, (active & (slot == q)) | is_timer, cols)
            st2, fl, aux = jjoin.step(st, b2, now, side)
            return st2, fl.batch, fl.extra_cols, aux["join_overflow"]

        return jax.vmap(one)(states, jnp.arange(p))

    return step


@pytest.mark.parametrize("app,events,cap,p,b", JOIN_CASES)
def test_partition_join_step(app, events, cap, p, b):
    """Six steps alternating sides (the first probes empty views)."""
    rng = np.random.default_rng(len(app) * 31 + len(events) + cap + p + b)
    jjoin, pjoin = _join_cores(app, cap, events)
    jst = _jtile(jjoin.init_state(), p)
    pst = state_from_numpy(_np_tree(jst), "cpu")
    steps = {s: _jax_join_step(jjoin, p, s) for s in "lr"}
    matched = overflowed = 0
    for i in range(6):
        side = "lr"[i % 2]
        f = _side_feed(rng, side, b, p, 1000 + 10 * i)
        now = 1000 + 10 * i
        jst, jb, jextra, jovf = steps[side](
            jst, jnp.asarray(f["ts"]), jnp.asarray(f["kind"]), jnp.asarray(f["valid"]),
            {n: jnp.asarray(c) for n, c in f["cols"].items()}, jnp.asarray(f["slot"]),
            jnp.asarray(now, jnp.int64))
        slot = torch.from_numpy(f["slot"])
        d = dict(f)
        d["valid"] = (f["valid"] & (f["kind"] == 0) & (f["slot"] < p)) | (
            f["valid"] & (f["kind"] == 2))
        ctx = partition_ctx(slot, slot_first(slot, p), p, torch.tensor(False))
        pst, pflow, paux = pjoin.step_partitioned(pst, _port_batch(d), torch.tensor(now), side,
                                                  ctx)
        lanes = {"ts": jb.ts, "kind": jb.kind, **{f"c.{n}": c for n, c in jb.cols.items()},
                 **{f"x.{k}": c for k, c in jextra.items()}}
        want, wslot, wfirst = _flat_rows(lanes, jb.valid)
        n = wslot.shape[0]
        got = {"ts": pflow.batch.ts, "kind": pflow.batch.kind,
               **{f"c.{nm}": c for nm, c in pflow.batch.cols.items()},
               **{f"x.{k}": c for k, c in pflow.extra_cols.items()}}
        assert set(got) == set(want)
        _assert_rows(want, got, n)
        v = pflow.batch.valid.numpy()
        assert v[:n].all() and not v[n:].any()
        assert np.array_equal(pflow.partition.slot.numpy()[:n], wslot)
        assert np.array_equal(pflow.partition.groups.first.numpy()[:n], wfirst)
        assert bool(paux["join_overflow"]) == bool(np.asarray(jovf).any())
        np.testing.assert_equal(state_to_numpy(pst), _np_tree(jst))
        matched += n
        overflowed += bool(np.asarray(jovf).any())
    assert matched > 0 or b == 1
    if cap < 10:
        assert overflowed > 0


# ---------------------------------------------------------------------------
# K40 / K41: the keyed sort and frequent windows
# ---------------------------------------------------------------------------


def _jax_window_step(win, p: int):
    @jax.jit
    def step(states, ts, kind, valid, cols, slot, now):
        active = valid & (kind == 0) & (slot < p)
        is_timer = valid & (kind == 2)

        def one(st, q):
            b2 = JaxBatch(ts, kind, (active & (slot == q)) | is_timer, cols)
            st2, fl = win.apply(st, JaxFlow(batch=b2, ref="S", now=now))
            return st2, fl.batch, fl.aux["window_overflow"]

        return jax.vmap(one)(states, jnp.arange(p))

    return step


def _check_window(step_port, win, p, b, seed, keyed=None):
    rng = np.random.default_rng(seed)
    step = _jax_window_step(win, p)
    jst = _jtile(win.init_state(), p)
    pst = state_from_numpy(_np_tree(jst), "cpu")
    rows = 0
    for i in range(3):
        d = _batch(rng, b, p, 1000 * i)
        if keyed is not None:
            keyed(rng, d)
        now = 1000 * i + 7
        jst, jout, jovf = step(jst, jnp.asarray(d["ts"]), jnp.asarray(d["kind"]),
                               jnp.asarray(d["valid"]),
                               {n: jnp.asarray(c) for n, c in d["cols"].items()},
                               jnp.asarray(d["slot"]), jnp.asarray(now, jnp.int64))
        slot = torch.from_numpy(d["slot"])
        pst, out, out_slot, out_first, ovf = step_port(pst, _port_batch(d), slot,
                                                       torch.tensor(now))
        lanes = {"ts": jout.ts, "kind": jout.kind, **{f"c.{n}": c for n, c in jout.cols.items()}}
        want, wslot, wfirst = _flat_rows(lanes, jout.valid)
        n = wslot.shape[0]
        _assert_rows(want, {"ts": out.ts, "kind": out.kind,
                            **{f"c.{nm}": c for nm, c in out.cols.items()}}, n)
        assert out.valid[:n].all() and not out.valid[n:].any()
        assert np.array_equal(out_slot.numpy()[:n], wslot)
        assert np.array_equal(out_first.numpy()[:n], wfirst)
        assert bool(ovf) == bool(np.asarray(jovf).any())
        np.testing.assert_equal(state_to_numpy(pst), _np_tree(jst))
        rows += n
    assert rows > 0 or b == 1


SORT_KEYS = {"price_desc_qty": [("price", True), ("qty", False)],
             "volume": [("volume", False)]}


@pytest.mark.parametrize("keys", sorted(SORT_KEYS))
@pytest.mark.parametrize("p,b", SHAPES)
def test_partition_sort_window_step(keys, p, b):
    """sort(3, ...): NaN and -0.0 prices, the arrival evicted, ties."""
    w, ks = 3, SORT_KEYS[keys]
    win = JaxSort(JSCHEMA, "S", w, ks)
    _check_window(lambda st, bt, sl, now: partition_sort_window_step(st, bt, sl, now, ks, w, p),
                  win, p, b, seed=p * 1000 + b + len(keys))


FREQ_KEYS = {"price": ["price"], "symbol_qty": ["symbol", "qty"]}
PORT_ATTRS = [(n, AttrType[t]) for n, t in ATTRS]


@pytest.mark.parametrize("keys", sorted(FREQ_KEYS))
@pytest.mark.parametrize("p,b", SHAPES)
def test_partition_frequent_window_step(keys, p, b):
    """frequent(4, ...): -0.0 and 0.0 are distinct keys; a call brings
    more than 4 new keys to a slot (full tables decrement and evict)."""
    w, ks = 4, FREQ_KEYS[keys]
    win = JaxFrequent(JSCHEMA, "S", w, ks)

    def keyed(rng, d):  # few distinct values, so counts climb and repeat
        d["cols"]["qty"] = rng.integers(0, 6, d["ts"].shape[0]).astype(np.int32)

    def step(st, bt, sl, now):
        key = _key_col(bt.cols, PORT_ATTRS, ks).expand(bt.ts.shape).contiguous()
        return partition_frequent_window_step(st, bt, key, sl, now, w, p)

    _check_window(step, win, p, b, seed=p * 1000 + b + 7 * len(keys), keyed=keyed)


def test_key_past_capacity_enters_no_window():
    """Rows of slot P (a key past capacity) change no slot's window and
    emit nothing, as under the vmap where no lane holds them."""
    p, w = 4, 2
    d = {"ts": np.arange(5, dtype=np.int64), "kind": np.zeros(5, np.int8),
         "valid": np.ones(5, bool), "slot": np.full(5, p, np.int32),
         "cols": {"symbol": np.ones(5, np.int32), "price": np.ones(5, np.float32),
                  "qty": np.ones(5, np.int32), "volume": np.ones(5, np.int64)}}
    st = state_from_numpy(_np_tree(_jtile(JaxSort(JSCHEMA, "S", w, [("price", False)])
                                          .init_state(), p)), "cpu")
    st2, out, out_slot, _f, _o = partition_sort_window_step(
        st, _port_batch(d), torch.from_numpy(d["slot"]), torch.tensor(9), [("price", False)], w,
        p)
    assert not out.valid.any() and int(out_slot[0]) == p
    np.testing.assert_equal(state_to_numpy(st2), state_to_numpy(st))
