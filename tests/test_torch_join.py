"""The join slice's kernel-bearing functions against the JAX package, on the
CPU, with inputs made from a seed with numpy: the sliding time-window step
(K10, against SlidingWindow.apply's time path for time, timeLength and
externalTime), the ring view (K11, against SlidingWindow.view and
BatchWindow.view) and the probe compaction (K12, against
CompiledJoin.step/_assemble for every join type and probe set).

Tolerances: everything is exact. The three functions only place, order and
gather values; no arithmetic on floats happens in them.
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
from siddhi_tpu.core.event import StreamSchema as JaxSchema  # noqa: E402
from siddhi_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.core.windows import BatchWindow as JaxBatchWindow  # noqa: E402
from siddhi_tpu.core.windows import SlidingWindow as JaxSlidingWindow  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.core.windows import (  # noqa: E402
    BatchWindow,
    ring_view,
    time_window_step,
)
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402

ATTRS = [("sym", "STRING"), ("price", "FLOAT"), ("et", "LONG"), ("n", "INT")]
T = 37  # window duration (ms)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _schemas():
    return (JaxSchema("S", [(n, getattr(JaxAttrType, t)) for n, t in ATTRS]),
            StreamSchema("S", [(n, getattr(AttrType, t)) for n, t in ATTRS]))


def _feed(rng, b, clock, disorder, gap):
    """One partial batch: holes in `valid`, a few TIMER rows, 0-4 ms steps;
    `gap` jumps 10 durations ahead and opens with a TIMER row (it empties
    the ring into that row); `disorder` scatters the externalTime attribute
    by up to 3 durations."""
    ts = clock + np.cumsum(rng.integers(0, 5, b)).astype(np.int64)
    kind = np.where(rng.random(b) < 0.05, 2, 0).astype(np.int8)
    if gap:
        ts += 10 * T
        kind[0] = 2
    et = ts + (rng.integers(-3 * T, 3 * T, b) if disorder else 0)
    return {
        "ts": ts, "kind": kind, "valid": rng.random(b) < 0.85,
        "cols": {"sym": rng.integers(1, 9, b).astype(np.int32),
                 "price": rng.uniform(0, 100, b).astype(np.float32),
                 "et": et.astype(np.int64),
                 "n": rng.integers(-1000, 1000, b).astype(np.int32)},
    }


def _batches(f):
    jb = JaxBatch(jnp.asarray(f["ts"]), jnp.asarray(f["kind"]), jnp.asarray(f["valid"]),
                  {k: jnp.asarray(v) for k, v in f["cols"].items()})
    pb = EventBatch(ts=torch.from_numpy(f["ts"]), kind=torch.from_numpy(f["kind"]),
                    valid=torch.from_numpy(f["valid"]),
                    cols={k: torch.from_numpy(v) for k, v in f["cols"].items()})
    return jb, pb


# ---------------------------------------------------------------------------
# K10: the sliding time-window step
# ---------------------------------------------------------------------------


K10_SHAPES = [(4, 1), (4, 33), (16, 33), (16, 513), (1024, 513), (16, 4097), (1024, 4097)]


@pytest.mark.parametrize("w,b", K10_SHAPES)
@pytest.mark.parametrize("kind", ["time", "timeLength", "externalTime", "externalTime_disorder"])
def test_time_window_step_matches_jax(kind, w, b):
    """4 carried batches (the third after a gap that empties the ring):
    output lanes, the lazy membership expanded against JAX's member matrix,
    the ring and next_timer, exactly. W=4 and W=16 with 33+ live events
    exercise the capacity's early eviction."""
    rng = np.random.default_rng(w * 7919 + b)
    jschema, _ = _schemas()
    ext = kind.startswith("externalTime")
    jwin = JaxSlidingWindow(jschema, "S", capacity=w, duration_ms=T,
                            time_attr="et" if ext else None, use_scheduler=not ext)
    jst = jwin.init_state()
    pst = state_from_numpy(_np_tree(jst), "cpu")
    clock, expired = 1000, 0
    for step in range(4):
        f = _feed(rng, b, clock, disorder=kind.endswith("disorder"), gap=step == 2)
        clock = int(f["ts"][-1])
        jb, pb = _batches(f)
        jst, jflow = jwin.apply(jst, JaxFlow(batch=jb, ref="S", now=jnp.asarray(0, jnp.int64)))
        bwts = pb.cols["et"] if ext else pb.ts
        out, birth, death, pst, next_timer = time_window_step(pst, pb, bwts, w, T)
        valid = np.asarray(jflow.batch.valid)
        assert np.array_equal(out.valid.numpy(), valid)
        assert np.array_equal(out.ts.numpy()[valid], np.asarray(jflow.batch.ts)[valid])
        assert np.array_equal(out.kind.numpy()[valid], np.asarray(jflow.batch.kind)[valid])
        for n in f["cols"]:
            assert np.array_equal(out.cols[n].numpy()[valid],
                                  np.asarray(jflow.batch.cols[n])[valid]), n
        # padding rows are zeroed
        assert not out.ts.numpy()[~valid].any() and not out.kind.numpy()[~valid].any()
        p = np.arange(w + 2 * b)[:, None]
        member = (birth.numpy()[None, :] <= p) & (p < death.numpy()[None, :])
        assert np.array_equal(member, np.asarray(jflow.member))
        np.testing.assert_equal(state_to_numpy(pst), _np_tree(jst))
        if not ext:
            assert int(next_timer) == int(jflow.aux["next_timer"])
        expired += int((np.asarray(jflow.batch.kind)[valid] == 1).sum())
    assert expired > 0


# ---------------------------------------------------------------------------
# K11: the ring view
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,b", [(4, 33), (50, 33), (1024, 513)])
@pytest.mark.parametrize("kind", ["length", "time", "externalTime_disorder"])
def test_ring_view_matches_jax(kind, w, b):
    """After each of 4 steps, view() of the ring in insertion order: every
    column, ts and the mask, exactly (a length ring with wraparound, a time
    ring with holes)."""
    rng = np.random.default_rng(w + b)
    jschema, _ = _schemas()
    dur = None if kind == "length" else T
    jwin = JaxSlidingWindow(jschema, "S", capacity=w, duration_ms=dur,
                            time_attr="et" if kind.startswith("ext") else None)
    jst = jwin.init_state()
    holes = 0
    for step in range(4):
        f = _feed(rng, b, 1000 + 200 * step, disorder=kind.endswith("disorder"), gap=False)
        jb, _pb = _batches(f)
        jst, _ = jwin.apply(jst, JaxFlow(batch=jb, ref="S", now=jnp.asarray(0, jnp.int64)))
        pst = state_from_numpy(_np_tree(jst), "cpu")
        cols, ts, mask = ring_view(pst)
        jcols, jts, jmask = jwin.view(jst)
        assert np.array_equal(mask.numpy(), np.asarray(jmask))
        assert np.array_equal(ts.numpy(), np.asarray(jts))
        for n in jcols:
            assert np.array_equal(cols[n].numpy(), np.asarray(jcols[n])), n
        seq = np.asarray(jst["seq"])
        live = seq[seq >= 0]
        holes += int(w - live.size)
    if kind != "length" and w > 33:  # more slots than a duration's arrivals
        assert holes > 0


def test_batch_window_view_matches_jax():
    """lengthBatch's view is its open bucket with a cur_n mask."""
    rng = np.random.default_rng(3)
    jschema, schema = _schemas()
    jwin = JaxBatchWindow(jschema, "S", capacity=10, length=10)
    win = BatchWindow(schema, "S", 10, "cpu")
    jst = jwin.init_state()
    for _ in range(3):
        f = _feed(rng, 7, 1000, disorder=False, gap=False)
        jb, _ = _batches(f)
        jst, _ = jwin.apply(jst, JaxFlow(batch=jb, ref="S", now=jnp.asarray(0, jnp.int64)))
        cols, ts, mask = win.view(state_from_numpy(_np_tree(jst), "cpu"))
        jcols, jts, jmask = jwin.view(jst)
        assert np.array_equal(mask.numpy(), np.asarray(jmask))
        assert np.array_equal(ts.numpy(), np.asarray(jts))
        for n in jcols:
            assert np.array_equal(cols[n].numpy(), np.asarray(jcols[n]))


# ---------------------------------------------------------------------------
# K12: the probe compaction, through CompiledJoin.step
# ---------------------------------------------------------------------------

JOIN_HEAD = """
define stream L (sym string, price float, v long);
define stream R (who string, sym string, n int, ok bool);
"""
JOIN_APPS = {
    "inner": "from L#window.length({w}) join R#window.length({w}) on L.sym == R.sym",
    "left_outer": "from L#window.length({w}) left outer join R#window.length({w}) "
                  "on L.sym == R.sym and R.n > 0",
    "right_outer": "from L#window.length({w}) right outer join R#window.length({w}) "
                   "on L.sym == R.sym",
    "full_outer": "from L[price > 20]#window.length({w}) full outer join R#window.length({w}) "
                  "on L.sym == R.sym",
    "windowless": "from L join R#window.length({w}) on L.sym == R.sym",
    "unidirectional": "from L#window.length({w}) unidirectional join R#window.length({w}) "
                      "on L.sym == R.sym",
    "no_on": "from L#window.length({w}) join R#window.length({w})",
    "time": "from L#window.time(30) join R#window.time(30) on L.sym == R.sym",
}


def _join_cores(app, w, cap, events):
    ql = (f"@app:joinCapacity(size='{cap}')" + JOIN_HEAD + "@info(name='q') "
          + JOIN_APPS[app].format(w=w) + " select L.sym as s, R.who as who "
          + f"insert {events}into Out;")
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql)
    prt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)
    return jrt.queries["q"].join, prt.queries["q"].join


def _side_feed(rng, side, b, clock):
    ts = clock + np.arange(b, dtype=np.int64) * 3
    kind = np.where(rng.random(b) < 0.05, 2, 0).astype(np.int8)
    if side == "l":
        cols = {"sym": rng.integers(1, 5, b).astype(np.int32),
                "price": rng.uniform(0, 100, b).astype(np.float32),
                "v": rng.integers(-(2**40), 2**40, b).astype(np.int64)}
    else:
        cols = {"who": rng.integers(1, 50, b).astype(np.int32),
                "sym": rng.integers(1, 5, b).astype(np.int32),
                "n": rng.integers(-5, 5, b).astype(np.int32),
                "ok": rng.random(b) < 0.5}
    return {"ts": ts, "kind": kind, "valid": rng.random(b) < 0.8, "cols": cols}


@pytest.mark.parametrize("cap", [4096, 7])
@pytest.mark.parametrize("events", ["", "all events "])
@pytest.mark.parametrize("app", sorted(JOIN_APPS))
def test_join_step_matches_jax(app, events, cap):
    """8 steps alternating sides (the first probes an empty view): the joined
    batch (every slot, padding included), both refs' columns and
    timestamps, the overflow flag and both sides' state, exactly. EXPIRED
    probes with `insert all events`; cap 7 overflows."""
    rng = np.random.default_rng(len(app) * 31 + len(events) + cap)
    jjoin, pjoin = _join_cores(app, 6, cap, events)
    jst = jjoin.init_state()
    pst = state_from_numpy(_np_tree(jst), "cpu")
    overflowed = matched = 0
    for step in range(8):
        side = "lr"[step % 2]
        f = _side_feed(rng, side, 9, 1000 + 10 * step)
        jb, pb = _batches(f)
        now = 1000 + 10 * step
        jst, jflow, jaux = jjoin.step(jst, jb, jnp.asarray(now, jnp.int64), side)
        pst, pflow, paux = pjoin.step(pst, pb, torch.tensor(now), side)
        for got, want in ((pflow.batch.ts, jflow.batch.ts), (pflow.batch.kind, jflow.batch.kind),
                          (pflow.batch.valid, jflow.batch.valid)):
            assert np.array_equal(got.numpy(), np.asarray(want))
        for n, c in jflow.batch.cols.items():
            assert np.array_equal(pflow.batch.cols[n].numpy(), np.asarray(c), equal_nan=True), n
        assert set(pflow.extra_cols) == set(jflow.extra_cols)
        for k, c in jflow.extra_cols.items():
            assert np.array_equal(pflow.extra_cols[k].numpy(), np.asarray(c), equal_nan=True), k
        assert bool(paux["join_overflow"]) == bool(jaux["join_overflow"])
        np.testing.assert_equal(state_to_numpy(pst), _np_tree(jst))
        overflowed += bool(jaux["join_overflow"])
        matched += int(np.asarray(jflow.batch.valid).sum())
    assert matched > 0
    if cap == 7 and app in ("inner", "full_outer", "no_on"):
        assert overflowed > 0
