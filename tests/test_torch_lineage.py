"""Event lineage (`@app:lineage`) on the port against the JAX package, on the
CPU, with inputs made from a seed with numpy:

- K48, the ring's seq view: the plain `ring_view_seq_ref` (and
  `ring_view(..., with_seq=True)`, its lanes paired by position) against
  JAX's jitted `SlidingWindow.view_seq` and `view` on length and time rings
  after 1-4 carried batches, time rings with holes, W 1/4/50/1024, B
  1/33/513, and the empty ring;
- the join step's lineage lanes (`__lin.admit`, `j_pi`, `j_pseq`) against
  JAX's `CompiledJoin.step` with `lineage = True`: inner, left and full
  outer joins, a length x time join, a lengthBatch partner (-2), CURRENT
  and EXPIRED probes;
- tests/test_lineage.py under its own assertions with the port's
  SiddhiManager, LineageArena, StreamSchema, InternTable and error class
  swapped in (annotation, arena, window/pattern/join/group-by goldens,
  multi-hop, lineage on vs off, sample mode, aggregation buckets,
  multi-producer), and the port's own zero-overhead and fused = per-batch
  checks;
- record parity: the same app and events through both packages, every
  record and the decoded events of `rt.lineage(q, i)` equal, at batch 16
  and 33, fused and per batch, with the port's emissions byte-identical
  with lineage on and off; a partitioned query runs unrecorded with JAX's
  rows; the in-table and join-side refusals as JAX's.

Tolerances: seqs, ints, strings and the decoded input events are exact
(they are copies of the inputs); emitted floats are within
bench.py:_rows_match's relative 2e-4 against JAX.
"""

import importlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.event import StreamSchema as JaxSchema  # noqa: E402
from siddhi_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.core.windows import SlidingWindow as JaxSlidingWindow  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType, InternTable  # noqa: E402
from siddhi_tpu_torch.core.windows import ring_view, ring_view_seq, ring_view_seq_ref  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy  # noqa: E402
from siddhi_tpu_torch.observability.lineage import LIN, LineageArena  # noqa: E402

ATTRS = [("sym", "STRING"), ("price", "FLOAT"), ("et", "LONG")]
T = 37  # time window (ms)


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _batches(f):
    jb = JaxBatch(jnp.asarray(f["ts"]), jnp.asarray(f["kind"]), jnp.asarray(f["valid"]),
                  {k: jnp.asarray(v) for k, v in f["cols"].items()})
    pb = EventBatch(ts=torch.from_numpy(f["ts"]), kind=torch.from_numpy(f["kind"]),
                    valid=torch.from_numpy(f["valid"]),
                    cols={k: torch.from_numpy(v) for k, v in f["cols"].items()})
    return jb, pb


# ---------------------------------------------------------------------------
# K48: the seq view
# ---------------------------------------------------------------------------


def _ring_feed(rng, b, clock, gap):
    ts = clock + np.cumsum(rng.integers(0, 5, b)).astype(np.int64)
    kind = np.where(rng.random(b) < 0.05, 2, 0).astype(np.int8)
    if gap:  # ten durations on: the ring empties into holes
        ts += 10 * T
    return {"ts": ts, "kind": kind, "valid": rng.random(b) < 0.85,
            "cols": {"sym": rng.integers(1, 9, b).astype(np.int32),
                     "price": rng.uniform(0, 100, b).astype(np.float32),
                     "et": ts.copy()}}


@pytest.mark.parametrize("w", [1, 4, 50, 1024])
@pytest.mark.parametrize("kind", ["length", "time", "time_holes"])
def test_view_seq_matches_jax(kind, w):
    """For each B of 1, 33 and 513: the empty ring, then after each of 4
    carried batches, `ring_view_seq` and `ring_view_seq_ref` equal JAX's
    jitted view_seq, and `ring_view(with_seq=True)` gives view()'s lanes
    with the same seqs beside them, exactly."""
    rng = np.random.default_rng(w * 13 + len(kind))
    jschema = JaxSchema("S", [(n, getattr(JaxAttrType, t)) for n, t in ATTRS])
    jwin = JaxSlidingWindow(jschema, "S", capacity=w, duration_ms=None if kind == "length" else T)
    view_seq = jax.jit(jwin.view_seq)
    view = jax.jit(jwin.view)
    apply = jax.jit(lambda st, b: jwin.apply(st, JaxFlow(batch=b, ref="S",
                                                          now=jnp.asarray(0, jnp.int64)))[0])
    holes = live = 0
    for b in (1, 33, 513):
        jst = jwin.init_state()
        for step in range(5):
            if step:
                f = _ring_feed(rng, b, 1000 + 100 * step, gap=kind == "time_holes" and step == 3)
                jst = apply(jst, _batches(f)[0])
            pst = state_from_numpy(_np_tree(jst), "cpu")
            want = np.asarray(view_seq(jst))
            assert np.array_equal(ring_view_seq_ref(pst).numpy(), want)
            assert np.array_equal(ring_view_seq(pst).numpy(), want)
            cols, ts, mask, vseq = ring_view(pst, with_seq=True)
            jcols, jts, jmask = view(jst)
            assert np.array_equal(vseq.numpy(), want)
            assert np.array_equal(mask.numpy(), np.asarray(jmask))
            assert np.array_equal(ts.numpy(), np.asarray(jts))
            for n in jcols:
                assert np.array_equal(cols[n].numpy(), np.asarray(jcols[n])), n
            n_live = int((want >= 0).sum())
            live += n_live
            holes += int(step > 0 and n_live < w)
            assert (want[:n_live] >= 0).all() and (want[n_live:] == -1).all()
    assert live > 0
    if kind == "time_holes" and w > 1:
        assert holes > 0


# ---------------------------------------------------------------------------
# the join step's lineage lanes
# ---------------------------------------------------------------------------

JOIN_HEAD = ("\ndefine stream L (sym int, price float, v long);\n"
             "define stream R (who int, sym int, n int);\n")
JOINS = {
    "inner": "from L#window.length({w}) join R#window.length({w}) on L.sym == R.sym",
    "left_outer": "from L#window.length({w}) left outer join R#window.length({w}) "
                  "on L.sym == R.sym",
    "full_outer": "from L#window.length({w}) full outer join R#window.length({w}) "
                  "on L.sym == R.sym",
    "length_time": "from L#window.length({w}) join R#window.time(30) on L.sym == R.sym",
    "length_batch": "from L#window.length({w}) join R#window.lengthBatch({w}) "
                    "on L.sym == R.sym",
}


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
                "n": rng.integers(-5, 5, b).astype(np.int32)}
    return {"ts": ts, "kind": kind, "valid": rng.random(b) < 0.8, "cols": cols}


@pytest.mark.parametrize("events", ["", "all events "])
@pytest.mark.parametrize("app", sorted(JOINS))
def test_join_lineage_lanes_match_jax(app, events):
    """10 steps alternating sides: the admit lane, each joined row's probe
    row (j_pi) and partner window seq (j_pseq: -1 a null partner, -2 a
    lengthBatch partner), exactly; `insert all events` adds the EXPIRED
    probes."""
    rng = np.random.default_rng(len(app) * 31 + len(events))
    ql = ("@app:joinCapacity(size='256')" + JOIN_HEAD + "@info(name='q') "
          + JOINS[app].format(w=5) + f" select L.sym as s, R.who as who insert {events}into Out;")
    jjoin = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql).queries["q"].join
    pjoin = _port().create_siddhi_app_runtime(ql).queries["q"].join
    jjoin.lineage = pjoin.lineage = True
    def jstep(st, b, now, side):
        st, flow, aux = jjoin.step(st, b, now, side)
        return st, flow.batch.valid, aux

    jstep = jax.jit(jstep, static_argnums=(3,))
    jst = jjoin.init_state()
    pst = state_from_numpy(_np_tree(jst), "cpu")
    seen = {"pseq": set(), "pi": 0}
    for step in range(10):
        side = "lr"[step % 2]
        f = _side_feed(rng, side, 9, 1000 + 10 * step)
        jb, pb = _batches(f)
        now = 1000 + 10 * step
        jst, jvalid, jaux = jstep(jst, jb, jnp.asarray(now, jnp.int64), side)
        pst, pflow, paux = pjoin.step(pst, pb, torch.tensor(now), side)
        for k in ("admit", "j_pi", "j_pseq"):
            assert np.array_equal(paux[LIN + k].numpy(), np.asarray(jaux[LIN + k])), k
        assert np.array_equal(pflow.batch.valid.numpy(), np.asarray(jvalid))
        pseq = np.asarray(jaux[LIN + "j_pseq"])
        seen["pseq"] |= set(np.unique(pseq).tolist())
        seen["pi"] += int((np.asarray(jaux[LIN + "j_pi"]) >= 9).sum())  # EXPIRED probes
    assert any(s >= 0 for s in seen["pseq"])
    if app == "length_batch":
        assert -2 in seen["pseq"]
    if app.endswith("outer"):
        assert -1 in seen["pseq"]
    if events and app != "length_batch":
        assert seen["pi"] > 0


# ---------------------------------------------------------------------------
# tests/test_lineage.py on the port
# ---------------------------------------------------------------------------

MOD = "tests.test_lineage"
JAX_CASES = [
    ("TestAnnotation", "test_malformed_capacity_raises_at_creation"),
    ("TestAnnotation", "test_malformed_mode_raises_at_creation"),
    ("TestArena", "test_seq_addressing_and_eviction"),
    ("TestArena", "test_current_rows_only"),
    ("TestArena", "test_oversized_commit_keeps_seq_slot_mapping"),
    ("TestArena", "test_zero_current_publish_updates_last_range"),
    ("TestSlidingWindowGolden", "test_exact_window_contents_with_filter"),
    ("TestSlidingWindowGolden", "test_time_window_contents"),
    ("TestPatternGolden", "test_sequence_returns_exactly_the_two_contributing_events"),
    ("TestJoinGolden", "test_left_right_seq_pair_per_match"),
    ("TestJoinGolden", "test_partner_without_admission_order_is_flagged"),
    ("TestGroupByGolden", "test_per_key_bucket_members"),
    ("TestMultiHop", "test_walks_back_to_ingress"),
    ("TestMultiHop", "test_stream_index_accounts_for_expired_records"),
    ("TestMultiHop", "test_externally_co_fed_stream_is_not_walked"),
    ("TestParity", "test_emissions_byte_identical_lineage_on_vs_off"),
    ("TestSurfaces", "test_sample_mode_records_every_kth"),
    ("TestSurfaces", "test_aggregation_buckets"),
    ("TestMultiProducer", "test_seq_resolves_to_actual_producer"),
    ("TestMultiProducer", "test_consumer_inputs_walk_through_producers"),
    ("TestMultiProducer", "test_external_interleaved_writer_stays_mixed"),
]


class _CpuSchema(StreamSchema):
    """The port's schema with the JAX signature's device-less `to_batch`
    (the batch lands on the CPU)."""

    def to_batch(self, timestamps, rows, interner, device="cpu", capacity=None, kinds=None):
        return super().to_batch(timestamps, rows, interner, device, capacity=capacity,
                                kinds=kinds)


@pytest.mark.parametrize("cname,fname", JAX_CASES)
def test_jax_lineage_test_on_the_port(cname, fname, monkeypatch):
    """The test itself, with the port's manager (on the CPU), arena,
    schema, types, intern table and error class swapped in: its own assertions
    hold the port's records."""
    mod = importlib.import_module(MOD)
    for name, obj in (("SiddhiManager", _port), ("LineageArena", LineageArena),
                      ("StreamSchema", _CpuSchema), ("InternTable", InternTable),
                      ("AttrType", AttrType), ("SiddhiAppCreationError", SiddhiAppCreationError)):
        monkeypatch.setattr(mod, name, obj)
    monkeypatch.setattr(mod, "_drain", lambda: None)  # the port delivers before send returns
    case = getattr(mod, cname)()
    kw = {"monkeypatch": monkeypatch} if fname.startswith("test_emissions") else {}
    getattr(case, fname)(**kw)


def test_zero_overhead_off_and_no_lineage_lane_in_aux():
    """Lineage off: no recorder, probe, arena or ledger, and no step lane;
    lineage on: the `__lin.*` lanes go to the recorder, never into the
    step's aux flags, for a window, a join and a pattern query."""
    body = ("define stream S (v long);\ndefine stream R (v long);\n"
            "@info(name='w') from S#window.length(3) select sum(v) as s insert into Out;\n"
            "@info(name='j') from S#window.length(2) join R#window.length(2) on S.v == R.v "
            "select S.v as a insert into J;\n"
            "@info(name='p') from every e1=S[v > 1] -> e2=R[v > e1.v] select e1.v as a "
            "insert into P;\n")
    for head in ("", "@app:lineage(capacity='64')\n"):
        mgr = _port()
        rt = mgr.create_siddhi_app_runtime(head + body)
        keys = []
        for qr in rt.queries.values():
            orig = qr._note_aux

            def spy(aux, _orig=orig):
                keys.extend(aux)
                _orig(aux)

            qr._note_aux = spy
        rt.start()
        for i in range(4):
            rt.get_input_handler("S").send([i], timestamp=1000 + i)
            rt.get_input_handler("R").send([i + 1], timestamp=1000 + i)
        assert keys and not any(k.startswith("__lin") for k in keys)
        if head:
            assert all(qr.lineage is not None and qr.lineage.out_count > 0
                       for qr in rt.queries.values())
            assert all(not qr._lin_sink for qr in rt.queries.values())
            continue
        qr = rt.queries["w"]
        assert qr.lineage is None and qr.chain.lineage_probe is None
        assert all(j.lineage is None for j in rt.junctions.values())
        assert rt.lineage_ledger is None and rt.lineage_report() == {}
        assert all(not q._lin_sink for q in rt.queries.values())
        with pytest.raises(SiddhiAppCreationError, match="@app:lineage"):
            rt.lineage("w")
        rt.shutdown()
        mgr.shutdown()


def test_jax_parity_app_records_fused_equal_per_batch():
    """tests/test_lineage.py's PARITY_APP through send_columns (the fused
    path) and with the fused engines detached (per batch): the same rows,
    the same records, and the same records as JAX's."""
    mod = importlib.import_module(MOD)
    head = "@app:lineage(capacity='512')"

    def drive(mgr, fused):
        rt = mgr.create_siddhi_app_runtime(mod.PARITY_APP.replace("{LINEAGE}", head))
        got = {"w": [], "g": []}
        for qid in got:
            rt.add_callback(qid, lambda ts, ins, rem, _q=qid: got[_q].extend(
                (e.timestamp, tuple(e.data)) for e in ins or []))
        rt.start()
        if not fused:
            rt.junctions["S"].fused_ingest = None
        n = 256
        ts = np.arange(n, dtype=np.int64) + 10_000
        vs = (np.arange(n, dtype=np.int64) * 7) % 23
        rt.get_input_handler("S").send_columns(ts, {"v": vs, "k": vs % 4}, now=int(ts[-1]))
        fi = rt.junctions["S"].fused_ingest
        chunks = fi.chunks_dispatched if fi is not None else 0
        recs = {q: list(rt.queries[q].lineage.records) for q in got}
        rt.shutdown()
        mgr.shutdown()
        return got, recs, chunks

    out1, rec1, chunks1 = drive(_port(), True)
    out0, rec0, chunks0 = drive(_port(), False)
    _jout, jrec, _c = drive(siddhi_tpu.SiddhiManager(), False)
    assert chunks1 > 0 and chunks0 == 0
    assert out1 == out0
    assert rec1 == rec0 == jrec
    assert all(rec1.values())


# ---------------------------------------------------------------------------
# record parity: the same app and events through both packages
# ---------------------------------------------------------------------------

SYMS = ["A", "B", "C", "D"]
LIN_HEAD = "@app:lineage(capacity='4096')\n"
STOCK = "define stream S (symbol string, price float, volume long, ets long);\n"
TRADES = ("define stream L (symbol string, price float, volume long, ets long);\n"
          "define stream R (symbol string, price float, volume long, ets long);\n")
LIN_APPS = {
    "filter_length_avg": ("", STOCK, "@info(name='q') from S[price > 30]#window.length(5) "
                          "select symbol, avg(price) as ap insert into Out;"),
    "time_window": ("@app:playback\n", STOCK, "@info(name='q') from S#window.time(100) "
                    "select symbol, sum(volume) as v insert into Out;"),
    "groupby_lengthbatch": ("", STOCK, "@info(name='q') from S#window.lengthBatch(7) "
                            "select symbol, sum(volume) as t group by symbol insert into Out;"),
    "join": ("", TRADES, "@info(name='q') from L#window.length(6) join R#window.length(4) "
             "on L.symbol == R.symbol select L.symbol as s, L.price as p, R.volume as v "
             "insert into Out;"),
    "pattern_within": ("", STOCK, "@info(name='q') from every a1=S[price > 80] -> "
                       "a2=S[price < 20] within 50 milliseconds "
                       "select a1.symbol as s1, a2.symbol as s2 insert into Out;"),
    "count_sequence": ("", STOCK, "@info(name='q') from every a1=S[price > 70]<2:4> -> "
                       "a2=S[price < 20] select a2.symbol as s2 insert into Out;"),
    "absent": ("@app:playback\n", STOCK, "@info(name='q') from every e1=S[price > 90] -> "
               "not S[symbol == e1.symbol and price < 10] for 50 milliseconds "
               "select e1.symbol as s, e1.price as p insert into Out;"),
    "aggregation": ("", STOCK, "define aggregation Agg from S select symbol, "
                    "sum(volume) as total group by symbol aggregate by ets every sec ... min;\n"
                    "@info(name='q') from S[volume > 100] select symbol, volume insert into Out;"),
    "chain": ("", STOCK, "@info(name='q1') from S[price > 20] select symbol, volume * 2 as v "
              "insert into Mid;\n@info(name='q') from Mid#window.length(3) "
              "select symbol, sum(v) as t insert into Out;"),
    "sample": ("", STOCK, "@info(name='q') from S#window.length(4) "
               "select symbol, max(price) as m insert into Out;"),
}


def _lin_feeds(app: str, b: int):
    """Three calls of 2*B events a stream (streams interleaved by call),
    symbols as names; 7 ms apart."""
    rng = np.random.default_rng(len(app) * 7 + b)
    streams = ("L", "R") if app == "join" else ("S",)
    calls = []
    for c in range(3):
        for si, sid in enumerate(streams):
            n = 2 * b
            ts = (1_700_000_000_000 + 7 * (c * n + np.arange(n)) + si).astype(np.int64)
            calls.append((sid, ts, {"symbol": rng.choice(SYMS, n),
                                    "price": rng.uniform(0, 100, n).astype(np.float32),
                                    "volume": rng.integers(1, 1000, n).astype(np.int64),
                                    "ets": ts.copy()}))
    return calls


def _lin_drive(mgr, ql: str, calls, fused: bool):
    rt = mgr.create_siddhi_app_runtime(ql)
    ids = {s: mgr.interner.intern(s) for s in SYMS}
    rows = {q: [] for q in rt.queries}
    for q in rt.queries:
        rt.add_callback(q, lambda ts, ins, rem, _q=q: rows[_q].extend(
            [("in", e.timestamp, tuple(e.data)) for e in ins or []]
            + [("rm", e.timestamp, tuple(e.data)) for e in rem or []]))
    rt.start()
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    for sid, ts, cols in calls:
        cols = dict(cols, symbol=np.asarray([ids[s] for s in cols["symbol"]], np.int32))
        rt.get_input_handler(sid).send_columns(ts, cols, now=int(ts[-1]))
    chunks = sum(j.fused_ingest.chunks_dispatched for j in rt.junctions.values()
                 if j.fused_ingest is not None)
    recs, chains = {}, {}
    for q, qr in rt.queries.items():
        lin = getattr(qr, "lineage", None)
        if lin is not None:
            recs[q] = list(lin.records)
            chains[q] = [rt.lineage(q, r["out_index"]) for r in recs[q][-16:]]
    aggs = (rt.lineage_report().get("aggregations") or {}) if rt.lineage_ledger else {}
    rt.shutdown()
    mgr.shutdown()
    return rows, recs, chains, aggs, chunks


@pytest.mark.parametrize("b", [16, 33])
@pytest.mark.parametrize("app", sorted(LIN_APPS))
def test_records_match_jax(app, b):
    """Every record (out_index, pub_index, ts, kind, input seq ranges,
    approx, trigger) and the decoded events of the last 16 outputs'
    `rt.lineage(q, i)` equal JAX's per-batch run, per batch and fused; the
    port's rows equal with lineage on and off and match JAX's."""
    playback, streams, body = LIN_APPS[app]
    mode = ", mode='sample', sample.every='4'" if app == "sample" else ""
    head = f"{playback}@app:batch(size='{b}')\n"
    lin = LIN_HEAD.replace("')", f"'{mode})") if mode else LIN_HEAD
    ql = lin + head + streams + body
    calls = _lin_feeds(app, b)
    jrows, jrecs, jchains, jaggs, _c = _lin_drive(siddhi_tpu.SiddhiManager(), ql, calls, False)
    assert jrecs and any(jrecs.values()), "JAX recorded nothing"
    for fused in (False, True):
        rows, recs, chains, aggs, chunks = _lin_drive(_port(), ql, calls, fused)
        assert recs == jrecs, f"records differ ({'fused' if fused else 'per batch'})"
        assert chains == jchains
        assert aggs == jaggs
        assert bench._rows_match(rows, jrows)
        if fused and app in ("filter_length_avg", "groupby_lengthbatch", "join", "pattern_within",
                             "count_sequence", "sample"):
            assert chunks > 0
    off_rows = _lin_drive(_port(), head + streams + body, calls, True)[0]
    assert off_rows == rows  # byte-identical emissions, lineage on vs off
    if app == "aggregation":
        assert jaggs["Agg"]["events"] == sum(len(c[1]) for c in calls)


def test_partitioned_query_runs_unrecorded():
    """A partitioned query under @app:lineage runs with JAX's rows and no
    recorder; the unpartitioned query beside it is recorded as JAX's."""
    ql = (LIN_HEAD + "@app:batch(size='16')\n" + STOCK
          + "partition with (symbol of S) begin\n"
            "@info(name='pq') from S#window.length(3) select symbol, sum(volume) as t "
            "insert into Out;\nend;\n"
            "@info(name='q') from S[price > 50] select symbol, price insert into Hi;")
    calls = _lin_feeds("partition", 16)
    jrows, jrecs, _jc, _ja, _c = _lin_drive(siddhi_tpu.SiddhiManager(), ql, calls, False)
    rows, recs, _pc, _pa, _c = _lin_drive(_port(), ql, calls, False)
    assert list(jrecs) == list(recs) == ["q"]
    assert recs == jrecs
    assert len(jrows["pq"]) > 20
    assert bench._rows_match(rows, jrows)


# ---------------------------------------------------------------------------
# the refusals the port copies from JAX
# ---------------------------------------------------------------------------


def test_lineage_annotation_problems_match_jax():
    """Malformed @app:lineage options raise JAX's class and message."""
    for opts in ("capacity='0'", "mode='x'", "sample.every='0'", "turbo='on'", "'nope'"):
        ql = f"@app:lineage({opts})\ndefine stream S (a int);\nfrom S select a insert into O;"
        msgs = []
        for mgr in (siddhi_tpu.SiddhiManager(), _port()):
            with pytest.raises(Exception) as ei:
                mgr.create_siddhi_app_runtime(ql)
            msgs.append((type(ei.value).__name__, str(ei.value)))
        assert msgs[0] == msgs[1], msgs
