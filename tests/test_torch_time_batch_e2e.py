"""The tumbling time windows (timeBatch, externalTimeBatch) and the remaining
aggregators (stdDev, distinctCount, grouped and running min/max, the forever
forms) end to end through siddhi_tpu_torch (device="cpu"): the verify case
stddev_distinct against VERIFY.json and the JAX package; the
externalTimeBatch goldens and the JAX tests of these forms under their own
assertions; timeBatch under @app:playback, the TB and XB apps at batch 32
and 33, fused = per batch, and JAX state carried in, each against the JAX
package. Floats match to a relative 2e-4 (bench.py:_rows_match); everything
else exactly.

The JAX distinctCount builds a [rows, K, K] mask, cubic in the window
capacity (1024 slots for the time windows), so the apps that run it through
both packages give both the same smaller time capacity.
"""

import importlib
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu.core.windows as jax_windows  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
import siddhi_tpu_torch.core.windows as port_windows  # noqa: E402
from siddhi_tpu_torch.core.event import KIND_CURRENT, KIND_TIMER  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    state_from_numpy,
    state_to_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_W = 64  # the time capacity the apps through both packages run at


def _port():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _collector(rows: list):
    return lambda t, ins, rem: rows.extend(
        [("+",) + tuple(e.data) for e in (ins or [])]
        + [("-",) + tuple(e.data) for e in (rem or [])]
    )


@pytest.fixture
def small_windows(monkeypatch):
    """Both packages' time windows at SMALL_W slots."""
    for mod in (jax_windows, port_windows):
        monkeypatch.setattr(mod.make_window, "__defaults__", (SMALL_W,))


def _verify_feed():
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
            for _ in range(96)]
    return ts, rows


def test_stddev_distinct_verify_case():
    """bench.py's stddev_distinct (length(9) with stdDev and distinctCount)
    over the 96-event verify feed, one event per send: equal to the frozen
    rows of VERIFY.json and to the JAX package."""
    ts, rows = _verify_feed()
    got = {}
    for mgr in (siddhi_tpu.SiddhiManager(), _port()):
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_CASES["stddev_distinct"])
        out = got.setdefault(_pkg(mgr), [])
        rt.add_callback("q", lambda t, ins, rem, _o=out: _o.extend(
            [["+"] + list(e.data) for e in ins or []] + [["-"] + list(e.data) for e in rem or []]))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    with open(os.path.join(ROOT, "VERIFY.json")) as f:
        frozen = json.load(f)["cpu"]["stddev_distinct"]
    assert len(frozen) == 96
    assert bench._rows_match(got["siddhi_tpu_torch"], frozen)
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# ---------------------------------------------------------------------------
# the JAX tests of these forms, under their own assertions
# ---------------------------------------------------------------------------

OWN_ASSERTIONS = [
    ("tests.test_golden_exttimebatch_ref", "TestExternalTimeBatchGolden", name)
    for name in ("test1_two_flushes_with_timeout_param", "test2_two_flushes_no_timeout",
                 "test3_boundary_starts_new_bucket", "test4_exact_second_boundaries",
                 "test5_idle_timeout_flushes_single_bucket",
                 "test6_event_flush_then_idle_timeout")
] + [
    ("tests.test_golden_windows_ref", "TestExternalTimeBatchGolden",
     "test03_no_flush_inside_first_window"),
    ("tests.test_golden_windows_ref", "TestExternalTimeBatchGolden",
     "test05_edge_case_two_flushes"),
    ("tests.test_windows", None, "test_time_batch_event_driven"),
    ("tests.test_groupby", None, "test_groupby_avg_min_max_with_window"),
    ("tests.test_filter_e2e", None, "test_running_aggregators_without_window"),
    ("tests.test_expressions", "TestAggregatorsCorpus", "test_stddev"),
    ("tests.test_expressions", "TestAggregatorsCorpus", "test_distinct_count_window"),
    ("tests.test_expressions", "TestAggregatorsCorpus", "test_min_forever"),
]


@pytest.mark.parametrize("modname,cname,fname", OWN_ASSERTIONS)
def test_jax_test_on_the_port(modname, cname, fname, monkeypatch):
    """The JAX package's test itself, with every SiddhiManager it makes the
    port's: its own assertions hold the port's rows."""
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, "SiddhiManager", _port)
    monkeypatch.setattr(siddhi_tpu, "SiddhiManager", _port)
    fn = getattr(getattr(mod, cname)(), fname) if cname else getattr(mod, fname)
    fn()


def test_stale_timer_after_refill_in_same_batch():
    """test_golden_exttimebatch_ref.py TestIdleTimeoutMixedBatch on the port:
    a CURRENT row re-arms the idle deadline before a later TIMER row of the
    same batch, so that stale timer must not force-close the bucket; an
    elapsed TIMER with no CURRENT row before it does."""
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime("""
    @app:playback
    define stream LoginEvents (timestamp long, ip string);
    @info(name = 'query1')
    from LoginEvents#window.externalTimeBatch(timestamp, 1 sec, 0, 1 sec)
    select timestamp, count() as total
    insert into uniqueIps;
    """)
    ins = []
    rt.add_callback("query1", lambda ts, i, r: ins.extend(e.data for e in i or ()))
    rt.start()
    j = rt.junctions["LoginEvents"]

    def publish(ts, rows, kinds, now):
        j.publish_batch(j.schema.to_batch(ts, rows, rt.interner, rt.device,
                                          capacity=j.batch_size, kinds=kinds), now)

    publish([1400, 1500], [(1400, "a"), (1500, "b")], None, 1000)  # deadline 2000
    assert ins == []
    publish([1600, 5000], [(1600, "c"), (None, None)], [KIND_CURRENT, KIND_TIMER], 5000)
    assert ins == []  # re-armed to 6000 before the stale TIMER
    publish([7000], [(None, None)], [KIND_TIMER], 7000)  # elapsed, rank 0
    assert ins == [(1600, 3)]
    rt.shutdown()
    mgr.shutdown()


# ---------------------------------------------------------------------------
# apps through both packages
# ---------------------------------------------------------------------------

STOCK = "define stream S (symbol string, price float, volume long);\n"
PLAYBACK_APPS = {
    "sum_all_events": "from S#window.timeBatch(100) select sum(volume) as t, count() as n "
                      "insert all events into Out;",
    "grouped_minmax": "from S#window.timeBatch(100) select symbol, min(price) as lo, "
                      "max(price) as hi, avg(price) as ap group by symbol insert into Out;",
    "start_time": "from S#window.timeBatch(100, 1700000000040) select symbol, "
                  "stdDev(price) as sd, count() as n insert into Out;",
    "distinct_forever": "from S#window.timeBatch(50) select distinctCount(symbol) as ds, "
                        "maxForever(price) as mx, minForever(volume) as mv insert into Out;",
    "having_grouped": "from S#window.timeBatch(100) select symbol, sum(volume) as t "
                      "group by symbol having t > 900 insert into Out;",
}


@pytest.mark.parametrize("case", sorted(PLAYBACK_APPS))
def test_time_batch_under_playback(case, small_windows):
    """timeBatch under @app:playback against the JAX package, one event per
    send with the TIMER steps the event-time clock sends, then the rest in
    two send_many calls."""
    ts, rows = _verify_feed()
    ql = "@app:playback\n@app:batch(size='32')\n" + STOCK + "@info(name='q') " + \
        PLAYBACK_APPS[case]
    got = {}
    for mgr in (siddhi_tpu.SiddhiManager(), _port()):
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        for i in range(40):
            h.send(rows[i], timestamp=int(ts[i]))
        h.send_many(rows[40:70], timestamps=[int(t) for t in ts[40:70]])
        h.send_many(rows[70:], timestamps=[int(t) for t in ts[70:]])
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) >= 3
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


TB_APP = """@app:playback @app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q') from StockStream#window.timeBatch(1 sec)
select symbol, avg(price) as ap, stdDev(price) as sd, min(price) as lo, max(price) as hi,
       maxForever(price) as ath, distinctCount(volume) as dv, count() as n
group by symbol insert into Out;
"""
XB_APP = """@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long, ets long);
@info(name='q') from StockStream#window.externalTimeBatch(ets, 1 sec)
select avg(price) as ap, stdDev(price) as sd, max(price) as hi, minForever(price) as atl,
       distinctCount(symbol) as ds, count() as n
insert into Out;
"""


def _stock(n, seed, tick):
    """bench.py's seeded stock feed with `tick` ms between events (so a
    1 sec bucket holds 1000 / tick of them) and `ets` = the timestamp."""
    data = bench._make_stock_data(n, seed=seed)
    data["ts"] = (data["ts"] - data["ts"][0]) * tick + data["ts"][0]
    data["ets"] = data["ts"].copy()
    return data


def _send(rt, mgr, data, lo, hi, cols, fused=True):
    for s in data["names"]:
        mgr.interner.intern(str(s))
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    rt.get_input_handler("StockStream").send_columns(
        data["ts"][lo:hi], {k: data[k][lo:hi] for k in cols}, now=0)


def _run(mgr, app, data, cuts, cols, fused=True):
    rt = mgr.create_siddhi_app_runtime(app)
    rows = []
    rt.add_callback("q", _collector(rows))
    rt.start()
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        _send(rt, mgr, data, lo, hi, cols, fused)
    fi = rt.junctions["StockStream"].fused_ingest
    batches_fused = fi.batches_fused if fi is not None else 0
    rt.shutdown()
    mgr.shutdown()
    return rows, batches_fused


@pytest.mark.parametrize("batch", [32, 33])
def test_tb_app(batch, small_windows):
    """Path TB's app (BASELINE.json config 2 as a tumbling time window),
    one batch a call as path TB sends them: buckets of 50 events that span
    batches, closed by data rows and by the TIMER steps the event-time
    clock sends."""
    data = _stock(640, seed=7, tick=20)
    cols = ("symbol", "price", "volume")
    cuts = list(range(0, 640, batch)) + [640]
    want, _ = _run(siddhi_tpu.SiddhiManager(), TB_APP.format(batch=batch), data, cuts, cols)
    got, _ = _run(_port(), TB_APP.format(batch=batch), data, cuts, cols)
    assert len(want) >= 8 * 10
    assert bench._rows_match(got, want)


@pytest.mark.parametrize("batch", [32, 33])
def test_xb_app_fused_equals_per_batch(batch, small_windows):
    """Path XB's app: the port's fused chunks deliver the per-batch path's
    rows, which equal the JAX package's."""
    data = _stock(40 * batch + 7, seed=7, tick=20)
    cols = ("symbol", "price", "volume", "ets")
    cuts = [0, 9 * batch + 5, 40 * batch + 7]
    want, _ = _run(siddhi_tpu.SiddhiManager(), XB_APP.format(batch=batch), data, cuts, cols)
    fused, n_fused = _run(_port(), XB_APP.format(batch=batch), data, cuts, cols)
    per_batch, _ = _run(_port(), XB_APP.format(batch=batch), data, cuts, cols, fused=False)
    assert n_fused > 0
    assert len(want) >= 20
    assert fused == per_batch
    assert bench._rows_match(fused, want)


GROUPED_XB = """@app:batch(size='32')
define stream StockStream (symbol string, price float, volume long, ets long);
@info(name='q') from StockStream#window.externalTimeBatch(ets, 1 sec)
select symbol, stdDev(price) as sd, min(price) as lo, maxForever(price) as ath,
       distinctCount(volume) as dv, count() as n
group by symbol insert into Out;
"""


def test_state_carry(small_windows):
    """Run JAX for 4 batches, carry its query state (the time branch's
    buffers, bucket start and deadline, stdDev's three sums, the [G]
    forever-max carry, distinctCount's scalar, the group table) and its
    interned strings into the port, then feed both the same next batches."""
    data = _stock(320, seed=11, tick=20)
    cols = ("symbol", "price", "volume", "ets")
    jmgr, pmgr = siddhi_tpu.SiddhiManager(), _port()
    jrt = jmgr.create_siddhi_app_runtime(GROUPED_XB)
    jrt.start()
    _send(jrt, jmgr, data, 0, 128, cols, fused=False)
    tree = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    assert int(tree["chain"]["cur_n"]) > 0 and int(tree["chain"]["bucket_start"]) > 0

    prt = pmgr.create_siddhi_app_runtime(GROUPED_XB)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(tree, "cpu")
    np.testing.assert_equal(state_to_numpy(prt.queries["q"].state), tree)
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    prt.start()
    _send(jrt, jmgr, data, 128, 320, cols, fused=False)
    _send(prt, pmgr, data, 128, 320, cols, fused=False)
    want_state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    got_state = state_to_numpy(prt.queries["q"].state)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"]) > 8
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(got_state["chain"], want_state["chain"])
    np.testing.assert_equal(got_state["sel"]["group"], want_state["sel"]["group"])
    for g, w in zip(got_state["sel"]["aggs"], want_state["sel"]["aggs"]):
        if isinstance(w, dict):  # stdDev's float32 sums: another summation order
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=1e-3)
        else:
            np.testing.assert_equal(g, w)


@pytest.mark.parametrize("ql", [
    "from S#window.length(4) as a join S#window.length(4) as b on a.volume == b.volume "
    "select a.symbol, min(a.price) as m, maxForever(b.price) as x insert into Out;",
    "from S select symbol, min(price) as lo, max(volume) as hi, stdDev(price) as sd "
    "group by symbol insert into Out;",
    "from S select minForever(price) as lo, maxForever(volume) as hi insert into Out;",
    "from S#window.lengthBatch(8) select symbol, min(price) as lo, distinctCount(volume) as d, "
    "maxForever(price) as x group by symbol insert all events into Out;",
])
def test_running_and_grouped_extremes_against_jax(ql):
    """Unwindowed and forever min/max (K18, K19), grouped windowed min/max
    (K3's key lane) and min/max over a join, against the JAX package."""
    ts, rows = _verify_feed()
    got = {}
    for mgr in (siddhi_tpu.SiddhiManager(), _port()):
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + "@app:joinCapacity(size='256')\n"
                                           "@info(name='q') " + ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        h.send_many(rows[:50], timestamps=[int(t) for t in ts[:50]])
        for i in range(50, 96):
            h.send(rows[i], timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) >= 20
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_distinct_count_without_window_raises():
    """As in the JAX package: an unwindowed distinctCount raises at its first
    step (its state would grow without bound)."""
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime(
        bench.VERIFY_HEAD + "@info(name='q') from S select distinctCount(symbol) as d "
        "insert into Out;")
    rt.start()
    with pytest.raises(NotImplementedError, match="requires an upstream window"):
        rt.get_input_handler("S").send(("A", 1.0, 1))
    mgr.shutdown()
