"""The sort, frequent, lossyFrequent and cron windows, stream functions,
script functions and output rate limiting end to end through
siddhi_tpu_torch (device="cpu"): the verify cases sort_window, frequent and
stream_fn against VERIFY.json and the JAX package, multi_query_shared per
query against the JAX package; the JAX tests of these forms under their own
assertions; chip_smoke's paths SW, FQ, LF, CR and FN at batch 32 and 33,
fused = per batch = the JAX package's per-batch rows; special windows as
join sides; and JAX window and rate-limiter state carried in. Floats match
to a relative 2e-4 (bench.py:_rows_match); everything else exactly.
"""

import importlib
import json
import logging
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.core.executor import CompiledExpr  # noqa: E402
from siddhi_tpu_torch.core.extension import extension  # noqa: E402
from siddhi_tpu_torch.core.stream_function import StreamFunctionStage  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    load_rate_limiter_state,
    rate_limiter_state,
    state_from_numpy,
    state_to_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_callback_probe():
    """The JAX package probes host callbacks once a process, lazily; a `#log`
    stage makes the first probe while its step is traced, which caches
    False. Keep this file's `#log` apps from deciding it for the tests that
    run after them in the same process."""
    from siddhi_tpu.utils import backend

    saved = backend._CB_SUPPORT
    yield
    backend._CB_SUPPORT = saved


def _port():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _collector(rows: list):
    return lambda t, ins, rem: rows.extend(
        [("+",) + tuple(e.data) for e in (ins or [])]
        + [("-",) + tuple(e.data) for e in (rem or [])]
    )


def _verify_feed():
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
            for _ in range(96)]
    return ts, rows


def _both(ql, feed=None, playback=False):
    """ql through both packages, one event per send over the verify feed:
    {package: {query: rows}}."""
    ts, rows = feed or _verify_feed()
    got = {}
    for mgr in (siddhi_tpu.SiddhiManager(), _port()):
        rt = mgr.create_siddhi_app_runtime(("@app:playback\n" if playback else "") + ql)
        out = got.setdefault(_pkg(mgr), {})
        for q in rt.queries:
            rt.add_callback(q, _collector(out.setdefault(q, [])))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    return got


@pytest.mark.parametrize("case", ["sort_window", "frequent", "stream_fn"])
def test_verify_case(case):
    """The verify case over the 96-event feed: equal to the frozen rows of
    VERIFY.json and to the JAX package."""
    got = _both(bench.VERIFY_CASES[case])
    with open(os.path.join(ROOT, "VERIFY.json")) as f:
        frozen = json.load(f)["cpu"][case]
    port = [list(r) for r in got["siddhi_tpu_torch"]["q"]]
    assert len(frozen) > 50
    assert bench._rows_match(port, frozen)
    assert bench._rows_match(got["siddhi_tpu_torch"]["q"], got["siddhi_tpu"]["q"])


def test_multi_query_shared():
    """bench.py's multi_query_shared (four queries on one stream, one of them
    `output every 5 events`): each query's rows equal the JAX package's."""
    got = _both(bench.VERIFY_CASES["multi_query_shared"])
    assert sorted(got["siddhi_tpu_torch"]) == ["q", "q2", "q3", "q4"]
    for q, want in got["siddhi_tpu"].items():
        assert want, q
        assert bench._rows_match(got["siddhi_tpu_torch"][q], want), q


# ---------------------------------------------------------------------------
# the JAX tests of these forms, under their own assertions
# ---------------------------------------------------------------------------

OWN_ASSERTIONS = [
    ("tests.test_windows_special", "TestSortWindow", "test_keeps_n_smallest"),
    ("tests.test_windows_special", "TestSortWindow", "test_desc_order"),
    ("tests.test_windows_special", "TestSortWindow", "test_sum_over_sort_window"),
    ("tests.test_windows_special", "TestFrequentWindow", "test_top2_keys"),
    ("tests.test_windows_special", "TestFrequentWindow", "test_dropped_when_no_space"),
    ("tests.test_windows_special", "TestLossyFrequentWindow", "test_support_threshold"),
    ("tests.test_windows_special", "TestCronWindow", "test_cron_flush"),
    ("tests.test_windows_special", "TestBatchWindowMembership", "test_min_max_over_length_batch"),
    ("tests.test_windows_special", "TestBatchWindowMembership",
     "test_grouped_min_max_over_length_batch"),
    ("tests.test_stream_function", "TestPol2Cart", "test_appends_xy"),
    ("tests.test_stream_function", "TestPol2Cart", "test_appended_attr_usable_in_filter_and_window"),
    ("tests.test_stream_function", "TestScriptFunction", "test_python_function"),
    ("tests.test_stream_function", "TestScriptFunction", "test_python_expression_body"),
    ("tests.test_golden_windows_ref", "TestSortWindowGolden", "test1_counts"),
    ("tests.test_golden_windows_ref", "TestFrequentWindowGolden", "test1_whole_event_key"),
] + [
    ("tests.test_ratelimit", cls, name) for cls, name in (
        ("TestEventRate", "test_all_every_3_events"),
        ("TestEventRate", "test_first_every_3_events"),
        ("TestEventRate", "test_last_every_3_events"),
        ("TestEventRate", "test_last_per_group_every_3_events"),
        ("TestTimeRate", "test_all_every_period"),
        ("TestTimeRate", "test_snapshot"))
] + [
    ("tests.test_golden_ratelimit_ref", "TestEventOutputRateLimitGolden", name) for name in (
        "test1_all_every_2", "test2_default_every_2", "test3_every_5", "test4_first_every_2",
        "test5_first_every_3", "test6_last_every_2", "test7_last_every_4",
        "test8_group_by_first_every_5", "test9_group_by_last_every_5",
        "test10_group_by_first_every_5_ten_events", "test11_group_by_last_every_5_ten_events",
        "test12_window_group_by_last_every_5", "test13_window_last_every_2",
        "test14_window_last_every_2_expired", "test15_window_all_every_2_expired",
        "test16_window_group_by_all_every_2_expired")
] + [
    ("tests.test_golden_ratelimit_ref", "TestTimeSnapshotRateLimitGolden", name) for name in (
        "test_time1_all_every_1sec", "test_time2_first_every_1sec", "test_time3_last_every_1sec",
        "test_snapshot1_plain_stream", "test_snapshot2_aggregation")
] + [
    ("tests.test_golden_windows_ref", "TestEventRateLimitGolden", name) for name in (
        "test1_all_every_2", "test2_default_every_2", "test3_every_5_of_8",
        "test4_first_every_2", "test5_first_every_3")
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


def _run_port(ql, sends):
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime(ql)
    ins = []
    rt.add_callback("q", lambda ts, i, r: ins.extend(tuple(e.data) for e in i or []))
    rt.start()
    for sid, row, ts in sends:
        rt.get_input_handler(sid).send(row, timestamp=ts)
    rt.shutdown()
    mgr.shutdown()
    return ins


def test_log_passthrough(caplog):
    """test_stream_function.py TestLogStreamProcessor on the port: #log passes
    the events on and logs them to siddhi_tpu_torch.log.<stream>."""
    ql = """
    define stream S (symbol string);
    @info(name='q')
    from S#log('saw event')
    select symbol insert into Out;
    """
    with caplog.at_level(logging.INFO, logger="siddhi_tpu_torch.log.S"):
        ins = _run_port(ql, [("S", ("WSO2",), 1)])
    assert ins == [("WSO2",)]
    assert any("saw event : 1 event(s), ts=[1]" in r.getMessage() for r in caplog.records)


def test_custom_scalar_function():
    """test_stream_function.py TestCustomExtensions with the extension
    registered in the port's registry."""
    @extension("function", "doubled", namespace="custom")
    def _doubled(params, scope):
        (arg,) = params
        return CompiledExpr(arg.type, lambda env: arg(env) * 2)

    ins = _run_port("define stream S (v long); @info(name='q') from S "
                    "select custom:doubled(v) as d insert into Out;", [("S", (21,), 1)])
    assert ins == [(42,)]


def test_custom_stream_function():
    @extension("stream_function", "custom:tag")
    def _tag(params, schema_attrs, ref, scope):
        return StreamFunctionStage(ref, [("tagged", AttrType.LONG)],
                                   lambda env, _p=params: {"tagged": _p[0](env) + 1000})

    ins = _run_port("define stream S (v long); @info(name='q') from S#custom:tag(v) "
                    "select v, tagged insert into Out;", [("S", (1,), 1)])
    assert ins == [(1, 1001)]


def test_script_naming_jnp_raises():
    mgr = _port()
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        mgr.create_siddhi_app_runtime("""
        define function f[python] return double { return jnp.sqrt(data[0]) };
        define stream S (v double);
        @info(name='q') from S select f(v) as r insert into Out;""")


def test_stream_function_clash_raises():
    mgr = _port()
    with pytest.raises(SiddhiAppCreationError, match="collides"):
        mgr.create_siddhi_app_runtime("""
        define stream S (x double, y double);
        @info(name='q') from S#pol2Cart(x, y) select x insert into Out;""")


STREAM_FORMS = {
    "pol2cart_z": "from S#pol2Cart(price, volume, price)[y > 1] select symbol, x, y, z "
                  "insert into Out;",
    "script_in_filter": "from S[sq(price) > 2500] select symbol, sq(price) as p2 insert into Out;",
    "log_then_window": "from S#log('w')#window.length(3) select symbol, sum(volume) as v "
                       "insert into Out;",
    "fn_before_sort": "from S#pol2Cart(price, volume)#window.sort(3, x, 'desc') select symbol, "
                      "x, count() as n insert all events into Out;",
}


@pytest.mark.parametrize("case", sorted(STREAM_FORMS))
def test_stream_forms_match_jax(case):
    ql = ("define function sq[python] return double { return data[0] * data[0] };\n"
          "define stream S (symbol string, price float, volume long);\n@info(name='q') "
          + STREAM_FORMS[case])
    got = _both(ql)
    assert got["siddhi_tpu"]["q"]
    assert bench._rows_match(got["siddhi_tpu_torch"]["q"], got["siddhi_tpu"]["q"])


RATE_FORMS = {
    "all_expired": "from S#window.length(3) select symbol, price output all every 4 events "
                   "insert expired events into Out;",
    "first_grouped": "from S select symbol, sum(volume) as v group by symbol "
                     "output first every 7 events insert into Out;",
    "last_grouped_all": "from S#window.lengthBatch(5) select symbol, count() as c group by "
                        "symbol output last every 3 events insert all events into Out;",
    "chained": "from S select symbol, price output every 3 events insert into Mid;"
               "@info(name='q2') from Mid#window.length(2) select symbol, max(price) as m "
               "insert into Out;",
}


@pytest.mark.parametrize("case", sorted(RATE_FORMS))
def test_rate_limit_forms_match_jax(case):
    """Event-count limiters (all/first/last, grouped, EXPIRED output, a
    limited query feeding another) against the JAX package, per query."""
    ql = "define stream S (symbol string, price float, volume long);\n@info(name='q') " + \
        RATE_FORMS[case]
    got = _both(ql)
    for q, want in got["siddhi_tpu"].items():
        assert want, q
        assert bench._rows_match(got["siddhi_tpu_torch"][q], want), q


def test_rate_limit_into_table_raises():
    mgr = _port()
    with pytest.raises(SiddhiAppCreationError, match="rate limiting into a table"):
        mgr.create_siddhi_app_runtime(
            "define stream S (symbol string, price float); define table T (symbol string, "
            "price float); @info(name='q') from S select symbol, price output every 2 events "
            "insert into T;")


def test_rate_limited_query_stays_per_batch():
    """A rate-limited query keeps its junction off the fused path (its
    limiter runs on the host over decoded rows); fused = per-batch rows."""
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime(
        "@app:batch(size='32') define stream S (symbol string, price float, volume long);"
        "@info(name='q') from S select symbol output last every 5 events insert into Out;")
    rt.start()
    assert rt.junctions["S"].fused_ingest is None
    rt.shutdown()
    mgr.shutdown()


# ---------------------------------------------------------------------------
# chip_smoke's paths at small batches
# ---------------------------------------------------------------------------


def _feed(path, n, tick=1):
    data = chip_smoke.stock_data(n, seed=7)
    if path in ("FQ", "LF"):
        data["symbol"] = chip_smoke.zipf_symbols(n)
    data["ts"] = (data["ts"] - data["ts"][0]) * tick + data["ts"][0]
    return data


def _run(mgr, app, data, cuts, fused=True):
    rt = mgr.create_siddhi_app_runtime(app)
    names = [f"S{i}" for i in range(1, chip_smoke.FQ_SYMBOLS + 1)]
    for s in names:
        mgr.interner.intern(s)
    rows = []
    rt.add_callback("q", _collector(rows))
    rt.start()
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    h = rt.get_input_handler("StockStream")
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi] for k in ("symbol", "price",
                                                                         "volume")}, now=0)
    fi = rt.junctions["StockStream"].fused_ingest
    n_fused = fi.batches_fused if fi is not None else 0
    rt.shutdown()
    mgr.shutdown()
    return rows, n_fused


@pytest.mark.parametrize("path", ["SW", "FQ", "LF", "FN"])
@pytest.mark.parametrize("batch", [32, 33])
def test_special_path(path, batch):
    """The path's app at a small batch: the port's fused chunks (where the
    fused path takes the query) deliver the per-batch rows, which equal the
    JAX package's per-batch rows."""
    app = chip_smoke.SPECIAL_APPS[path].format(batch=batch, every=16)
    n = 24 * batch + 5
    data = _feed(path, n)
    cuts = [0, 9 * batch + 5, n]
    want, _ = _run(siddhi_tpu.SiddhiManager(), app, data, cuts, fused=False)
    fused, n_fused = _run(_port(), app, data, cuts)
    per_batch, _ = _run(_port(), app, data, cuts, fused=False)
    assert len(want) >= 10
    assert (n_fused > 0) == (path != "FN")
    assert fused == per_batch
    assert bench._rows_match(per_batch, want)


@pytest.mark.parametrize("batch", [32, 33])
def test_cron_path(batch):
    """Path CR under @app:playback, one bucket (1 sec of 10 ms ticks) a call:
    each call's event-time advance fires the previous bucket's cron TIMER
    step first."""
    app = chip_smoke.SPECIAL_APPS["CR"].format(batch=batch)
    data = _feed("CR", 1200, tick=10)
    cuts = list(range(0, 1201, 100))
    want, _ = _run(siddhi_tpu.SiddhiManager(), app, data, cuts, fused=False)
    got, _ = _run(_port(), app, data, cuts, fused=False)
    assert len(want) >= 8 * 10
    assert bench._rows_match(got, want)


# ---------------------------------------------------------------------------
# join sides
# ---------------------------------------------------------------------------

JOIN_HEAD = "define stream S (symbol string, price float, volume long);\n" \
            "define stream S2 (symbol string, price float, volume long);\n@info(name='q') "
JOIN_FORMS = {
    "sort_side": "from S#window.sort(4, price) as a join S2#window.length(4) as b "
                 "on a.symbol == b.symbol select a.symbol as s, a.price as pa, b.price as pb "
                 "insert all events into Out;",
    "frequent_side": "from S#window.frequent(2, symbol) as a join S2#window.lengthBatch(3) as b "
                     "on a.symbol == b.symbol select a.symbol as s, b.volume as v "
                     "insert into Out;",
    "lossy_side": "from S2#window.length(5) as b join S#window.lossyFrequent(0.3, 0.1, symbol) "
                  "as a on a.symbol == b.symbol select b.symbol as s, a.price as p "
                  "insert into Out;",
    "cron_side": "from S#window.cron('*/5 * * * * ?') as a join S2#window.length(3) as b "
                 "on a.volume > b.volume select a.symbol as s1, b.symbol as s2 "
                 "insert into Out;",
}


@pytest.mark.parametrize("case", sorted(JOIN_FORMS))
def test_join_side(case):
    """A special window as a join side (its `view()` probed), the two
    streams' events interleaved, against the JAX package."""
    ts, rows = _verify_feed()
    got = {}
    for mgr in (siddhi_tpu.SiddhiManager(), _port()):
        rt = mgr.create_siddhi_app_runtime("@app:joinCapacity(size='256')\n" + JOIN_HEAD
                                           + JOIN_FORMS[case])
        out = got.setdefault(_pkg(mgr), [])
        rt.add_callback("q", _collector(out))
        rt.start()
        for i, r in enumerate(rows):
            rt.get_input_handler("S" if i % 3 else "S2").send(r, timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# ---------------------------------------------------------------------------
# JAX state carried in
# ---------------------------------------------------------------------------

CARRY = {
    "sort": "from S#window.sort(6, price, 'desc', volume) select symbol, price, count() as n "
            "insert all events into Out;",
    "frequent": "from S#window.frequent(3) select symbol, volume, count() as n "
                "insert all events into Out;",
    "lossy": "from S#window.lossyFrequent(0.2, 0.05, symbol) select symbol, count() as n "
             "insert all events into Out;",
    "rate_limited": "from S select symbol, sum(volume) as v group by symbol "
                    "output last every 7 events insert into Out;",
}


@pytest.mark.parametrize("case", sorted(CARRY))
def test_state_carry(case):
    """Run JAX over the first 48 events, carry its query state (the window's
    lanes, lane for lane) and interned strings into the port — for the rate
    limiter its held rows and count — then feed both the rest."""
    ts, rows = _verify_feed()
    ql = "@app:batch(size='16')\ndefine stream S (symbol string, price float, volume long);\n" \
         "@info(name='q') " + CARRY[case]
    jmgr, pmgr = siddhi_tpu.SiddhiManager(), _port()
    jrt = jmgr.create_siddhi_app_runtime(ql)
    jrt.start()
    jh = jrt.get_input_handler("S")
    for i in range(48):
        jh.send(rows[i], timestamp=int(ts[i]))
    tree = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    prt = pmgr.create_siddhi_app_runtime(ql)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(tree, "cpu")
    jrl = jrt.queries["q"].rate_limiter
    if jrl is not None:
        assert jrl.held
        load_rate_limiter_state(prt.queries["q"].rate_limiter, rate_limiter_state(jrl))
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    prt.start()
    ph = prt.get_input_handler("S")
    for i in range(48, 96):
        jh.send(rows[i], timestamp=int(ts[i]))
        ph.send(rows[i], timestamp=int(ts[i]))
    want_state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    got_state = state_to_numpy(prt.queries["q"].state)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"]) > 4
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(got_state, want_state)


def test_window_overflow_logged_once(caplog):
    """A cron bucket past its slots drops rows and logs JAX's warning once."""
    import siddhi_tpu_torch.core.windows as port_windows

    mgr = _port()
    defaults = port_windows.make_window.__defaults__
    port_windows.make_window.__defaults__ = (4,)
    try:
        rt = mgr.create_siddhi_app_runtime(
            "@app:playback define stream S (symbol string, price float, volume long);"
            "@info(name='q') from S#window.cron('*/1 * * * * ?') select symbol "
            "insert into Out;")
    finally:
        port_windows.make_window.__defaults__ = defaults
    rt.start()
    ts, rows = _verify_feed()
    with caplog.at_level(logging.WARNING):
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows[:20]):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
    msgs = [r.getMessage() for r in caplog.records if "window emission/key buffer" in r.getMessage()]
    assert len(msgs) == 1
    mgr.shutdown()


AGG_FORMS = {
    "sort_minmax": "from S#window.sort(4, volume) select min(price) as lo, max(price) as hi, "
                   "avg(volume) as av insert all events into Out;",
    "frequent_grouped_max": "from S#window.frequent(2, symbol) select symbol, max(price) as hi "
                            "group by symbol insert into Out;",
    "cron_grouped_minmax": "from S#window.cron('*/1 * * * * ?') select symbol, min(price) as lo, "
                           "max(volume) as hv group by symbol insert all events into Out;",
}


@pytest.mark.parametrize("case", sorted(AGG_FORMS))
def test_aggregators_downstream(case):
    """These windows set no lazy membership, so min/max take their running
    forms, reset by the cron flush's RESET row, as in the JAX package
    (under @app:playback, 40 ms apart)."""
    ts, rows = _verify_feed()
    got = _both("define stream S (symbol string, price float, volume long);\n"
                "@info(name='q') " + AGG_FORMS[case],
                feed=(np.arange(96, dtype=np.int64) * 40 + ts[0], rows), playback=True)
    assert got["siddhi_tpu"]["q"]
    assert bench._rows_match(got["siddhi_tpu_torch"]["q"], got["siddhi_tpu"]["q"])


def test_distinct_count_downstream_raises_as_jax():
    """distinctCount needs a window's membership, which these windows do not
    give: both packages raise NotImplementedError on the first step."""
    ql = ("define stream S (symbol string, price float, volume long);\n"
          "@info(name='q') from S#window.sort(3, price) select distinctCount(symbol) as d "
          "insert into Out;")
    for mgr in (siddhi_tpu.SiddhiManager(), _port()):
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        with pytest.raises(NotImplementedError, match="distinctCount requires an upstream window"):
            rt.get_input_handler("S").send(("A", 1.0, 2), timestamp=1)
        rt.shutdown()
        mgr.shutdown()
