"""Incremental aggregation end to end through both packages on the CPU: every
test of tests/test_aggregation.py and tests/test_golden_aggregation_ref.py
under its own assertions with the port's SiddhiManager swapped in (and,
for the `@store` restart test, the port's record store); chip_smoke.py's AGG and
AGJ paths at a small size against the JAX package (the stores, the duration
tables, the store queries and the joined rows); JAX's stores and tables
carried into the port, then more batches through both; the refusals the JAX
package makes, with its class and message; and the four closes a step a
duration spills, shown in both packages. Floats match to a relative 2e-4
(bench.py:_rows_match), the stores and tables bit for bit; everything else
exactly.
"""

import importlib
import inspect

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
from siddhi_tpu_torch.interop import (  # noqa: E402
    aggregation_state_from_jax,
    interned_values,
    load_interned,
    state_from_numpy,
    state_to_numpy,
)

BASE_TS = 1_496_289_720_000


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _managers():
    return siddhi_tpu.SiddhiManager(), _port()


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _bits_equal(got, want, where):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=where)


# ---------------------------------------------------------------------------
# the JAX package's aggregation tests, on the port
# ---------------------------------------------------------------------------

MODULES = ("tests.test_aggregation", "tests.test_golden_aggregation_ref")
# @store on an aggregation (its restart rebuild reads the stored tables):
# run with the port's record store in the JAX module's place
RECORD_STORE_TESTS = {"test_store_backed_restart_rebuilds_inflight"}


def _cases():
    cases = []
    for modname in MODULES:
        mod = importlib.import_module(modname)
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("Test") and inspect.isclass(obj):
                cases += [(modname, name, m) for m in sorted(vars(obj)) if m.startswith("test")]
            elif name.startswith("test_") and inspect.isfunction(obj):
                cases.append((modname, None, name))
    return cases


def test_every_aggregation_test_is_covered():
    names = {c[2] for c in _cases()}
    assert RECORD_STORE_TESTS <= names and len(names) == 23


@pytest.mark.parametrize("modname,cname,fname", _cases())
def test_jax_aggregation_test_on_the_port(modname, cname, fname, monkeypatch):
    """The test itself with every SiddhiManager it makes the port's: its own
    assertions hold the port's rows."""
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, "SiddhiManager", _port)
    monkeypatch.setattr(siddhi_tpu, "SiddhiManager", _port)  # in-test imports
    if fname in RECORD_STORE_TESTS:
        import siddhi_tpu.core.record_table as jax_records

        import siddhi_tpu_torch.core.record_table as port_records

        monkeypatch.setattr(jax_records, "InMemoryRecordStore", port_records.InMemoryRecordStore)
    fn = getattr(mod, fname) if cname is None else getattr(getattr(mod, cname)(), fname)
    fn()


# ---------------------------------------------------------------------------
# paths AGG and AGJ at a small size
# ---------------------------------------------------------------------------


def _agg_run(mgr, b: int, batches: int, probe_calls: int, probes_per_call: int, symbols: int):
    """chip_smoke's AGG app at batch b with 64 groups: `batches` calls of
    one batch to S, the store queries, then the probe calls."""
    data, names = chip_smoke.agg_data(batches * b, per_ms=2)
    data["symbol"] = (data["symbol"] % symbols + 1).astype(np.int32)
    rt = mgr.create_siddhi_app_runtime(chip_smoke.agg_app(batch=b, groups=64))
    calls = []
    rt.add_callback("q", lambda t, ins, rem: calls[-1].extend(tuple(e.data) for e in ins or []))
    rt.start()
    hs, hp = rt.get_input_handler("S"), rt.get_input_handler("Probe")
    for c in range(batches):
        lo, hi = c * b, (c + 1) * b
        hs.send_many([(names[data["symbol"][i] - 1], float(data["price"][i]),
                       int(data["volume"][i]), int(data["agg_ts"][i])) for i in range(lo, hi)],
                      timestamps=[int(x) for x in data["ts"][lo:hi]])
    queries = [[tuple(e.data) for e in rt.query(q.format(lo=chip_smoke.AGG_HOUR,
                                                        hi=chip_smoke.AGG_HOUR + 3_600_000))]
               for q in chip_smoke.AGG_QUERIES]
    rng = np.random.default_rng(9)
    t0 = int(data["ts"][-1]) + 1
    for c in range(probe_calls):
        calls.append([])
        hp.send_many(
            [(names[int(s) - 1],) for s in rng.integers(1, symbols + 1, probes_per_call)],
            timestamps=list(range(t0 + c * probes_per_call, t0 + (c + 1) * probes_per_call)))
    agg = rt.aggregations["TradeAgg"]
    state = (aggregation_state_from_jax(jax.tree_util.tree_map(np.asarray, agg.state), "cpu")
             if _pkg(mgr) == "siddhi_tpu" else agg.state)
    tables = {t.table_id: jax.tree_util.tree_map(np.asarray, t.state)
              for t in agg.tables.values()}
    rt.shutdown()
    mgr.shutdown()
    return {"queries": queries, "calls": calls, "state": state_to_numpy(state),
            "tables": tables}


@pytest.mark.parametrize("b,batches", [(64, 3), (33, 4)])
def test_agg_and_agj_paths_match_jax(b, batches):
    """AGG's ingest (every base, sec ... year, 2 events a millisecond: a
    batch crosses one or more seconds), its two store queries, then AGJ's
    probe calls joining `within .. per 'sec'` on symbol."""
    got = {_pkg(m): _agg_run(m, b, batches, 2, 16, 12) for m in _managers()}
    want, have = got["siddhi_tpu"], got["siddhi_tpu_torch"]
    assert all(want["queries"]) and sum(len(c) for c in want["calls"]) > 16
    _bits_equal(have["state"], want["state"], "stores")
    _bits_equal(have["tables"], want["tables"], "tables")
    assert bench._rows_match(have["queries"], want["queries"])
    assert bench._rows_match(have["calls"], want["calls"])


# ---------------------------------------------------------------------------
# JAX state carried in, refusals, the spill limit
# ---------------------------------------------------------------------------

APP = """@app:aggGroupCapacity(size='16')
define stream S (symbol string, price float, volume long, ts long);
define aggregation A from S select symbol, avg(price) as ap, sum(volume) as t,
min(price) as lo, max(price) as hi, count() as n group by symbol
aggregate by ts every sec ... day;
"""


def _rows(n, seed, t0, step):
    rng = np.random.default_rng(seed)
    ts = t0 + np.cumsum(rng.integers(0, step, n))
    return [(["WSO2", "IBM", "GOOG", "MSFT", "ORCL"][int(rng.integers(0, 5))],
             float(np.float32(rng.uniform(0, 100))), int(rng.integers(1, 1000)), int(t))
            for t in ts]


def test_jax_state_carried_in():
    """Four batches through JAX; its stores, duration tables and interned
    strings into the port; four more through both: equal stores, tables
    and finds."""
    rows = _rows(128, 5, BASE_TS, 400)
    jmgr, pmgr = _managers()
    jrt, prt = jmgr.create_siddhi_app_runtime(APP), pmgr.create_siddhi_app_runtime(APP)
    jrt.start()
    prt.start()
    jh, ph = jrt.get_input_handler("S"), prt.get_input_handler("S")
    for lo in range(0, 64, 16):
        jh.send_many(rows[lo:lo + 16], timestamps=[r[3] for r in rows[lo:lo + 16]])
    ja, pa = jrt.aggregations["A"], prt.aggregations["A"]
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    pa.state = aggregation_state_from_jax(jax.tree_util.tree_map(np.asarray, ja.state), "cpu")
    for d, t in ja.tables.items():
        pt = next(x for x in pa.tables.values() if x.table_id == t.table_id)
        pt.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, t.state), "cpu")
    for lo in range(64, 128, 16):
        for h in (jh, ph):
            h.send_many(rows[lo:lo + 16], timestamps=[r[3] for r in rows[lo:lo + 16]])
    _bits_equal(state_to_numpy(pa.state),
                state_to_numpy(aggregation_state_from_jax(
                    jax.tree_util.tree_map(np.asarray, ja.state), "cpu")), "stores")
    for t in ja.tables.values():
        pt = next(x for x in pa.tables.values() if x.table_id == t.table_id)
        _bits_equal(state_to_numpy(pt.state), jax.tree_util.tree_map(np.asarray, t.state),
                    t.table_id)
    assert int(np.asarray(ja.tables[next(iter(ja.tables))].state["valid"]).sum()) > 5
    for per in ("sec", "min", "hour", "day"):
        q = f"from A per '{per}' select AGG_TIMESTAMP, symbol, ap, t, lo, hi, n"
        assert bench._rows_match([tuple(e.data) for e in prt.query(q)],
                                 [tuple(e.data) for e in jrt.query(q)])
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()


HEAD = "define stream S (symbol string, price float, volume long, ts long);\n"
REFUSED_APPS = [
    "define aggregation A from S#window.length(5) select symbol, sum(price) as t "
    "group by symbol aggregate by ts every sec ... min;",
    "define aggregation A from S select symbol, sum(symbol) as t group by symbol "
    "aggregate by ts every sec ... min;",
    "define aggregation A from S select symbol, stdDev(price) as t group by symbol "
    "aggregate by ts every sec ... min;",
    "define aggregation A from S select symbol, sum(price) as t group by symbol "
    "aggregate by symbol every sec ... min;",
    "define aggregation A from S select symbol, sum(price) as t group by symbol "
    "aggregate by ts every sec ... min; define stream P (symbol string); "
    "from P join A on P.symbol == A.symbol select P.symbol insert into Out;",
    "define aggregation A from S select symbol, sum(price) as t group by symbol "
    "aggregate by ts every sec ... min; define stream P (symbol string); "
    "from P join A on P.symbol == A.symbol within 1000L, 9000L per 'hour' "
    "select P.symbol insert into Out;",
]
REFUSED_QUERIES = [
    "from A select symbol, t",
    "from A within 1000L, 500L per 'sec' select symbol, t",
    "from A per 'day' select symbol, t",
    "from A within \"2017-06-** 12:**:**\" per 'sec' select symbol, t",
    "from A per 'fortnight' select symbol, t",
]


def _refusal(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("body", REFUSED_APPS)
def test_refused_apps_as_jax(body):
    msgs = {_pkg(m): _refusal(lambda _m=m: _m.create_siddhi_app_runtime(HEAD + body))
            for m in _managers()}
    assert msgs["siddhi_tpu_torch"] == msgs["siddhi_tpu"]


@pytest.mark.parametrize("q", REFUSED_QUERIES)
def test_refused_store_queries_as_jax(q):
    msgs = {}
    for m in _managers():
        rt = m.create_siddhi_app_runtime(
            HEAD + "define aggregation A from S select symbol, sum(price) as t group by symbol "
            "aggregate by ts every sec ... hour;")
        msgs[_pkg(m)] = _refusal(lambda _rt=rt: _rt.query(q))
        rt.shutdown()
    assert msgs["siddhi_tpu_torch"] == msgs["siddhi_tpu"]


def test_four_spills_a_step_in_both():
    """One batch over six seconds closes five finest buckets: the fifth is
    rolled up into the minute but never reaches the seconds table, in both
    packages (the JAX package's SPILLS_PER_BATCH; the flag is set and
    nothing reads it)."""
    app = "@app:batch(size='64')\n" + HEAD + (
        "define aggregation A from S select symbol, sum(volume) as t, count() as n "
        "group by symbol aggregate by ts every sec, min;")
    rows = [("WSO2", 1.0, 1, BASE_TS + 1000 * s + 10 * i) for s in range(6) for i in range(4)]
    got = {}
    for m in _managers():
        rt = m.create_siddhi_app_runtime(app)
        rt.start()
        rt.get_input_handler("S").send_many(rows, timestamps=[r[3] for r in rows])
        got[_pkg(m)] = (sorted(tuple(e.data) for e in rt.query(
                            "from A per 'sec' select AGG_TIMESTAMP, t, n")),
                        sorted(tuple(e.data) for e in rt.query(
                            "from A per 'min' select AGG_TIMESTAMP, t, n")))
        rt.shutdown()
    assert got["siddhi_tpu_torch"] == got["siddhi_tpu"]
    secs, mins = got["siddhi_tpu"]
    # seconds 0-3 spilled, second 4 lost, second 5 in flight
    assert [r[0] - BASE_TS for r in secs] == [0, 1000, 2000, 3000, 5000]
    assert mins == [(BASE_TS - BASE_TS % 60_000, 24, 24)]
