"""The group-by slice end to end through both packages, live, on the CPU: the
same SiddhiQL app and the same events go through `siddhi_tpu` (JAX) and
`siddhi_tpu_torch` (device="cpu"), and the delivered rows must match in
order — group-by with sum/count/avg, lengthBatch, having, order-by,
limit/offset and `@app:groupCapacity`. Floats match to a relative 2e-4
(bench.py:_rows_match); everything else exactly.
"""

import logging

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    state_from_numpy,
    state_to_numpy,
)


def _collector(rows: list):
    return lambda t, ins, rem: rows.extend(
        [("+",) + tuple(e.data) for e in (ins or [])]
        + [("-",) + tuple(e.data) for e in (rem or [])]
    )


def _managers():
    return siddhi_tpu.SiddhiManager(), siddhi_tpu_torch.SiddhiManager(device="cpu")


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


@pytest.mark.parametrize("case", ["len_batch_group", "having_order"])
def test_verify_case(case):
    """bench.py's verify cases over the 96-event feed of _leg_verify, one
    event per send."""
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
            for _ in range(96)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_CASES[case])
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) > 30
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


TUMBLING = """
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from StockStream#window.lengthBatch({n})
select symbol, sum(volume) as total, avg(price) as ap
group by symbol
insert {events}into Out;
"""


def _send_stock(rt, mgr, data, lo, hi, fused=True):
    for s in data["names"]:
        mgr.interner.intern(str(s))
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    cols = {k: data[k][lo:hi] for k in ("symbol", "price", "volume")}
    rt.get_input_handler("StockStream").send_columns(data["ts"][lo:hi], cols, now=0)


@pytest.mark.parametrize("batch", [32, 33, 4096])
def test_tumbling_groupby(batch):
    """BASELINE.json config 2 (bench.py's tumbling_groupby app) via
    send_columns: buckets that span batches and sends, a ragged last batch."""
    n = 3 * 1024 + 77
    data = bench._make_stock_data(n, seed=7)
    app = TUMBLING.format(batch=batch, n=1024, events="")
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(app)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        cut = n // 3
        _send_stock(rt, mgr, data, 0, cut)
        _send_stock(rt, mgr, data, cut, n)
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) == 3 * 8
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("events", ["", "all events "])
@pytest.mark.parametrize("n_events", [2 * 64 + 1, 5 * 64, 33 * 64 + 7])
def test_fused_equals_per_batch(events, n_events):
    """The port's fused chunk loop (K tails, and the EXPIRED lanes on with
    `insert all events`) delivers the per-batch path's rows, which equal the
    JAX engine's."""
    data = bench._make_stock_data(n_events, seed=3)
    app = TUMBLING.format(batch=64, n=50, events=events)
    got = {}
    for label, fused in (("fused", True), ("per_batch", False)):
        mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
        rt = mgr.create_siddhi_app_runtime(app)
        rt.add_callback("q", _collector(got.setdefault(label, [])))
        rt.start()
        _send_stock(rt, mgr, data, 0, n_events, fused=fused)
        fi = rt.junctions["StockStream"].fused_ingest
        assert (fi is not None and fi.batches_fused > 0) == fused
        rt.shutdown()
    jmgr = siddhi_tpu.SiddhiManager()
    jrt = jmgr.create_siddhi_app_runtime(app)
    jrt.add_callback("q", _collector(got.setdefault("jax", [])))
    jrt.start()
    _send_stock(jrt, jmgr, data, 0, n_events)
    jrt.shutdown()
    assert len(got["jax"]) > 8
    assert got["fused"] == got["per_batch"]
    assert bench._rows_match(got["fused"], got["jax"])


def test_state_carry():
    """Run JAX for 3 batches, carry its query state (group table, [G]
    aggregator carries, lengthBatch buffers) and its interned strings into
    the port, then feed both the same next 3 batches."""
    batch = 32
    app = TUMBLING.format(batch=batch, n=50, events="all events ")
    data = bench._make_stock_data(6 * batch, seed=11)
    jmgr, pmgr = _managers()
    jrt = jmgr.create_siddhi_app_runtime(app)
    jrt.start()
    _send_stock(jrt, jmgr, data, 0, 3 * batch, fused=False)
    tree = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    assert int(tree["chain"]["cur_n"]) > 0 and int(tree["sel"]["group"]["n"]) > 0

    prt = pmgr.create_siddhi_app_runtime(app)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(tree, "cpu")
    np.testing.assert_equal(state_to_numpy(prt.queries["q"].state), tree)
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    prt.start()
    _send_stock(jrt, jmgr, data, 3 * batch, 6 * batch, fused=False)
    _send_stock(prt, pmgr, data, 3 * batch, 6 * batch, fused=False)
    want_state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    got_state = state_to_numpy(prt.queries["q"].state)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"]) > 8
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(got_state["chain"], want_state["chain"])
    np.testing.assert_equal(got_state["sel"]["group"], want_state["sel"]["group"])


# ---------------------------------------------------------------------------
# every tests/test_groupby.py app the slice covers, through both packages
# ---------------------------------------------------------------------------

GROUPBY_APPS = {
    "running_sum_no_window": (
        "define stream S (symbol string, price float, volume long);"
        "@info(name='q1') from S select symbol, sum(volume) as total group by symbol "
        "insert into Out;",
        [("one", ("IBM", 10.0, 5)), ("one", ("WSO2", 10.0, 7)), ("one", ("IBM", 10.0, 2)),
         ("one", ("WSO2", 10.0, 1))]),
    "carry_across_batches": (
        "define stream S (k int, v int);"
        "@info(name='q1') from S select k, sum(v) as s, count() as c group by k insert into Out;",
        [("one", (1, 10)), ("one", (2, 100)), ("one", (1, 5)), ("one", (2, 50)), ("one", (3, 1))]),
    "length_window_expiry": (
        "define stream S (sym string, v long);"
        "@info(name='q1') from S#window.length(2) select sym, sum(v) as s group by sym "
        "insert into Out;",
        [("one", ("A", 1)), ("one", ("A", 2)), ("one", ("B", 10)), ("one", ("B", 20))]),
    "lengthbatch_one_per_key": (
        "define stream S (sym string, v long);"
        "@info(name='q1') from S#window.lengthBatch(4) select sym, sum(v) as s group by sym "
        "insert into Out;",
        [("many", [("A", 1), ("B", 10), ("A", 2), ("B", 20)]),
         ("many", [("A", 7), ("A", 1), ("C", 5), ("B", 2)])]),
    "composite_key": (
        "define stream S (sym string, region string, v long);"
        "@info(name='q1') from S select sym, region, sum(v) as s group by sym, region "
        "insert into Out;",
        [("one", ("A", "us", 1)), ("one", ("A", "eu", 10)), ("one", ("A", "us", 2))]),
    "having": (
        "define stream S (sym string, v long);"
        "@info(name='q1') from S select sym, sum(v) as s group by sym having s > 10 "
        "insert into Out;",
        [("one", ("A", 5)), ("one", ("A", 6)), ("one", ("B", 3))]),
    "order_by_desc_limit": (
        "define stream S (sym string, p float, v long);"
        "@info(name='q1') from S#window.lengthBatch(4) select sym, p order by p desc limit 2 "
        "insert into Out;",
        [("many", [("A", 10.0, 1), ("B", 40.0, 1), ("C", 20.0, 1), ("D", 30.0, 1)])]),
    "order_by_two_keys": (
        "define stream S (g int, p float);"
        "@info(name='q1') from S#window.lengthBatch(4) select g, p order by g, p desc "
        "insert into Out;",
        [("many", [(2, 1.0), (1, 5.0), (2, 9.0), (1, 7.0)])]),
    "limit_offset": (
        "define stream S (v int);"
        "@info(name='q1') from S#window.lengthBatch(5) select v limit 2 offset 1 insert into Out;",
        [("many", [(1,), (2,), (3,), (4,), (5,)])]),
    "capacity_bucket_reset": (
        "@app:groupCapacity(size='4') define stream S (k int, v long);"
        "@info(name='q1') from S#window.lengthBatch(3) select k, sum(v) as s group by k "
        "insert into Out;",
        [("many", [(1, 1), (2, 2), (1, 3)]), ("many", [(3, 5), (4, 6), (5, 7)]),
         ("many", [(6, 8), (7, 9), (6, 1)])]),
    "overflow": (
        "@app:groupCapacity(size='2') define stream S (k int, v long);"
        "@info(name='q1') from S select k, sum(v) as s group by k insert into Out;",
        [("one", (1, 10)), ("one", (2, 20)), ("one", (3, 30)), ("one", (1, 5))]),
}


@pytest.mark.parametrize("case", sorted(GROUPBY_APPS))
def test_groupby_app(case, caplog):
    ql, sends = GROUPBY_APPS[case]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.add_callback("q1", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        with caplog.at_level(logging.ERROR):
            for how, arg in sends:
                if how == "one":
                    h.send(arg)
                else:
                    h.send_many(arg)
            for qr in rt.queries.values():
                qr.flush_aux_warnings()
        mgr.shutdown()
        if case == "overflow" and _pkg(mgr) == "siddhi_tpu_torch":
            assert any("overflow" in r.message and "siddhi_tpu_torch" in r.name
                       for r in caplog.records)
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
    if case == "overflow":
        assert got["siddhi_tpu_torch"][2:] == [("+", 3, 30), ("+", 1, 15)]


@pytest.mark.parametrize("read_by", ["flush", "shutdown"])
def test_overflow_logged_once_off_the_dispatch_path(read_by, caplog):
    """The overflow flag is read back without a sync per batch: it is logged
    once, whether it surfaces through the non-blocking poll, a flush or the
    app's shutdown."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(GROUPBY_APPS["overflow"][0])
    rt.start()
    h = rt.get_input_handler("S")
    with caplog.at_level(logging.ERROR):
        for k in range(6):
            h.send((k, 1))
        if read_by == "flush":
            rt.queries["q1"].flush_aux_warnings()
        mgr.shutdown()
    assert sum("overflow" in r.message for r in caplog.records) == 1


# ---------------------------------------------------------------------------
# the lengthBatch goldens (tests/test_golden_windows_ref.py:101-160)
# ---------------------------------------------------------------------------

CSE = "define stream cseEventStream (symbol string, price float, volume int);\n"
SIX = [("IBM", 10.0, 0), ("WSO2", 20.0, 1), ("IBM", 30.0, 0), ("WSO2", 40.0, 1),
       ("IBM", 50.0, 0), ("WSO2", 60.0, 1)]
LENGTH_BATCH_GOLDENS = {
    "underfull_silent": ("from cseEventStream#window.lengthBatch(4) select symbol,price,volume "
                         "insert into outputStream ;",
                         [("IBM", 700.0, 0), ("WSO2", 60.5, 1)]),
    "flush_in_order": ("from cseEventStream#window.lengthBatch(4) select symbol,price,volume "
                       "insert into outputStream ;",
                       [("IBM", 700.0, i + 1) for i in range(6)]),
    "all_events_expired": ("from cseEventStream#window.lengthBatch(2) "
                           "select symbol,price,volume insert all events into outputStream ;",
                           [("IBM", 700.0, i + 1) for i in range(6)]),
    "aggregated_single_row": ("from cseEventStream#window.lengthBatch(4) select symbol,"
                              "sum(price) as sumPrice,volume insert into outputStream ;", SIX),
    "expired_only": ("from cseEventStream#window.lengthBatch(2) select symbol,price,volume "
                     "insert expired events into outputStream ;",
                     [("IBM", 700.0, i + 1) for i in range(6)]),
    "aggregated_all_events": ("from cseEventStream#window.lengthBatch(4) select symbol,"
                              "sum(price) as sumPrice,volume insert all events into "
                              "outputStream ;",
                              SIX + [("WSO2", 60.0, 1), ("IBM", 70.0, 0), ("WSO2", 80.0, 1)]),
}


@pytest.mark.parametrize("case", sorted(LENGTH_BATCH_GOLDENS))
def test_length_batch_golden(case):
    """Each delivery (its CURRENT and its EXPIRED rows) equal, one event per
    send as the golden harness sends them."""
    ql, rows = LENGTH_BATCH_GOLDENS[case]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(CSE + "@info(name = 'query1') " + ql)
        out = got.setdefault(_pkg(mgr), [])
        rt.add_callback("query1", lambda t, ins, rem, _o=out: _o.append(
            ([tuple(e.data) for e in ins or []], [tuple(e.data) for e in rem or []])))
        rt.start()
        h = rt.get_input_handler("cseEventStream")
        for r in rows:
            h.send(r)
        rt.shutdown()
        mgr.shutdown()
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
    if case == "aggregated_all_events":
        assert [r[1] for d in got["siddhi_tpu_torch"] for r in d[0]] == [100.0, 240.0]


SLICE7_APPS = [
    # grouped windowed min/max (test_groupby.py::test_groupby_avg_min_max_with_window)
    "from S#window.length(3) select symbol, avg(price) as a, min(price) as lo, "
    "max(price) as hi group by symbol insert into Out;",
    "from S#window.lengthBatch(4) select symbol, max(price) as hi group by symbol "
    "insert into Out;",
    # unwindowed and forever grouped min/max
    "from S select symbol, min(price) as lo group by symbol insert into Out;",
    "from S#window.lengthBatch(4) select symbol, maxForever(price) as hi group by symbol "
    "insert into Out;",
    # the time-driven batch windows
    "from S#window.timeBatch(100) select symbol, sum(volume) as t group by symbol "
    "insert into Out;",
    "from S#window.externalTimeBatch(volume, 1 sec) select symbol insert into Out;",
]


# the forms test_outside_the_slice_raises held to "not ported yet" until the
# aggregation slice: a lossyFrequent window inside a partition and an
# aggregation beside a query
SLICE14_APPS = [
    "partition with (symbol of S) begin from S#window.lossyFrequent(0.1, 0.01, symbol) "
    "select symbol, sum(volume) as t group by symbol insert into Out; end;",
    "define aggregation A from S select symbol, sum(price) as t group by symbol "
    "aggregate every sec ... min; from S select symbol insert into Out;",
]


@pytest.mark.parametrize("ql", SLICE14_APPS)
def test_slice14_forms_match_jax(ql):
    """Each app's rows against the JAX package's, and the aggregation's
    store query too (per 'sec' and per 'min', under @app:playback)."""
    rng = np.random.default_rng(14)
    rows = [(["A", "B", "C"][int(rng.integers(0, 3))], float(np.round(rng.uniform(0, 100), 3)),
             int(rng.integers(1, 4000))) for _ in range(60)]
    ts = [1_700_000_000_000 + 97 * i for i in range(60)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        out = got.setdefault(_pkg(mgr), [])
        rt.add_callback("Out", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        h.send_many(rows[:20], timestamps=ts[:20])
        for r, t in zip(rows[20:], ts[20:]):
            h.send(r, timestamp=t)
        if "aggregation" in ql:
            for per in ("sec", "min"):
                out.append(sorted(tuple(e.data) for e in rt.query(
                    f"from A per '{per}' select AGG_TIMESTAMP, symbol, t")))
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) > 10
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# the forms test_outside_the_slice_raises held to "not ported yet" until the
# named-window slice: a named window (with a grouped reader), a trigger
# (joined to a window of S) and a @store table
SLICE15_APPS = [
    "define window W (symbol string, price float) length(5); "
    "from S select symbol, price insert into W; "
    "from W select symbol, sum(price) as t group by symbol insert into Out;",
    "define trigger T at every 5 sec; from S select symbol insert into Out; "
    "from T join S#window.length(3) as s select s.symbol as symbol insert into Out;",
    "@store(type='memory', store.id='g1') define table T (symbol string, price float); "
    "from S select symbol, price insert into T; from S select symbol insert into Out;",
]


@pytest.mark.parametrize("ql", SLICE15_APPS)
def test_slice15_forms_match_jax(ql):
    """Each app's rows against the JAX package's under @app:playback from
    event time 1, 97 ms apart (the trigger fires every 5 s), and for the
    @store table its rows by a store query and the snapshot its record
    store holds after shutdown."""
    import siddhi_tpu.core.record_table as jax_records

    import siddhi_tpu_torch.core.record_table as port_records

    rng = np.random.default_rng(15)
    rows = [(["A", "B", "C"][int(rng.integers(0, 3))], float(np.round(rng.uniform(0, 100), 3)),
             int(rng.integers(1, 4000))) for _ in range(60)]
    ts = [1 + 97 * i for i in range(60)]
    got = {}
    for mgr, records in zip(_managers(), (jax_records, port_records)):
        records.InMemoryRecordStore.clear_all()
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        out = got.setdefault(_pkg(mgr), [])
        rt.add_callback("Out", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        h.send_many(rows[:20], timestamps=ts[:20])
        for r, t in zip(rows[20:], ts[20:]):
            h.send(r, timestamp=t)
        if "@store" in ql:
            out.append([tuple(e.data) for e in rt.query("from T select symbol, price")])
        rt.shutdown()
        mgr.shutdown()
        if "@store" in ql:
            out.append(records.InMemoryRecordStore._data["g1"])
            records.InMemoryRecordStore.clear_all()
    assert len(got["siddhi_tpu"]) > 10
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "@OnError(action='LOG') define table T (symbol string); "
    "from S select symbol insert into T;",
])
def test_outside_the_slice_raises(ql):
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)


@pytest.mark.parametrize("ql", SLICE7_APPS)
def test_forms_that_raised_match_jax(ql):
    """The forms test_outside_the_slice_raises held to "not ported yet"
    until the time-batch slice, against the JAX package (under
    @app:playback, one event per send after a send_many)."""
    rng = np.random.default_rng(12)
    rows = [(["A", "B", "C"][int(rng.integers(0, 3))], float(np.round(rng.uniform(0, 100), 3)),
             int(rng.integers(1, 4000))) for _ in range(60)]
    ts = [1_700_000_000_000 + 9 * i for i in range(60)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        rt.add_callback("Out", lambda evs, _o=got.setdefault(_pkg(mgr), []): _o.extend(
            tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        h.send_many(rows[:20], timestamps=ts[:20])
        for r, t in zip(rows[20:], ts[20:]):
            h.send(r, timestamp=t)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


SLICE9_APPS = [
    "from S#window.sort(5, price) select symbol, sum(volume) as t group by symbol "
    "insert into Out;",
    "from S#window.frequent(3, symbol) select symbol insert into Out;",
    "from S#window.lossyFrequent(0.1, 0.01) select symbol insert into Out;",
    "from S#window.cron('*/1 * * * * ?') select symbol insert into Out;",
    "from S#pol2Cart(price, price) select symbol insert into Out;",
]


@pytest.mark.parametrize("ql", SLICE9_APPS)
def test_slice9_forms_match_jax(ql):
    """The forms test_outside_the_slice_raises held to "not ported yet" until
    the special-window slice, against the JAX package (under @app:playback,
    one event per send, 30 ms apart, after a send_many)."""
    rng = np.random.default_rng(12)
    rows = [(["A", "B", "C"][int(rng.integers(0, 3))], float(np.round(rng.uniform(0, 100), 3)),
             int(rng.integers(1, 4000))) for _ in range(90)]
    ts = [1_700_000_000_000 + 30 * i for i in range(90)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        rt.add_callback("Out", lambda evs, _o=got.setdefault(_pkg(mgr), []): _o.extend(
            tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        h.send_many(rows[:20], timestamps=ts[:20])
        for r, t in zip(rows[20:], ts[20:]):
            h.send(r, timestamp=t)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_ungrouped_minmax_under_length_batch():
    """Ungrouped min/max after lengthBatch runs the windowed-extreme kernel
    over the lazy membership the lengthBatch step hands on; the collapse
    keeps one row per flush."""
    ql = ("@info(name='q') from S#window.lengthBatch(5) select min(price) as mn, "
          "max(price) as mx, avg(price) as ap insert all events into Out;")
    rng = np.random.default_rng(4)
    rows = [("A", float(np.round(rng.uniform(0, 100), 3)), int(rng.integers(1, 9)))
            for _ in range(40)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        h.send_many(rows[:17])
        for r in rows[17:]:
            h.send(r)
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) >= 8
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
