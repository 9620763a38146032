"""The slice end to end through both packages, live, on the CPU: the same
SiddhiQL app and the same events go through `siddhi_tpu` (JAX) and
`siddhi_tpu_torch` (device="cpu"), and the delivered rows must match in order.
Floats match to a relative 2e-4 (bench.py:_rows_match); everything else
exactly.
"""

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

SLICE_CASES = [
    "filter_num", "filter_str", "arith_promote", "builtins",
    "len_window_avg", "len_window_minmax",
]


def _verify_feed():
    """The 96-event feed of bench.py:_leg_verify."""
    rng = np.random.default_rng(99)
    n = 96
    ts = np.arange(n, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [
        (
            ["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
            float(np.round(rng.uniform(0.0, 100.0), 3)),
            int(rng.integers(1, 1000)),
        )
        for _ in range(n)
    ]
    return ts, rows


def _collector(rows: list):
    return lambda t, ins, rem: rows.extend(
        [("+",) + tuple(e.data) for e in (ins or [])]
        + [("-",) + tuple(e.data) for e in (rem or [])]
    )


def _managers():
    return siddhi_tpu.SiddhiManager(), siddhi_tpu_torch.SiddhiManager(device="cpu")


@pytest.mark.parametrize("case", SLICE_CASES)
def test_verify_case(case):
    ts, rows = _verify_feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_CASES[case])
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("q", _collector(out))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"], case
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"]), case


MAIN_APP = """
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from StockStream[price > 50]#window.length(50)
select symbol, avg(price) as ap{extra}
insert into Out;
"""


def _send_stock(rt, mgr, data, lo, hi):
    for s in data["names"]:
        mgr.interner.intern(str(s))
    cols = {k: data[k][lo:hi] for k in ("symbol", "price", "volume")}
    rt.get_input_handler("StockStream").send_columns(data["ts"][lo:hi], cols, now=0)


@pytest.mark.parametrize("batch", [32, 33, 4096])
def test_filter_window_avg(batch):
    """BASELINE.json config 1 via send_columns: ragged last batch, several
    sends that do not align with the batch size."""
    n = 2 * batch + batch // 2 + 7
    data = bench._make_stock_data(n, seed=7)
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(MAIN_APP.format(batch=batch, extra=""))
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("q", _collector(out))
        rt.start()
        cut = n // 3
        _send_stock(rt, mgr, data, 0, cut)
        _send_stock(rt, mgr, data, cut, n)
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) > batch // 2
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_state_carry():
    """Run JAX for 3 batches, carry its query state and its interned strings
    into the port, then feed both the same next 3 batches."""
    batch = 32
    app = MAIN_APP.format(
        batch=batch, extra=", sum(volume) as sv, count() as c, min(price) as mn, "
        "max(volume) as mx"
    )
    data = bench._make_stock_data(6 * batch, seed=7)
    jmgr, pmgr = _managers()
    jrt = jmgr.create_siddhi_app_runtime(app)
    jrt.start()
    _send_stock(jrt, jmgr, data, 0, 3 * batch)
    tree = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)

    prt = pmgr.create_siddhi_app_runtime(app)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(tree, "cpu")
    np.testing.assert_equal(state_to_numpy(prt.queries["q"].state), tree)
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    prt.start()
    _send_stock(jrt, jmgr, data, 3 * batch, 6 * batch)
    _send_stock(prt, pmgr, data, 3 * batch, 6 * batch)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"]) > batch
    assert bench._rows_match(got["port"], got["jax"])


def test_insert_into_chains_queries():
    """A second query reads the first one's output stream."""
    app = bench.VERIFY_HEAD + (
        "@info(name='q1') from S[price > 20] select symbol, price insert into Mid;"
        "@info(name='q') from Mid#window.length(3) select symbol, max(price) as mx "
        "insert into Out;"
    )
    ts, rows = _verify_feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(app)
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("Out", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        rt.get_input_handler("S").send_many(rows[:40], timestamps=[int(t) for t in ts[:40]])
        rt.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "@source(type='inMemory', topic='t') define stream S9 (a int); "
    "from S select symbol insert into O;",
])
def test_unported_features_raise(ql):
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)


@pytest.mark.parametrize("ql", [
    "define window W (symbol string, price float) length(5); "
    "from S select symbol, price insert into W; from W select symbol, price insert into O;",
    "define trigger T at every 5 sec; from S select symbol insert into O; "
    "from T join S#window.length(2) as s select s.symbol as symbol insert into O;",
])
def test_slice15_forms_match_jax(ql):
    """The named window and the trigger test_unported_features_raise held
    to "not ported yet" until the named-window slice (each given a reader
    into O), against the JAX package: under @app:playback from event time
    1, one event per send, 70 ms apart, so the trigger fires every 5 s."""
    _ts, rows = _verify_feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("O", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=1 + 70 * i)
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) >= 96
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "partition with (symbol of S) begin from S#window.cron('*/1 * * * * ?') select symbol, "
    "price insert into O; end;",
])
def test_slice14_forms_match_jax(ql):
    """The partitioned cron window test_unported_features_raise held to "not
    ported yet" until the aggregation slice, against the JAX package: under
    @app:playback, one event per send, 40 ms apart, each fire reaching
    every partition."""
    _ts, rows = _verify_feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("O", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=1_700_000_000_000 + 40 * i)
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) > 40
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "from S#window.sort(5, price) select symbol insert into O;",
    "from S#window.frequent(3, symbol) select symbol insert into O;",
    "from S#window.cron('*/1 * * * * ?') select symbol insert into O;",
    "from S#pol2Cart(price, price) select symbol insert into O;",
])
def test_slice9_forms_match_jax(ql):
    """The forms test_unported_features_raise held to "not ported yet" until
    the special-window slice, against the JAX package: under @app:playback,
    one event per send, 40 ms apart (so the cron window fires)."""
    _ts, rows = _verify_feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("O", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=1_700_000_000_000 + 40 * i)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "from S#window.timeBatch(10) select symbol insert into O;",
    "from S select symbol, min(price) as t group by symbol insert into O;",
    "from S select min(price) as m insert into O;",
    "from S select stdDev(price) as m insert into O;",
])
def test_forms_that_raised_match_jax(ql):
    """The forms this test file held to "not ported yet" until the
    time-batch slice: they now deliver the JAX package's rows (timeBatch
    under @app:playback, one event per send)."""
    ts, rows = _verify_feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime("@app:playback\n" + bench.VERIFY_HEAD + ql)
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("O", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


EXPRESSION_APPS = {
    "nulls_and_builtins": (
        "@info(name='q') from S[not (symbol is null)] select symbol, "
        "coalesce(volume, 0L) as p, default(price, 7.5) as v, instanceOfFloat(price) as f, "
        "eventTimestamp() as ts, minimum(volume, 500L) as mv, volume / 0 as dz, "
        "volume % 0 as mz, price % 7.5 as pm, convert(volume, 'string') as vs, "
        "convert(price, 'string') as ps insert into Out;"
    ),
    "playback_clock": (
        "@info(name='q') from S[price > 30 or price is null] select symbol, "
        "currentTimeMillis() as now insert into Out;"
    ),
}


@pytest.mark.parametrize("case", sorted(EXPRESSION_APPS))
def test_expressions_with_nulls(case, monkeypatch):
    """Built-ins, null sentinels and divide/mod by zero, row by row."""
    from siddhi_tpu.utils import backend

    # the JAX package probes host callbacks (its numeric -> string convert
    # needs them) once a process; a first probe made while one of its steps
    # is traced (a `#log` stage) caches False, so probe afresh here
    monkeypatch.setattr(backend, "_CB_SUPPORT", None)
    ts, rows = _verify_feed()
    rows = [
        (None if i % 11 == 3 else s, None if i % 7 == 2 else p, None if i % 5 == 1 else v)
        for i, (s, p, v) in enumerate(rows)
    ]
    head = ("@app:playback\n" if case == "playback_clock" else "") + bench.VERIFY_HEAD
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(head + EXPRESSION_APPS[case])
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        rt.add_callback("q", _collector(out))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) > 40
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_uuid_mints_one_id_per_valid_row():
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        bench.VERIFY_HEAD + "@info(name='q') from S select UUID() as id insert into Out;"
    )
    out = []
    rt.add_callback("q", _collector(out))
    rt.start()
    ts, rows = _verify_feed()
    rt.get_input_handler("S").send_many(rows[:40], timestamps=[int(t) for t in ts[:40]])
    ids = [r[1] for r in out]
    assert len(ids) == 40 and len(set(ids)) == 40 and all(len(i) == 36 for i in ids)


# the apps of tests/test_filter_e2e.py that the slice covers: (app, callback
# target, rows sent one by one or in one send_many)
E2E_CASES = {
    "filter_passes_and_drops": (
        "define stream cseEventStream (symbol string, price float, volume long);"
        "@info(name='q1') from cseEventStream[volume < 150] select symbol, price "
        "insert into outputStream;",
        "q1", "cseEventStream", [("WSO2", 55.6, 100), ("IBM", 75.6, 400), ("GOOG", 50.0, 30)],
    ),
    "stream_callback_on_output_stream": (
        "define stream S (a int, b int); from S[a > 0] select a + b as total insert into Out;",
        "Out", "S", [(1, 2), (-5, 3), (10, 20)],
    ),
    "chained_queries": (
        "define stream S (v int); from S[v > 0] select v * 2 as v2 insert into Mid;"
        "from Mid[v2 > 10] select v2 insert into Out;",
        "Out", "S", [(1,), (4,), (6,), (-9,)],
    ),
    "select_star": (
        "define stream S (a int, b string); from S insert into Out;",
        "Out", "S", [(7, "x"), (8, None)],
    ),
    "running_sum_count_avg_without_window": (
        "define stream S (p float); @info(name='q') from S select sum(p) as s, "
        "count() as c, avg(p) as a insert into Out;",
        "q", "S", [(10.0,), (20.0,), (6.0,)],
    ),
    "int_long_arith_and_string_compare": (
        "define stream S (sym string, v int); from S[sym == 'WSO2' and v % 2 == 0] "
        "select sym, v / 3 as d insert into Out;",
        "Out", "S", [("WSO2", 10), ("IBM", 10), ("WSO2", 7), ("WSO2", -8)],
    ),
}


@pytest.mark.parametrize("one_by_one", [False, True])
@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_filter_e2e_apps(case, one_by_one):
    ql, target, stream, rows = E2E_CASES[case]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        out = got.setdefault(type(mgr).__module__.split(".")[0], [])
        if target in rt.queries:
            rt.add_callback(target, lambda t, ins, rem, _o=out: _o.extend(
                tuple(e.data) for e in ins or []))
        else:
            rt.add_callback(target, lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler(stream)
        if one_by_one:
            for r in rows:
                h.send(r)
        else:
            h.send_many(rows)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql,error", [
    ("define stream S (a int); from Nope select a insert into O;", "DefinitionNotExistError"),
    ("define stream S (a int); define stream Out (a string); from S select a insert into Out;",
     "SiddhiAppCreationError"),
])
def test_creation_errors_match(ql, error):
    for mgr in _managers():
        with pytest.raises(Exception) as got:
            mgr.create_siddhi_app_runtime(ql)
        assert type(got.value).__name__ == error
