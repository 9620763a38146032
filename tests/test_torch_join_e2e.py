"""Joins and sliding time windows end to end through both packages, live, on
the CPU: the same SiddhiQL app and the same events go through `siddhi_tpu`
(JAX) and `siddhi_tpu_torch` (device="cpu"), and the delivered rows must
match in order — inner/outer/unidirectional/self-joins, windowless sides,
count/sum/group-by over a join, time/timeLength/externalTime windows with
their timers under @app:playback and the wall clock. Floats match to a
relative 2e-4 (bench.py:_rows_match); everything else exactly.

The JAX package's fused self-join drops the left half's rows
(siddhi_tpu/core/app_runtime.py `_both_sides_impl` discards its first
output); the port delivers both halves on both of its paths, so it is held
against the JAX package's per-batch form (the reference's double dispatch).
"""

import logging
import time

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


def _deliveries(out: list):
    """One (ins, removed) entry per callback, as the golden harnesses record."""
    return lambda t, ins, rem: out.append(
        ([tuple(e.data) for e in ins or []], [tuple(e.data) for e in rem or []]))


def _managers():
    return siddhi_tpu.SiddhiManager(), siddhi_tpu_torch.SiddhiManager(device="cpu")


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _totals(d):
    return sum(len(i) for i, _ in d), sum(len(r) for _, r in d)


@pytest.mark.parametrize("case", ["self_join", "time_window", "external_time"])
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


# ---------------------------------------------------------------------------
# every tests/test_join.py app
# ---------------------------------------------------------------------------

BASE = """
define stream StockStream (sym string, price float);
define stream TwitterStream (user string, company string);
"""
ON = " on StockStream.sym == TwitterStream.company "
L10 = "StockStream#window.length(10)"
T10 = "TwitterStream#window.length(10)"
S, TW = "StockStream", "TwitterStream"
JOIN_APPS = {
    "window_probe": (
        f"from {L10} join {T10}{ON}select StockStream.sym as sym, TwitterStream.user as user, "
        "StockStream.price as price insert into Out;",
        [(S, ("WSO2", 55.5), 100), (TW, ("u1", "WSO2"), 200), (S, ("IBM", 75.5), 300),
         (S, ("WSO2", 57.0), 400)]),
    "multi_match_one_arrival": (
        f"from {L10} join {T10}{ON}select TwitterStream.user as user, "
        "StockStream.price as price insert into Out;",
        [(TW, ("u1", "WSO2"), 100), (TW, ("u2", "WSO2"), 200), (S, ("WSO2", 10.0), 300)]),
    "non_equi_self_join": (
        f"from {L10} as a join {L10} as b on a.price < b.price "
        "select a.price as lo, b.price as hi insert into Out;",
        [(S, ("WSO2", 10.0), 100), (S, ("WSO2", 20.0), 200)]),
    "filter_before_window": (
        f"from StockStream[price > 50]#window.length(10) join {T10}{ON}"
        "select StockStream.price as price, TwitterStream.user as user insert into Out;",
        [(S, ("WSO2", 10.0), 100), (S, ("WSO2", 60.0), 200), (TW, ("u1", "WSO2"), 300)]),
    "unidirectional": (
        f"from {L10} unidirectional join {T10}{ON}"
        "select StockStream.sym as sym, TwitterStream.user as user insert into Out;",
        [(S, ("WSO2", 55.5), 100), (TW, ("u1", "WSO2"), 200), (S, ("WSO2", 57.0), 300)]),
    "left_outer": (
        f"from {L10} left outer join {T10}{ON}"
        "select StockStream.sym as sym, TwitterStream.user as user insert into Out;",
        [(S, ("WSO2", 55.5), 100), (TW, ("u1", "WSO2"), 200), (TW, ("u2", "IBM"), 300)]),
    "right_outer": (
        f"from {L10} right outer join {T10}{ON}"
        "select StockStream.sym as sym, TwitterStream.user as user insert into Out;",
        [(TW, ("u1", "WSO2"), 100), (S, ("WSO2", 55.5), 200), (S, ("IBM", 75.5), 300)]),
    "full_outer": (
        f"from {L10} full outer join {T10}{ON}"
        "select StockStream.sym as sym, TwitterStream.user as user insert into Out;",
        [(S, ("WSO2", 55.5), 100), (TW, ("u2", "IBM"), 200), (TW, ("u1", "WSO2"), 300)]),
    "null_numeric_fill": (
        f"from {T10} left outer join {L10} on TwitterStream.company == StockStream.sym "
        "select TwitterStream.user as user, StockStream.price as price insert into Out;",
        [(TW, ("u1", "WSO2"), 100)]),
    "count_over_join": (
        f"from {L10} join {T10}{ON}select StockStream.sym as sym, count() as c insert into Out;",
        [(TW, ("u1", "WSO2"), 100), (S, ("WSO2", 10.0), 200), (S, ("WSO2", 11.0), 300)]),
    "group_by_over_join": (
        f"from {L10} join {T10}{ON}select TwitterStream.user as user, "
        "sum(StockStream.price) as total group by TwitterStream.user insert into Out;",
        [(TW, ("u1", "WSO2"), 100), (TW, ("u2", "WSO2"), 150), (S, ("WSO2", 10.0), 200),
         (S, ("WSO2", 5.0), 300)]),
    "all_events_expired_probe": (
        f"from StockStream#window.length(1) join {T10}{ON}"
        "select StockStream.price as price, TwitterStream.user as user "
        "insert all events into Out;",
        [(TW, ("u1", "WSO2"), 100), (S, ("WSO2", 10.0), 200), (S, ("WSO2", 11.0), 300)]),
}


def _run_sends(ql, sends, name="q"):
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.add_callback(name, _deliveries(got.setdefault(_pkg(mgr), [])))
        rt.start()
        hs = {}
        for stream, row, ts in sends:
            hs.setdefault(stream, rt.get_input_handler(stream)).send(row, timestamp=ts)
        rt.shutdown()
        mgr.shutdown()
    return got


@pytest.mark.parametrize("case", sorted(JOIN_APPS))
def test_join_app(case):
    ql, sends = JOIN_APPS[case]
    got = _run_sends(BASE + "@info(name='q') " + ql, sends)
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# ---------------------------------------------------------------------------
# the join goldens: tests/test_golden_join_ref.py 1-4 and 10-12 (playback)
# ---------------------------------------------------------------------------

D2 = """@app:playback @app:batch(size='8')
define stream cseEventStream (symbol string, price float, volume int);
define stream twitterStream (user string, tweet string, company string);
"""
CS, TS_ = "cseEventStream", "twitterStream"
ON2 = " on cseEventStream.symbol== twitterStream.company "
SEL2 = " select cseEventStream.symbol as symbol, twitterStream.tweet, cseEventStream.price "
JOIN_GOLDENS = {
    "test1_time_window_join_all_events": (
        D2 + "from cseEventStream#window.time(1 sec) join twitterStream#window.time(1 sec)"
        + ON2 + SEL2 + "insert all events into outputStream ;",
        [(0, CS, ("WSO2", 55.6, 100)), (10, TS_, ("User1", "Hello World", "WSO2")),
         (20, CS, ("IBM", 75.6, 100)), (520, CS, ("WSO2", 57.6, 100)),
         (2000, CS, ("ZZZ", 1.0, 0))], (2, 2)),
    "test2_aliased_time_window_join": (
        D2 + "from cseEventStream#window.time(1 sec) as a join twitterStream#window.time(1 sec) "
        "as b on a.symbol== b.company select a.symbol as symbol, b.tweet, a.price "
        "insert all events into outputStream ;",
        [(0, CS, ("WSO2", 55.6, 100)), (10, TS_, ("User1", "Hello World", "WSO2")),
         (20, CS, ("IBM", 75.6, 100)), (520, CS, ("WSO2", 57.6, 100)),
         (2000, CS, ("ZZZ", 1.0, 0))], (2, 2)),
    "test3_self_join": (
        """@app:playback @app:batch(size='8')
        define stream cseEventStream (symbol string, price float, volume int);
        from cseEventStream#window.time(500 milliseconds) as a
        join cseEventStream#window.time(500 milliseconds) as b on a.symbol== b.symbol
        select a.symbol as symbol, a.price as priceA, b.price as priceB
        insert all events into outputStream ;""",
        [(0, CS, ("IBM", 75.6, 100)), (10, CS, ("WSO2", 57.6, 100)),
         (2000, CS, ("ZZZ", 1.0, 0))], None),
    "test4_longer_window_join": (
        D2 + "from cseEventStream#window.time(2 sec) join twitterStream#window.time(2 sec)"
        + ON2 + SEL2 + "insert all events into outputStream ;",
        [(0, CS, ("WSO2", 55.6, 100)), (10, TS_, ("User1", "Hello World", "WSO2")),
         (20, CS, ("IBM", 75.6, 100)), (1020, CS, ("WSO2", 57.6, 100)),
         (4000, CS, ("ZZZ", 1.0, 0))], (2, 2)),
    "test10_windowless_side_joins_length1": (
        D2 + "from cseEventStream join twitterStream#window.length(1) "
        "select count() as events, symbol insert into outputStream ;",
        [(0, CS, ("WSO2", 55.6, 100)), (10, TS_, ("User1", "Hello World", "WSO2")),
         (20, CS, ("IBM", 75.6, 100)), (30, CS, ("WSO2", 57.6, 100))], (2, 0)),
    "test11_unidirectional_join": (
        D2 + "from cseEventStream unidirectional join twitterStream#window.length(1) "
        "select count() as events, symbol, tweet insert all events into outputStream ;",
        [(0, CS, ("WSO2", 55.6, 100)), (10, TS_, ("User1", "Hello World", "WSO2")),
         (20, CS, ("IBM", 75.6, 100)), (30, CS, ("WSO2", 57.6, 100))], None),
    "test12_select_star_join": (
        D2 + "from cseEventStream#window.time(1 sec) join twitterStream#window.time(1 sec)"
        + ON2 + "select * insert into outputStream ;",
        [(0, CS, ("WSO2", 55.6, 100)), (10, TS_, ("User1", "Hello World", "WSO2"))], (1, 0)),
}


@pytest.mark.parametrize("case", sorted(JOIN_GOLDENS))
def test_join_golden(case):
    """Each delivery equal to the JAX package's, and the reference's counts."""
    ql, steps, want = JOIN_GOLDENS[case]
    ql = ql.replace("from ", "@info(name = 'query1') from ", 1)
    got = _run_sends(ql, [(s, r, t) for t, s, r in steps], name="query1")
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
    port = got["siddhi_tpu_torch"]
    if want is not None:
        assert _totals(port) == want
    if case == "test3_self_join":
        real = sorted((s, round(a, 2), round(b, 2)) for i, _ in port for s, a, b in i
                      if s != "ZZZ")
        assert real == [("IBM", 75.6, 75.6), ("WSO2", 57.6, 57.6)]
    if case == "test11_unidirectional_join":
        assert _totals(port)[0] == 2


# ---------------------------------------------------------------------------
# tests/test_golden_windows_ref.py: the join and externalTime cases
# ---------------------------------------------------------------------------

STREAMS = """define stream cseEventStream (symbol string, price float, volume int);
define stream twitterStream (user string, tweet string, company string);
"""


def _run_wall(mgr, ql, sends, warm=()):
    """The golden harness: one event per send on the wall clock, sleeps
    between them, warm-up rows aged out first."""
    rt = mgr.create_siddhi_app_runtime(ql)
    d = []
    rt.add_callback("query1", _deliveries(d))
    rt.start()
    hs = {}
    for stream, row in warm:
        hs.setdefault(stream, rt.get_input_handler(stream)).send(row)
    if warm:
        time.sleep(0.5)
        d.clear()
    for step in sends:
        if step[0] == "sleep":
            time.sleep(step[1])
            continue
        hs.setdefault(step[0], rt.get_input_handler(step[0])).send(step[1])
    rt.shutdown()
    mgr.shutdown()
    return d


WARM = [(CS, ("X", 1.0, 1)), (TS_, ("U", "t", "Y"))]
WALL_GOLDENS = {
    "join_test1_time_both_directions": (
        STREAMS + "@info(name = 'query1') from cseEventStream#window.time(1 sec) join "
        "twitterStream#window.time(1 sec)" + ON2 + SEL2 + "insert all events into outputStream ;",
        [(CS, ("WSO2", 55.6, 100)), (TS_, ("User1", "Hello World", "WSO2")),
         (CS, ("IBM", 75.6, 100)), ("sleep", 0.5), (CS, ("WSO2", 57.6, 100)), ("sleep", 1.3)],
        WARM, (2, 2)),
    "join_test10_unidirectional": (
        STREAMS + "@info(name = 'query1') from cseEventStream#window.time(1 sec) unidirectional "
        "join twitterStream#window.time(1 sec)" + ON2 + SEL2 + "insert into outputStream ;",
        [(TS_, ("User1", "Hello World", "WSO2")), (CS, ("WSO2", 55.6, 100)),
         (CS, ("WSO2", 57.6, 100)), ("sleep", 0.5)], WARM, (2, 0)),
    "outer_test1_full_outer": (
        STREAMS + "@info(name = 'query1') from cseEventStream#window.length(3) full outer join "
        "twitterStream#window.length(1)" + ON2 + SEL2 + "insert all events into outputStream ;",
        [(CS, ("WSO2", 55.6, 100)), (TS_, ("User1", "Hello World", "WSO2")),
         (CS, ("IBM", 75.6, 100)), (CS, ("WSO2", 57.6, 100))], (), None),
    "outer_test2_right_outer": (
        STREAMS + "@info(name = 'query1') from cseEventStream#window.length(1) right outer join "
        "twitterStream#window.length(2)" + ON2 + "select cseEventStream.symbol as symbol, "
        "twitterStream.tweet, cseEventStream.price, twitterStream.company as company "
        "insert all events into outputStream ;",
        [(TS_, ("User1", "Hello World", "WSO2")), (CS, ("BMW", 57.6, 100)),
         (TS_, ("User2", "Welcome", "IBM")), (CS, ("WSO2", 57.6, 100))], (), None),
    "external_time_test1": (
        "define stream LoginEvents (timestamp long, ip string) ;\n@info(name = 'query1') "
        "from LoginEvents#window.externalTime(timestamp,5 sec) select timestamp, ip "
        "insert all events into uniqueIps ;",
        [("LoginEvents", (1366335804341, "192.10.1.3")),
         ("LoginEvents", (1366335804342, "192.10.1.4")),
         ("LoginEvents", (1366335814341, "192.10.1.5")),
         ("LoginEvents", (1366335814345, "192.10.1.6")),
         ("LoginEvents", (1366335824341, "192.10.1.7"))], (), (5, 4)),
}


@pytest.mark.parametrize("case", sorted(WALL_GOLDENS))
def test_window_golden(case):
    """The port meets the reference's counts; cases with no sleep (nothing
    depends on the wall clock's pace) also equal the JAX package's rows."""
    ql, sends, warm, want = WALL_GOLDENS[case]
    port = _run_wall(siddhi_tpu_torch.SiddhiManager(device="cpu"), ql, sends, warm)
    if want is not None:
        assert _totals(port) == want
    if not any(s[0] == "sleep" for s in sends):
        jax_rows = _run_wall(siddhi_tpu.SiddhiManager(), ql, sends, warm)
        assert bench._rows_match(port, jax_rows)
    if case == "outer_test1_full_outer":
        assert [(r[0], r[1]) for i, _ in port for r in i] == [
            ("WSO2", None), ("WSO2", "Hello World"), ("IBM", None), ("WSO2", "Hello World")]


# ---------------------------------------------------------------------------
# tests/test_windows.py: the time, timeLength and externalTime apps
# ---------------------------------------------------------------------------

EXT_APP = """
define stream S (ts long, p float);
@info(name='q')
from S#window.externalTime(ts, 1 sec) select sum(p) as total
insert all events into O;
"""


@pytest.mark.parametrize("sends", [
    [[(1000, 10.0)], [(1500, 20.0)], [(2100, 5.0)], [(3600, 1.0)]],  # test_external_time_window
    [[(1000, 10.0), (2100, 20.0)], [(3600, 1.0)]],  # ..._no_double_expiry
], ids=["external_time_window", "in_batch_time_eviction_no_double_expiry"])
def test_external_time_apps(sends):
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(EXT_APP)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        for rows in sends:
            h.send_many(rows, timestamps=[r[0] for r in rows])
        rt.shutdown()
        mgr.shutdown()
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
    if len(sends) == 4:
        assert [r[1] for r in got["siddhi_tpu_torch"] if r[0] == "+"] == [10.0, 30.0, 25.0, 1.0]
        assert [r[1] for r in got["siddhi_tpu_torch"] if r[0] == "-"] == [20.0, 5.0, 0.0]


def _wait(pred, seconds=5.0):
    deadline = time.time() + seconds
    while not pred() and time.time() < deadline:
        time.sleep(0.02)


def test_time_window_with_system_scheduler():
    """Wall clock: the system scheduler's thread sends the TIMER rows that
    expire both events with no further arrivals."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        "define stream S (p float); @info(name='q') from S#window.time(200 millisec) "
        "select sum(p) as total insert all events into O;")
    got = []
    rt.add_callback("q", _collector(got))
    rt.start()
    h = rt.get_input_handler("S")
    h.send((4.0,))
    h.send((6.0,))
    assert got[0] == ("+", 4.0)
    _wait(lambda: sum(r[0] == "-" for r in got) >= 2)
    removed = [r for r in got if r[0] == "-"]
    assert len(removed) == 2 and removed[-1] == ("-", 0.0)
    mgr.shutdown()


def test_time_length_window():
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        "define stream S (ts long, p float); @info(name='q') from S#window.timeLength(1 sec, 2) "
        "select sum(p) as total insert into O;")
    got = []
    rt.add_callback("q", _collector(got))
    rt.start()
    h = rt.get_input_handler("S")
    for v in (1.0, 2.0, 4.0):
        h.send((0, v))
    # within the second, the length cap governs: running sums 1, 3, (3-1)+4
    assert [r[1] for r in got] == [1.0, 3.0, 6.0]
    mgr.shutdown()


def test_post_window_filter_keeps_timer_scheduling():
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        "define stream S (p float); @info(name='q') from S#window.time(300 millisec)[p > 0] "
        "select sum(p) as total insert all events into O;")
    got = []
    rt.add_callback("q", _collector(got))
    rt.start()
    rt.get_input_handler("S").send((5.0,))
    _wait(lambda: any(r[0] == "-" for r in got))
    assert ("-", 0.0) in got
    mgr.shutdown()


@pytest.mark.parametrize("kind", ["time(300)", "timeLength(300, 40)", "externalTime(v, 300)"])
def test_playback_time_windows_columnar(kind):
    """Per-batch send_columns under @app:playback, timers fired by the
    event-time clock between calls; EXPIRED rows, min/max over the lazy
    membership and a post-window filter, against the JAX package."""
    ql = ("@app:playback @app:batch(size='64') define stream S (sym string, p float, v long);"
          f"@info(name='q') from S[p > 20]#window.{kind} select sym, avg(p) as a, "
          "min(p) as lo, max(p) as hi, count() as c insert all events into O;")
    data = bench._make_stock_data(700, seed=5)
    data["volume"] = data["ts"] + np.random.default_rng(5).integers(-50, 50, 700)
    got = {}
    for mgr in _managers():
        for s in data["names"]:
            mgr.interner.intern(str(s))
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        for j in rt.junctions.values():
            j.fused_ingest = None
        h = rt.get_input_handler("S")
        for lo in range(0, 700, 64):
            hi = min(lo + 64, 700)
            ts = data["ts"][lo:hi] + 2 * np.arange(lo, hi)  # 3 ms apart
            h.send_columns(ts, {"sym": data["symbol"][lo:hi], "p": data["price"][lo:hi],
                                "v": data["volume"][lo:hi]})
        rt.shutdown()
        mgr.shutdown()
    assert sum(r[0] == "-" for r in got["siddhi_tpu"]) > 50
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# ---------------------------------------------------------------------------
# sliding_join (BASELINE.json config 3), fused and per batch
# ---------------------------------------------------------------------------

SLIDING_JOIN = """
@app:joinCapacity(size='{cap}')
@app:batch(size='{batch}')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from StockStream#window.{win} as a join StockStream#window.{win} as b
on a.volume == b.volume
select a.symbol as s1, b.symbol as s2
insert into Out;
"""


def _send_stock(rt, mgr, data, lo, hi, fused=True, stream="StockStream", calls=1):
    for s in data["names"]:
        mgr.interner.intern(str(s))
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    cols = {k: data[k][lo:hi] for k in ("symbol", "price", "volume")}
    h = rt.get_input_handler(stream)
    step = -(-(hi - lo) // calls)
    for c in range(lo, hi, step):
        e = min(c + step, hi)
        h.send_columns(data["ts"][c:e], {k: v[c - lo:e - lo] for k, v in cols.items()}, now=0)


def _run(pkg_mgr, app, data, n, fused, per_call=None):
    rows, calls = [], [0]

    def cb(t, ins, rem):
        calls[0] += 1
        rows.extend(("+",) + tuple(e.data) for e in ins or [])

    rt = pkg_mgr.create_siddhi_app_runtime(app)
    rt.add_callback("q", cb)
    rt.start()
    _send_stock(rt, pkg_mgr, data, 0, n, fused=fused, calls=1 if per_call is None else n // per_call)
    fi = rt.junctions["StockStream"].fused_ingest
    fused_batches = fi.batches_fused if fi is not None else 0
    rt.shutdown()
    pkg_mgr.shutdown()
    return rows, calls[0], fused_batches


@pytest.mark.parametrize("batch", [32, 33, 4096])
def test_sliding_join(batch):
    """bench.py's sliding_join app (length(100) self-join on volume) through
    send_columns: the port (fused where the call holds 2+ batches) against
    the JAX package's per-batch form."""
    n = 3 * 4096 + 77 if batch == 4096 else 40 * batch + 7
    data = bench._make_stock_data(n, seed=7)
    app = SLIDING_JOIN.format(cap=8192, batch=batch, win="length(100)")
    want, _, _ = _run(siddhi_tpu.SiddhiManager(), app, data, n, fused=False)
    got, _, fused = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), app, data, n, fused=True)
    assert fused > 0
    assert len(want) > 100
    assert got == want


def test_self_join_fused_equals_per_batch_and_jax_per_batch():
    """The port's fused self-join delivers its per-batch form's callback
    sequence (left half then right half of every micro-batch), which is the
    JAX package's per-batch sequence. The JAX package's fused form drops
    the left halves (its `_both_sides_impl` discards the first output), so
    it delivers fewer callbacks and rows."""
    n, batch = 2560, 64
    data = bench._make_stock_data(n, seed=1)
    data["volume"] = data["volume"] % 40  # many matches per batch
    app = SLIDING_JOIN.format(cap=4096, batch=batch, win="length(8)")
    seqs = {}
    for label, mk, fused in (("port_fused", lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"),
                              True),
                             ("port_per_batch",
                              lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"), False),
                             ("jax_per_batch", siddhi_tpu.SiddhiManager, False),
                             ("jax_fused", siddhi_tpu.SiddhiManager, True)):
        rows, calls, fused_batches = _run(mk(), app, data, n, fused)
        assert (fused_batches > 0) == fused
        seqs[label] = (rows, calls)
    assert seqs["port_fused"] == seqs["port_per_batch"]
    assert seqs["port_fused"][1] == seqs["jax_per_batch"][1]
    assert bench._rows_match(seqs["port_fused"][0], seqs["jax_per_batch"][0])
    # the fault in the reference package's fused form: fewer callbacks/rows
    assert seqs["jax_fused"][1] < seqs["jax_per_batch"][1]
    assert len(seqs["jax_fused"][0]) < len(seqs["jax_per_batch"][0])


TWO_STREAM = """
@app:batch(size='32')
define stream StockStream (symbol string, price float, volume long);
define stream Other (symbol string, price float, volume long);
@info(name='q')
from StockStream#window.length(20) as a {jtype} Other#window.length(30) as b
on a.symbol == b.symbol and b.price > a.price
select a.symbol as s, a.price as pa, b.price as pb, b.volume as vb
insert all events into Out;
"""


@pytest.mark.parametrize("jtype", ["join", "full outer join"])
def test_two_stream_join_fused_equals_per_batch(jtype):
    """A two-stream join, one fused endpoint per side: the port's fused
    callback sequence equals its per-batch one and the JAX package's."""
    data = bench._make_stock_data(6 * 32 * 2, seed=4)
    app = TWO_STREAM.format(jtype=jtype)
    got = {}
    for label, mgr, fused in (("fused", siddhi_tpu_torch.SiddhiManager(device="cpu"), True),
                              ("per_batch", siddhi_tpu_torch.SiddhiManager(device="cpu"), False),
                              ("jax", siddhi_tpu.SiddhiManager(), False)):
        rt = mgr.create_siddhi_app_runtime(app)
        rt.add_callback("q", _deliveries(got.setdefault(label, [])))
        rt.start()
        half = 6 * 32
        for k in range(2):  # alternate the streams, 3 batches a call
            lo = k * half // 2
            _send_stock(rt, mgr, data, lo, lo + half // 2, fused=fused)
            _send_stock(rt, mgr, data, half + lo, half + lo + half // 2, fused=fused,
                        stream="Other")
        for name in ("StockStream", "Other"):
            fi = rt.junctions[name].fused_ingest
            assert (fi is not None and fi.batches_fused > 0) == fused
        rt.shutdown()
        mgr.shutdown()
    assert got["jax"]
    assert got["fused"] == got["per_batch"]
    assert bench._rows_match(got["fused"], got["jax"])


# ---------------------------------------------------------------------------
# failed and counted timer steps
# ---------------------------------------------------------------------------

TIMED_APPS = {
    "single": "@app:playback @app:batch(size='16') define stream StockStream "
              "(symbol string, price float, volume long); @info(name='q') "
              "from StockStream#window.time(40) select symbol, sum(price) as t insert into Out;",
    "join": "@app:playback " + SLIDING_JOIN.format(cap=4096, batch=16, win="time(40)"),
}


def _failing_timer_steps(monkeypatch):
    """Make every time-window step over a TIMER row raise, as a kernel fault
    would; data steps run as before."""
    from siddhi_tpu_torch.core import windows
    from siddhi_tpu_torch.core.event import KIND_TIMER

    real = windows.time_window_step

    def step(state, batch, *args):
        if bool((batch.kind == KIND_TIMER).any()):
            raise RuntimeError("CUDA kernel time_window_step failed: cudaError_t 719")
        return real(state, batch, *args)

    monkeypatch.setattr(windows, "time_window_step", step)


@pytest.mark.parametrize("app", list(TIMED_APPS))
def test_failed_timer_step_raises_from_send_columns(app, monkeypatch):
    """A timer step that fails on the sender's thread (the event-time clock)
    makes that send_columns raise; with an exception handler set, the
    handler gets it and the send returns."""
    data = bench._make_stock_data(64, seed=4)
    for handled in (False, True):
        _failing_timer_steps(monkeypatch)
        mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
        rt = mgr.create_siddhi_app_runtime(TIMED_APPS[app])
        seen = []
        if handled:
            rt.set_exception_handler(seen.append)
        rt.start()
        _send_stock(rt, mgr, data, 0, 16, fused=False)  # arms the first timer
        if handled:
            _send_stock(rt, mgr, data, 48, 64, fused=False)
            assert seen and "time_window_step" in str(seen[0])
        else:
            with pytest.raises(RuntimeError, match="time_window_step"):
                _send_stock(rt, mgr, data, 48, 64, fused=False)
        mgr.shutdown()
        monkeypatch.undo()


def test_failed_wall_clock_timer_step_raises_at_shutdown(monkeypatch):
    """A timer step that fails on the system scheduler's thread is raised
    by shutdown() (or the next send), not lost."""
    _failing_timer_steps(monkeypatch)
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        "define stream S (p float); @info(name='q') from S#window.time(50 millisec) "
        "select sum(p) as total insert all events into O;")
    fired = []
    rt.start()
    rt.queries["q"].timer_targets["in"] = (
        lambda t_ms, _f=rt.queries["q"].timer_targets["in"]: (fired.append(t_ms), _f(t_ms)))
    rt.get_input_handler("S").send((4.0,))
    _wait(lambda: fired)
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="time_window_step"):
        rt.shutdown()


@pytest.mark.parametrize("app", list(TIMED_APPS))
def test_timer_fires_each_run_one_time_window_step(app, monkeypatch):
    """Every fire of a timer target runs exactly one time-window step, so a
    run's steps are its data steps plus its fires (what chip_smoke.py holds
    the card's launch counts to on paths T and T2)."""
    from siddhi_tpu_torch.core import windows

    steps = [0]
    real = windows.time_window_step

    def step(*args):
        steps[0] += 1
        return real(*args)

    monkeypatch.setattr(windows, "time_window_step", step)
    data = bench._make_stock_data(160, seed=4)
    data["ts"] = data["ts"] * 3  # 3 ms apart: a 40 ms window holds ~13
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(TIMED_APPS[app])
    qr = rt.queries["q"]
    fires = [0]
    for key, fire in list(qr.timer_targets.items()):
        def counted(t_ms, _fire=fire):
            _fire(t_ms)
            fires[0] += 1

        qr.timer_targets[key] = counted
    rt.start()
    _send_stock(rt, mgr, data, 0, 160, fused=False, calls=10)
    mgr.shutdown()
    sides = 2 if app == "join" else 1
    assert fires[0] > 0
    assert steps[0] == sides * 10 + fires[0]


def test_time_window_query_stays_off_the_fused_path():
    """A query whose window needs the scheduler keeps the per-batch path
    (its next expiry is read after every step); externalTime does not."""
    for win, fused in (("time(1 sec)", False), ("externalTime(volume, 1 sec)", True)):
        mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
        rt = mgr.create_siddhi_app_runtime(SLIDING_JOIN.format(cap=4096, batch=32, win=win))
        rt.start()
        _send_stock(rt, mgr, bench._make_stock_data(128, seed=2), 0, 128)
        assert (rt.junctions["StockStream"].fused_ingest.batches_fused > 0) == fused
        mgr.shutdown()


def test_join_overflow_logged_once(caplog):
    data = bench._make_stock_data(256, seed=3)
    data["volume"] = data["volume"] % 2
    app = SLIDING_JOIN.format(cap=16, batch=32, win="length(20)")
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(app)
    rt.start()
    with caplog.at_level(logging.WARNING):
        _send_stock(rt, mgr, data, 0, 256, fused=False)
        mgr.shutdown()
    assert sum("joinCapacity" in r.message for r in caplog.records) == 1


def test_join_state_carry():
    """Run JAX for 3 batches of an externalTime self-join (a time ring with
    holes on each side, out-of-order window times), carry its join state
    ({"join": {"l", "r"}, "sel"}) and interned strings into the port, then
    feed both the same next 3 batches."""
    app = SLIDING_JOIN.format(cap=4096, batch=32, win="externalTime(volume, 300)")
    app = app.replace("on a.volume == b.volume\nselect a.symbol as s1",
                      "on a.symbol == b.symbol\nselect a.symbol as s1, count() as c, a.volume as v")
    data = bench._make_stock_data(6 * 32, seed=11)
    jmgr, pmgr = _managers()
    jrt = jmgr.create_siddhi_app_runtime(app)
    jrt.start()
    _send_stock(jrt, jmgr, data, 0, 96, fused=False, calls=3)
    tree = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    assert 0 < int((tree["join"]["l"]["seq"] >= 0).sum()) < 1024

    prt = pmgr.create_siddhi_app_runtime(app)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(tree, "cpu")
    np.testing.assert_equal(state_to_numpy(prt.queries["q"].state), tree)
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    prt.start()
    _send_stock(jrt, jmgr, data, 96, 192, fused=False, calls=3)
    _send_stock(prt, pmgr, data, 96, 192, fused=False, calls=3)
    want_state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    got_state = state_to_numpy(prt.queries["q"].state)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"]) > 8
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(got_state, want_state)


# the forms test_outside_the_slice_raises held to "not ported yet" until the
# named-window slice: a @store table side (its rows loaded from the record
# store) and a named-window side (fed by S)
SLICE15_JOINS = [
    "@store(type='memory', store.id='j1') define table T (symbol string, price float); "
    "@info(name='q') from S join T on S.symbol == T.symbol select S.symbol, T.price as p "
    "insert into Out;",
    "define window W (symbol string, price float, volume long) length(4); "
    "from S insert into W; "
    "@info(name='q') from S#window.length(4) as a join W as b on a.volume == b.volume "
    "select a.symbol, b.price as p insert into Out;",
]


@pytest.mark.parametrize("ql", SLICE15_JOINS)
def test_slice15_join_forms_match_jax(ql):
    """Each join's rows against the JAX package's, one event per send; the
    @store table starts from the same stored rows in both packages."""
    import siddhi_tpu.core.record_table as jax_records

    import siddhi_tpu_torch.core.record_table as port_records

    rng = np.random.default_rng(15)
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 6)) * 100)
            for _ in range(96)]
    stored = [("IBM", 1.5), ("GOOG", 2.5), ("IBM", 3.5)]
    got = {}
    for mgr, records in zip(_managers(), (jax_records, port_records)):
        records.InMemoryRecordStore.clear_all()
        records.InMemoryRecordStore._data["j1"] = list(stored)
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=1_700_000_000_000 + 30 * i)
        rt.shutdown()
        mgr.shutdown()
        records.InMemoryRecordStore.clear_all()
    assert len(got["siddhi_tpu"]) > 20
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "from S#pol2Cart(price, price) as a join S#window.length(4) as b "
    "on a.volume == b.volume select a.symbol insert into Out;",
    "from every (e1=S[price > 10] and e2=S[price > maximum(e1.price, 20.0)]) "
    "select e1.symbol as s insert into Out;",
])
def test_outside_the_slice_raises(ql):
    """A stream function on a join side raises JAX's message (the JAX
    package refuses it too); a function applied to a captured event in a
    pattern condition is still outside the port's slice."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    if " join " in ql:
        with pytest.raises(SiddhiAppCreationError) as ei:
            mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)
        with pytest.raises(Exception) as jei:
            siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)
        assert str(ei.value) == str(jei.value)
        assert "not supported on join sides yet" in str(ei.value)
        return
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)


@pytest.mark.parametrize("ql", [
    "from S#window.timeBatch(50) as a join S#window.length(4) as b "
    "on a.volume == b.volume select a.symbol as s1, b.symbol as s2, a.price as p "
    "insert into Out;",
    "from S#window.externalTimeBatch(volume, 1 sec) select symbol insert into Out;",
    "from S#window.length(4) as a join S#window.length(4) as b on a.volume == b.volume "
    "select a.symbol, min(a.price) as m insert into Out;",
])
def test_forms_that_raised_match_jax(ql):
    """The join-slice forms test_outside_the_slice_raises held to "not ported
    yet" until the time-batch slice (a timeBatch join side, an
    externalTimeBatch query, min over a join) against the JAX package,
    under @app:playback, one event per send."""
    rng = np.random.default_rng(99)
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 40)) * 100)
            for _ in range(96)]
    ts = [1_700_000_000_000 + 7 * i for i in range(96)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(
            "@app:playback\n" + bench.VERIFY_HEAD + "@app:joinCapacity(size='256')\n"
            "@info(name='q') " + ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        for r, t in zip(rows, ts):
            h.send(r, timestamp=t)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "partition with (symbol of S) begin @info(name='q') from S#window.length(4) as a join "
    "S#window.lossyFrequent(0.1, 0.01, volume) as b on a.volume == b.volume "
    "select a.symbol as s1, b.price as p insert into Out; end;",
])
def test_slice14_join_forms_match_jax(ql):
    """The lossyFrequent join side inside a partition that
    test_outside_the_slice_raises held to "not ported yet" until the
    aggregation slice, against the JAX package, one event per send."""
    rng = np.random.default_rng(14)
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 6)) * 100)
            for _ in range(96)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=1_700_000_000_000 + 30 * i)
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) > 20
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    "from S#window.sort(4, price) as a join S#window.length(4) as b "
    "on a.volume == b.volume select a.symbol as s1, b.price as p insert into Out;",
    "from S#window.cron('*/1 * * * * ?') as a join S#window.length(4) as b "
    "on a.volume == b.volume select a.symbol as s1, b.symbol as s2 insert into Out;",
])
def test_slice9_join_forms_match_jax(ql):
    """The sort and cron join sides test_outside_the_slice_raises held to
    "not ported yet" until the special-window slice, against the JAX
    package, under @app:playback, one event per send, 30 ms apart."""
    rng = np.random.default_rng(99)
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 40)) * 100)
            for _ in range(96)]
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(
            "@app:playback\n" + bench.VERIFY_HEAD + "@app:joinCapacity(size='256')\n"
            "@info(name='q') " + ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=1_700_000_000_000 + 30 * i)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
