"""Patterns and sequences inside a partition, end to end through both packages
on the CPU: the same SiddhiQL app and events through `siddhi_tpu` (JAX) and
`siddhi_tpu_torch` (device="cpu"), at @app:batch 16 and 33: each route (the
fast route, the count route and the per-event scan, and the fast route's
app forced onto the scan), a sequence, a logical and a count state, an
absent pattern under playback with a key first seen late, two streams on
one key table, a range partition, group-by, order-by and limit after a
pattern, `output last every`, `insert into` a table, chip_smoke's PPF/PPC/
PPA apps at a small size, the order rows leave the partition in (position
in the partition's emission, then slot), a JAX partitioned pattern's state
carried in through `interop.partition_state_from_jax`, and the forms JAX
refuses refused with the same error class and message. Floats match to a
relative 2e-4 (bench.py:_rows_match); everything else exactly.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu.core.errors as jax_errors  # noqa: E402
import siddhi_tpu.core.pattern as jax_pattern  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
import siddhi_tpu_torch.core.errors as port_errors  # noqa: E402
import siddhi_tpu_torch.core.pattern as port_pattern  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    partition_state_from_jax,
    state_to_numpy,
)

HEAD = ("define stream S (symbol string, price float, volume long);\n"
        "define stream S2 (symbol string, price float, volume long);\n")
PART = "partition with (symbol of S) begin\n{body}\nend;"
PART2 = "partition with (symbol of S, symbol of S2) begin\n{body}\nend;"
RANGE = ("partition with (price < 50 as 'low' or price >= 50 as 'high' of S) begin\n{body}\n"
         "end;")
Q = "@info(name='q') "

APPS = {
    "fast": PART.format(body=Q + "from every e1=S[price > 80] -> e2=S[price < 20] within 60 "
                        "milliseconds select e1.symbol as s, e1.price as p1, e2.price as p2 "
                        "insert into Out;"),
    "sequence": PART.format(body=Q + "from every e1=S[price > 60], e2=S[price < 40] "
                            "select e1.symbol as s, e1.price as p1, e2.price as p2 "
                            "insert into Out;"),
    "count": PART.format(body=Q + "from every e1=S[price > 70]<2:3> -> e2=S[price < 30] "
                         "select e1[0].price as p0, e1[last].price as pl, e2.price as p2 "
                         "insert into Out;"),
    "logical": PART.format(body=Q + "from every (e1=S[price > 60] and e2=S[volume > 500]) -> "
                           "e3=S[price < 30] select e1.price as p1, e2.volume as v2, "
                           "e3.price as p3 insert into Out;"),
    "count_middle": PART.format(body=Q + "from e1=S[price > 80] -> e2=S[price < 40]<1:3> -> "
                                "e3=S[price > 90] select e1.price as p1, e2[0].price as q0, "
                                "e3.price as p3 insert into Out;"),
    "two_streams": PART2.format(body=Q + "from every e1=S[price > 70] -> e2=S2[price < 30] "
                                "select e1.symbol as s, e1.price as p1, e2.price as p2 "
                                "insert into Out;"),
    "range": RANGE.format(body=Q + "from every e1=S[volume > 800] -> e2=S[volume < 100] "
                          "select e1.symbol as s1, e2.symbol as s2, e2.volume as v "
                          "insert into Out;"),
    "group_by": RANGE.format(body=Q + "from every e1=S[volume > 700] -> e2=S[volume < 300] "
                             "select e2.symbol as s, count() as n, sum(e2.volume) as t "
                             "group by e2.symbol insert into Out;"),
    "order_limit": PART.format(body=Q + "from every e1=S[price > 60] -> e2=S[price < 40] "
                               "select e1.symbol as s, e1.price as p1, e2.price as p2 "
                               "order by p2 desc limit 2 insert into Out;"),
    "output_last": PART.format(body=Q + "from every e1=S[price > 60] -> e2=S[price < 40] "
                               "select e1.symbol as s, e2.price as p2 "
                               "output last every 3 events insert into Out;"),
}
PLAYBACK_APPS = {
    "absent": PART.format(body=Q + "from every e1=S[price > 80] -> not S[price < 20] for 20 "
                          "milliseconds select e1.symbol as s, e1.price as p insert into Out;"),
    "absent_first": PART.format(body=Q + "from not S[price > 90] for 30 milliseconds -> "
                                "e2=S[price < 30] select e2.symbol as s, e2.price as p "
                                "insert into Out;"),
    "absent_two_streams": PART2.format(body=Q + "from every e1=S[price > 70] -> not S2[price > "
                                       "50] for 25 milliseconds select e1.symbol as s, "
                                       "e1.price as p insert into Out;"),
}


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _managers():
    return siddhi_tpu.SiddhiManager(), _port()


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _events(n: int, symbols: int, seed: int, step: int = 3):
    rng = np.random.default_rng(seed)
    names = [f"K{i}" for i in range(symbols)]
    rows = [(names[int(rng.integers(0, symbols))], float(np.float32(rng.uniform(0, 100))),
             int(rng.integers(1, 1000))) for _ in range(n)]
    return rows, [1_700_000_000_000 + step * i for i in range(n)]


def _run(mgr, ql, feeds, chunk, outs=("Out",), table=None):
    """Deliver `feeds` [(stream, rows, timestamps)] in send_many calls of
    `chunk` events, interleaving streams call by call; returns the rows of
    each output stream (or the table)."""
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {o: [] for o in outs}
    for o in outs:
        rt.add_callback(o, lambda evs, _g=got[o]: _g.extend(tuple(e.data) for e in evs))
    rt.start()
    hs = {sid: rt.get_input_handler(sid) for sid, _r, _t in feeds}
    n = max(len(r) for _s, r, _t in feeds)
    for lo in range(0, n, chunk):
        for sid, rows, ts in feeds:
            if lo < len(rows):
                hs[sid].send_many(rows[lo:lo + chunk], timestamps=ts[lo:lo + chunk])
    if table is not None:
        got = {table: [list(e.data) for e in rt.query(f"from {table} select *")]}
    rt.shutdown()
    mgr.shutdown()
    return got


def _head(batch: int, cap: int, playback: bool = False) -> str:
    pb = "@app:playback " if playback else ""
    return f"{pb}@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')\n" + HEAD


def _both(ql, feeds, chunk, **kw):
    return {_pkg(m): _run(m, ql, feeds, chunk, **kw) for m in _managers()}


def test_rows_leave_by_position_then_slot():
    """The rows of one call leave the partition by their place in their
    partition's emission, then by slot: A's match, made last, comes first."""
    ql = ("@app:batch(size='16') @app:partitionCapacity(size='8')\n" + HEAD + PART.format(
        body="from every e1=S[price > 90] -> e2=S[price < 10] select e1.symbol as s, "
             "e1.price as p1, e2.price as p2 insert into Out;"))
    rows = [("A", 96.0, 1), ("B", 97.0, 1), ("B", 2.0, 1), ("B", 98.0, 1), ("B", 1.0, 1),
            ("A", 3.0, 1)]
    ts = list(range(1_700_000_000_000, 1_700_000_000_006))
    got = _both(ql, [("S", rows, ts)], 6)
    want = [("A", 96.0, 3.0), ("B", 97.0, 2.0), ("B", 98.0, 1.0)]
    assert got["siddhi_tpu"]["Out"] == want
    assert got["siddhi_tpu_torch"]["Out"] == want


# every app at batch 16; the two batch routes at 33 too (the scan runs at 33
# under playback; most of a case's time is the JAX package's compiles)
APP_CASES = [(c, 16) for c in sorted(APPS)] + [(c, 33) for c in ("count", "fast")]


@pytest.mark.parametrize("case,batch", APP_CASES)
def test_app_matches_jax(case, batch):
    """Each app over 160 events of 6 keys in calls of 2.5 batches."""
    ql = _head(batch, 8) + APPS[case]
    rows, ts = _events(160, 6, seed=len(case) * 7 + batch)
    feeds = [("S", rows, ts)]
    if case.startswith("two_streams"):
        r2, t2 = _events(160, 6, seed=batch, step=3)
        feeds.append(("S2", r2, [t + 1 for t in t2]))
    got = _both(ql, feeds, batch * 5 // 2)
    assert len(got["siddhi_tpu"]["Out"]) > 2
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("case,batch", [(c, 16) for c in sorted(PLAYBACK_APPS)]
                         + [("absent", 33)])
def test_playback_app_matches_jax(case, batch):
    """The scan with its TIMER steps under playback; a key first seen after
    the others' windows elapsed waits its own window."""
    ql = _head(batch, 8, playback=True) + PLAYBACK_APPS[case]
    rows, ts = _events(120, 5, seed=batch + len(case), step=4)
    rows += [("LATE", 50.0, 5), ("LATE", 10.0, 5)]  # a late key
    ts += [ts[-1] + 200, ts[-1] + 205]
    rows += [("LATE", 95.0, 5)] * 2 + [("K0", 5.0, 5)]
    ts += [ts[-1] + 100, ts[-1] + 300, ts[-1] + 400]
    feeds = [("S", rows, ts)]
    if case == "absent_two_streams":
        r2, t2 = _events(60, 5, seed=batch, step=8)
        feeds.append(("S2", r2, [t + 2 for t in t2]))
    got = _both(ql, feeds, batch)
    assert len(got["siddhi_tpu"]["Out"]) > 2
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_forced_scan_matches_jax_forced_scan(monkeypatch):
    """The fast route's and the count route's apps with both packages
    forced onto the per-event scan."""
    monkeypatch.setattr(jax_pattern, "FORCE_SCAN", True)
    monkeypatch.setattr(port_pattern, "FORCE_SCAN", True)
    for case in ("fast", "count"):
        ql = _head(16, 8) + APPS[case]
        rows, ts = _events(96, 5, seed=3)
        got = _both(ql, [("S", rows, ts)], 40)
        assert len(got["siddhi_tpu"]["Out"]) > 2
        assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_insert_into_table():
    """Every partition's rows into the one shared table."""
    ql = (_head(16, 8) + "define table T (s string, p1 float, p2 float);\n"
          + PART.format(body=Q + "from every e1=S[price > 70] -> e2=S[price < 30] "
                        "select e1.symbol as s, e1.price as p1, e2.price as p2 insert into T;"))
    rows, ts = _events(120, 6, seed=11)
    got = _both(ql, [("S", rows, ts)], 40, outs=(), table="T")
    assert len(got["siddhi_tpu"]["T"]) > 2
    assert bench._rows_match(got["siddhi_tpu_torch"]["T"], got["siddhi_tpu"]["T"])


@pytest.mark.parametrize("path", ["PPF", "PPC", "PPA"])
def test_chip_smoke_apps_match_jax(path):
    """chip_smoke's partitioned pattern paths at batch 32 and capacity 16
    over 12 keys (PPA's window met by 1 ms ticks: 100 events a key)."""
    ql = chip_smoke.partition_pattern_app(path, 32, 16).replace("StockStream", "S")
    ql = ql.replace("define stream S (", HEAD.split("\n")[1] + "\ndefine stream S (")
    rows, ts = _events(480, 12, seed=len(path), step=1)
    got = {_pkg(m): _run(m, ql, [("S", rows, ts)], 80, outs=("Out",)) for m in _managers()}
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_jax_pattern_state_carried_in():
    """Four calls through JAX, its key table and the [P]-tiled token
    tables, selector state and TIMER clocks into the port, then four more
    calls through both: equal rows, equal states after."""
    ql = _head(16, 8) + APPS["count"]
    rows, ts = _events(128, 6, seed=21)
    jmgr, pmgr = _managers()
    jrt, prt = jmgr.create_siddhi_app_runtime(ql), pmgr.create_siddhi_app_runtime(ql)
    got = {"jax": [], "port": []}
    jrt.add_callback("Out", lambda evs: got["jax"].extend(tuple(e.data) for e in evs))
    prt.add_callback("Out", lambda evs: got["port"].extend(tuple(e.data) for e in evs))
    jrt.start()
    prt.start()
    jh, ph = jrt.get_input_handler("S"), prt.get_input_handler("S")
    for lo in range(0, 64, 16):
        jh.send_many(rows[lo:lo + 16], timestamps=ts[lo:lo + 16])
    got["jax"].clear()
    jpart = jrt.partitions[0]
    ptable = jax.tree_util.tree_map(np.asarray, jpart.ptable)
    states = {q.query_id: jax.tree_util.tree_map(np.asarray, q.state) for q in jpart.queries}
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    pt, st = partition_state_from_jax(ptable, states, "cpu")
    ppart = prt.partitions[0]
    ppart.ptable = pt
    for q in ppart.queries:
        q.state = st[q.query_id]
        np.testing.assert_equal(state_to_numpy(q.state), states[q.query_id])
    for lo in range(64, 128, 16):
        jh.send_many(rows[lo:lo + 16], timestamps=ts[lo:lo + 16])
        ph.send_many(rows[lo:lo + 16], timestamps=ts[lo:lo + 16])
    assert len(got["jax"]) > 2
    assert bench._rows_match(got["port"], got["jax"])
    for q in jpart.queries:
        np.testing.assert_equal(state_to_numpy(prt.queries[q.query_id].state),
                                jax.tree_util.tree_map(np.asarray, q.state))
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()


REFUSED = {
    # an #inner output of a pattern
    "inner_output": PART.format(body="from every e1=S[price > 90] -> e2=S[price < 10] "
                                "select e1.symbol as s insert into #Inner;"),
    # a pattern stream with no partition key
    "no_key": PART.format(body="from every e1=S[price > 90] -> e2=S2[price < 10] "
                          "select e1.symbol as s insert into Out;"),
    # a table in place of a pattern stream
    "table_stream": "define table T (symbol string);\n" + PART.format(
        body="from every e1=S[price > 90] -> e2=T[symbol == 'x'] select e1.symbol as s "
             "insert into Out;"),
    # an update of a table from a partition
    "table_update": "define table T (s string);\n" + PART.format(
        body="from every e1=S[price > 90] -> e2=S[price < 10] select e1.symbol as s "
             "update T on T.s == s;"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_as_jax_refuses(case):
    ql = _head(16, 8) + REFUSED[case]
    with pytest.raises(jax_errors.SiddhiAppCreationError) as jerr:
        siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql)
    with pytest.raises(port_errors.SiddhiAppCreationError) as perr:
        _port().create_siddhi_app_runtime(ql)
    assert type(perr.value).__name__ == type(jerr.value).__name__
    assert str(perr.value) == str(jerr.value)


def test_used_lanes_equal_jax_after_timer_steps():
    """An absent pattern under playback: after calls that fire TIMER steps,
    every slot holding a key has JAX's token table, selector state and
    TIMER clock, and so has every other slot (TIMER steps step them all,
    as the vmap does); then a key first seen after those steps is
    refreshed and waits its own window, with the same rows."""
    ql = _head(16, 8, playback=True) + PLAYBACK_APPS["absent"]
    rows, ts = _events(96, 4, seed=17, step=4)
    late = [("NEW", 85.0, 5), ("NEW", 50.0, 5), ("K1", 50.0, 5), ("NEW", 90.0, 5),
            ("K2", 50.0, 5)]
    late_ts = [ts[-1] + 100, ts[-1] + 110, ts[-1] + 300, ts[-1] + 310, ts[-1] + 600]
    runs = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        got = []
        rt.add_callback("Out", lambda evs, _g=got: _g.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for lo in range(0, 96, 24):
            h.send_many(rows[lo:lo + 24], timestamps=ts[lo:lo + 24])
        part = rt.partitions[0]
        if _pkg(mgr) == "siddhi_tpu":
            used = np.asarray(part.ptable["used"])
            state = jax.tree_util.tree_map(np.asarray, part.queries[0].state)
        else:
            used = state_to_numpy(part.ptable)["used"]
            state = state_to_numpy(part.queries[0].state)
        n_before = len(got)
        for r, t in zip(late, late_ts):
            h.send(r, timestamp=t)
        rt.shutdown()
        mgr.shutdown()
        runs[_pkg(mgr)] = (used, state, got, n_before)
    (ju, jst, jgot, jn), (pu, pst, pgot, pn) = runs["siddhi_tpu"], runs["siddhi_tpu_torch"]
    np.testing.assert_equal(pu, ju)
    assert ju.sum() == 4 and jn > 2 and jn == pn
    np.testing.assert_equal(jax.tree_util.tree_map(lambda x: x[ju], pst),
                            jax.tree_util.tree_map(lambda x: x[ju], jst))
    np.testing.assert_equal(pst, jst)
    assert ("NEW", 85.0) in jgot[jn:]
    assert bench._rows_match(pgot, jgot)


def test_describe_state():
    ql = _head(16, 8) + APPS["count"]
    rt = _port().create_siddhi_app_runtime(ql)
    rt.start()
    rows, ts = _events(40, 3, seed=2)
    rt.get_input_handler("S").send_many(rows, timestamps=ts)
    d = rt.queries["q"].describe_state()
    assert d["partitions"] == 8 and d["token_capacity"] == 128
    assert d["active_instances"] >= 3  # each used key's arming token at least
    assert [s["refs"] for s in d["states"]] == [["e1"], ["e2"]]
    rt.shutdown()


def test_pattern_beside_a_window_query():
    """A windowed aggregate ahead of an absent-at-start pattern in one block
    under playback, on one key table: every key's slot is allocated by the
    window query, so none is fresh for the pattern, whose lanes must have
    been stepped by the TIMER steps before their keys came (as the vmap
    steps every lane). A key first seen after those steps: the same rows
    from both queries, and every lane of the pattern's state equal to
    JAX's."""
    ql = _head(16, 8, playback=True) + PART.format(body=(
        "@info(name='w') from S#window.length(3) select symbol, avg(price) as ap "
        "insert into Out2;" + Q + PLAYBACK_APPS["absent_first"].split(Q)[1].split("\nend;")[0]))
    rows, ts = _events(120, 4, seed=5, step=4)
    rows += [("LATE", 50.0, 5), ("LATE", 10.0, 5), ("LATE", 95.0, 5), ("LATE", 5.0, 5),
             ("K0", 5.0, 5)]
    ts += [ts[-1] + 200, ts[-1] + 205, ts[-1] + 300, ts[-1] + 600, ts[-1] + 900]
    runs = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        got = {"Out": [], "Out2": []}
        for o in got:
            rt.add_callback(o, lambda evs, _g=got[o]: _g.extend(tuple(e.data) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for lo in range(0, len(rows), 16):
            h.send_many(rows[lo:lo + 16], timestamps=ts[lo:lo + 16])
        q = rt.queries["q"]
        state = (jax.tree_util.tree_map(np.asarray, q.state) if _pkg(mgr) == "siddhi_tpu"
                 else state_to_numpy(q.state))
        rt.shutdown()
        mgr.shutdown()
        runs[_pkg(mgr)] = (got, state)
    (jgot, jst), (pgot, pst) = runs["siddhi_tpu"], runs["siddhi_tpu_torch"]
    assert ("LATE", 10.0) in jgot["Out"] and len(jgot["Out"]) > 2
    assert bench._rows_match(pgot, jgot)
    np.testing.assert_equal(pst, jst)
