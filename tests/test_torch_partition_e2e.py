"""Partitions end to end through both packages on the CPU: the same SiddhiQL
app and events through `siddhi_tpu` (JAX) and `siddhi_tpu_torch`
(device="cpu") — the `partitioned` verify case against VERIFY.json and JAX;
the single-stream tests of tests/test_partition.py and
tests/test_golden_partition.py under their own assertions with the port's
manager swapped in (the join test among them); the row
order of a partitioned length window (rank within the partition, not
arrival); path PT of chip_smoke.py, inner
streams two deep, range partitions, two streams sharing one key table,
every aggregator, table writes and overflowing key tables, at batch 16 and
33, against JAX; a JAX partition state carried in through
`partition_state_from_jax`; the forms a partition took from PR 11 on
against JAX (the sort and frequent windows and joins since the join slice,
the lossyFrequent and cron windows since the aggregation slice, a join
with a table side refused with JAX's class and message), the form left
out (`in <table>`) raising, and a table update, delete or
upsert from a partition refused as JAX refuses it. Floats match to a
relative 2e-4 (bench.py:_rows_match); everything else exactly.
"""

import importlib
import inspect
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
from siddhi_tpu.core.errors import DefinitionNotExistError as JaxDefinitionNotExistError  # noqa: E402,E501
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core import errors as port_errors  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    partition_state_from_jax,
    state_to_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD = "define stream S (symbol string, price float, volume long);\n"


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _managers():
    return siddhi_tpu.SiddhiManager(), _port()


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _feed_rows():
    """bench.py:_leg_verify's 96-event feed."""
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
            for _ in range(96)]
    return ts, rows


def test_partitioned_verify_case():
    ql, sq = bench.VERIFY_TABLE_CASES["partitioned"]
    assert chip_smoke.VERIFY_TABLE_CASES["partitioned"] == (ql, sq)
    ts, rows = _feed_rows()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        got[_pkg(mgr)] = sorted(list(e.data) for e in rt.query(sq))
        rt.shutdown()
        mgr.shutdown()
    with open(os.path.join(ROOT, "VERIFY.json")) as f:
        frozen = json.load(f)["cpu"]["partitioned"]
    assert got["siddhi_tpu_torch"] == frozen
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# ---------------------------------------------------------------------------
# the JAX package's partition tests, on the port
# ---------------------------------------------------------------------------

MODULES = ("tests.test_partition", "tests.test_golden_partition")
# every test of both modules runs on the port (joins inside a partition
# since the join slice); a name here would have to raise "not ported yet"
UNPORTED: set = set()


def _cases():
    cases = []
    for modname in MODULES:
        mod = importlib.import_module(modname)
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("Test") and inspect.isclass(obj):
                cases += [(modname, name, m) for m in sorted(vars(obj)) if m.startswith("test")]
    return cases


def test_every_partition_test_is_covered():
    names = {c[2] for c in _cases()}
    assert UNPORTED <= names and len(names) == 15


@pytest.mark.parametrize("modname,cname,fname", _cases())
def test_jax_partition_test_on_the_port(modname, cname, fname, monkeypatch):
    """The test itself with every SiddhiManager it makes the port's: its own
    assertions hold the port's rows."""
    mod = importlib.import_module(modname)
    for m in {mod, importlib.import_module("tests.test_golden_count")}:
        if hasattr(m, "SiddhiManager"):
            monkeypatch.setattr(m, "SiddhiManager", _port)
    monkeypatch.setattr(siddhi_tpu, "SiddhiManager", _port)  # in-test imports
    monkeypatch.setattr(mod, "SiddhiAppCreationError", port_errors.SiddhiAppCreationError,
                        raising=False)
    fn = getattr(getattr(mod, cname)(), fname)
    if fname in UNPORTED:
        with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
            fn()
    else:
        fn()


# ---------------------------------------------------------------------------
# the row order of a partitioned length window
# ---------------------------------------------------------------------------

ORDER_APP = """@app:batch(size='16') @app:partitionCapacity(size='8')
define stream S (symbol string, price float, volume long);
partition with (symbol of S) begin
from S{window} select symbol, price, sum(volume) as t insert into Out;
end;"""
ORDER_ROWS = [("B", 1.0, 1), ("A", 2.0, 2), ("A", 3.0, 3), ("A", 4.0, 4), ("B", 5.0, 5),
              ("C", 6.0, 6), ("A", 7.0, 7)]


@pytest.mark.parametrize("window,want", [
    # rank within the partition, then slot: the JAX package's _flatten of
    # the vmapped [P, 2B] output (position first), not the arrival order
    ("#window.length(2)", [("B", 1.0, 1), ("A", 2.0, 2), ("C", 6.0, 6), ("B", 5.0, 6),
                           ("A", 3.0, 5), ("A", 4.0, 7), ("A", 7.0, 11)]),
    # no window: the position is the row, so the arrival order
    ("", [("B", 1.0, 1), ("A", 2.0, 2), ("A", 3.0, 5), ("A", 4.0, 9), ("B", 5.0, 6),
          ("C", 6.0, 6), ("A", 7.0, 16)]),
])
def test_partitioned_row_order(window, want):
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ORDER_APP.format(window=window))
        got = []
        rt.add_callback("Out", lambda evs, _g=got: _g.extend(tuple(e.data) for e in evs))
        rt.start()
        rt.get_input_handler("S").send_many(ORDER_ROWS, timestamps=list(range(1, 8)))
        rt.shutdown()
        assert bench._rows_match(got, want), (_pkg(mgr), got)


# ---------------------------------------------------------------------------
# apps through both packages
# ---------------------------------------------------------------------------

PART = "partition with (symbol of S) begin\n{body}\nend;"
APPS = {
    "inner_two_deep": PART.format(body=(
        "@info(name='a') from S[price > 10] select symbol, price, sum(volume) as t "
        "insert into #A;"
        "@info(name='b') from #A#window.length(3) select symbol, t, min(price) as lo, "
        "avg(price) as ap insert all events into #B;"
        "@info(name='q') from #B[t > 100] select symbol, t, lo, ap insert into Out;")),
    "every_aggregator": PART.format(body=(
        "@info(name='q') from S#window.length(4) select symbol, sum(volume) as s, "
        "count() as n, avg(price) as ap, stdDev(price) as sd, min(volume) as lo, "
        "max(price) as hi, minForever(price) as mf, maxForever(volume) as xf, "
        "distinctCount(volume) as dc insert all events into Out;")),
    "windowless_aggregators": PART.format(body=(
        "@info(name='q') from S[volume > 100] select symbol, sum(price) as s, count() as n, "
        "stdDev(price) as sd, min(price) as lo, max(volume) as hi, maxForever(price) as xf "
        "having n > 1 insert into Out;")),
    "expired_only": PART.format(body=(
        "@info(name='q') from S#window.length(2) select symbol, price, avg(price) as ap "
        "insert expired events into Out;")),
    "range": (
        "partition with (price < 30 as 'low' or price < 70 as 'mid' or volume > 500 as 'vol' "
        "of S) begin @info(name='q') from S#window.length(3) select symbol, price, "
        "max(price) as hi, count() as n insert into Out; end;"),
    "volume_key": (
        "partition with (volume % 5 of S) begin @info(name='q') from S select symbol, "
        "volume, sum(price) as s insert into Out; end;"),
    "float_key": (
        "partition with (price of S) begin @info(name='q') from S#window.length(2) "
        "select symbol, price, count() as n insert into Out; end;"),
    "bool_key": (
        "partition with (price > 50 of S) begin @info(name='q') from S select symbol, "
        "avg(price) as ap, count() as n insert into Out; end;"),
    "table_write": (
        "define table T (symbol string, ap double, n long);"
        "partition with (symbol of S) begin @info(name='q') from S#window.length(3) "
        "select symbol, avg(price) as ap, count() as n insert into T; end;"),
    "outer_after": PART.format(body=(
        "@info(name='a') from S#window.length(2) select symbol, sum(volume) as t insert into Mid;"))
        + "@info(name='q') from Mid[t > 500] select symbol, t insert into Out;",
}
TWO_STREAMS = """@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')
define stream A (symbol string, price float, volume long);
define stream B (symbol string, price float, volume long);
partition with (symbol of A, symbol of B) begin
  @info(name='qa') from A#window.length(2) select symbol, sum(volume) as t insert into OutA;
  @info(name='qb') from B select symbol, count() as n, max(price) as hi insert into OutB;
end;"""


def _events(n: int, symbols: int, seed: int):
    rng = np.random.default_rng(seed)
    names = [f"K{i}" for i in range(symbols)]
    rows = [(names[int(rng.integers(0, symbols))], float(np.float32(rng.uniform(0, 100))),
             int(rng.integers(1, 1000))) for _ in range(n)]
    return rows, [1_700_000_000_000 + 3 * i for i in range(n)]


def _run(mgr, ql, feeds, chunk, outs=("Out",), table=None):
    """Deliver `feeds` [(stream, rows, timestamps)] in send_many calls of
    `chunk` events (one event per send at chunk 1), interleaving streams
    call by call; returns the rows of each output stream (or the table)."""
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
                if chunk == 1:
                    hs[sid].send(rows[lo], timestamp=ts[lo])
                else:
                    hs[sid].send_many(rows[lo:lo + chunk], timestamps=ts[lo:lo + chunk])
    if table is not None:
        got = {table: [list(e.data) for e in rt.query(f"from {table} select *")]}
    rt.shutdown()
    mgr.shutdown()
    return got


def _head(batch: int, cap: int) -> str:
    return f"@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}')\n" + HEAD


@pytest.mark.parametrize("batch", [16, 33])
@pytest.mark.parametrize("case", sorted(APPS) + ["pt"])
def test_app_matches_jax(case, batch):
    """Each app at its batch size, in calls of 2.5 batches and capacity 16
    over 12 keys (the PT app at its own window and capacity)."""
    if case == "pt":
        ql = chip_smoke.PT_APP.format(batch=batch, cap=16, w=5).replace("StockStream", "S")
    else:
        ql = _head(batch, 16) + APPS[case]
    rows, ts = _events(5 * batch, 12, seed=batch + len(case))
    table = "T" if case == "table_write" else None
    got = {_pkg(m): _run(m, ql, [("S", rows, ts)], 5 * batch // 2,
                         outs=() if table else ("Out",), table=table)
           for m in _managers()}
    want = got["siddhi_tpu"]
    assert sum(len(v) for v in want.values()) > 10
    if table is not None:
        want = {k: sorted(v) for k, v in want.items()}
        got["siddhi_tpu_torch"] = {k: sorted(v) for k, v in got["siddhi_tpu_torch"].items()}
    assert bench._rows_match(got["siddhi_tpu_torch"], want)


@pytest.mark.parametrize("chunk", [1, 16])
def test_two_streams_share_one_key_table(chunk):
    """`symbol of A, symbol of B`: one key table, so a key first seen on B
    keeps its slot for A; calls alternate between the streams."""
    ql = TWO_STREAMS.format(batch=16, cap=8)
    ra, ta = _events(48, 6, seed=1)
    rb, tb = _events(40, 9, seed=2)
    got = {_pkg(m): _run(m, ql, [("A", ra, ta), ("B", rb, tb)], chunk, outs=("OutA", "OutB"))
           for m in _managers()}
    assert len(got["siddhi_tpu"]["OutA"]) > 40 and len(got["siddhi_tpu"]["OutB"]) > 30
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("case", ["pt", "every_aggregator"])
def test_overflow_matches_jax_and_logs_once(case, caplog):
    """A key table of 4 over 12 keys: the rows of keys past capacity are
    dropped in both packages, and the port logs the overflow once."""
    if case == "pt":
        ql = chip_smoke.PT_APP.format(batch=16, cap=4, w=3).replace("StockStream", "S")
    else:
        ql = _head(16, 4) + APPS[case]
    rows, ts = _events(80, 12, seed=7)
    jax_rows = _run(siddhi_tpu.SiddhiManager(), ql, [("S", rows, ts)], 40)
    with caplog.at_level(logging.ERROR):
        port_rows = _run(_port(), ql, [("S", rows, ts)], 40)
    assert jax_rows["Out"] and bench._rows_match(port_rows, jax_rows)
    msgs = [r.message for r in caplog.records if r.name.startswith("siddhi_tpu_torch")
            and "partition key table overflowed" in r.message]
    assert len(msgs) == 1 and "@app:partitionCapacity" in msgs[0]
    assert {r[0] for r in port_rows["Out"]} <= {f"K{i}" for i in range(12)}


def test_jax_partition_state_carried_in():
    """Four calls through JAX, its key table and [P]-tiled query states
    (and the interned strings) into the port, then four more calls through
    both: equal rows, and equal states after."""
    ql = _head(16, 16) + APPS["inner_two_deep"]
    rows, ts = _events(128, 10, seed=21)
    jmgr, pmgr = _managers()
    jrt = jmgr.create_siddhi_app_runtime(ql)
    prt = pmgr.create_siddhi_app_runtime(ql)
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
    assert len(got["jax"]) > 10
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(state_to_numpy(ppart.ptable),
                            jax.tree_util.tree_map(np.asarray, jpart.ptable))
    for q in jpart.queries:
        want = jax.tree_util.tree_map(np.asarray, q.state)
        have = state_to_numpy(prt.queries[q.query_id].state)
        np.testing.assert_equal(have["chain"], want["chain"])
        for h, w in zip(jax.tree_util.tree_leaves(have["sel"]),
                        jax.tree_util.tree_leaves(want["sel"]), strict=True):
            np.testing.assert_allclose(h.astype(np.float64), w.astype(np.float64), rtol=2e-4)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()


def test_inner_query_callback_sees_its_rows():
    """A query inserting into an #inner stream still delivers to its own
    query callback (siddhi_tpu/core/partition.py `_route`)."""
    ql = _head(16, 8) + APPS["inner_two_deep"]
    rows, ts = _events(48, 5, seed=3)
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        out = got.setdefault(_pkg(mgr), [])
        rt.add_callback("b", lambda t, i, r, _o=out: _o.extend(
            [("+",) + tuple(e.data) for e in i or []] + [("-",) + tuple(e.data) for e in r or []]))
        rt.start()
        rt.get_input_handler("S").send_many(rows, timestamps=ts)
        rt.shutdown()
    assert any(r[0] == "-" for r in got["siddhi_tpu"])
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# forms a partition took from PR 11 on: each against JAX (the time window
# under playback)
FORMERLY_LEFT_OUT = [
    "from S#window.lengthBatch(4) select symbol, sum(volume) as t insert into Out;",
    "from S#window.time(1 sec) select symbol, sum(volume) as t insert into Out;",
    "from S select symbol, sum(volume) as t group by symbol insert into Out;",
    "from S select symbol, price order by price insert into Out;",
    "from S select symbol, price limit 2 insert into Out;",
    "from S select symbol, price output last every 3 events insert into Out;",
    "from S#pol2Cart(price, price) select symbol, x insert into Out;",
]


@pytest.mark.parametrize("body", FORMERLY_LEFT_OUT)
def test_formerly_left_out_forms_match_jax(body):
    playback = "@app:playback\n" if "time(" in body else ""
    ql = playback + _head(16, 8) + PART.format(body=body)
    rows, ts = _events(48, 6, seed=len(body))
    got = {_pkg(m): _run(m, ql, [("S", rows, ts)], 20) for m in _managers()}
    assert len(got["siddhi_tpu"]["Out"]) > 3
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("body", [
    "from every e1=S[price > 90] -> e2=S[price < 10] select e1.symbol as s insert into Out;",
    "from e1=S[price > 90], e2=S[price < 10] select e1.symbol as s insert into Out;",
    "from every e1=S[price > 90] -> not S[price < 10] for 1 sec select e1.symbol as s "
    "insert into Out;",
])
def test_formerly_left_out_patterns_match_jax(body):
    """The pattern forms a partition takes: a pattern, a sequence and an
    absent pattern (under playback) per key, as JAX delivers them."""
    ql = "@app:playback\n" + _head(16, 8) + PART.format(body=body)
    rows, ts = _events(48, 6, seed=len(body))
    got = {_pkg(m): _run(m, ql, [("S", rows, ts)], 20) for m in _managers()}
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# forms a partition took from the join slice on (sort and frequent windows,
# joins): each against JAX
FORMERLY_LEFT_OUT_JOINS = [
    "from S#window.sort(3, price) select symbol insert into Out;",
    "from S#window.frequent(2, symbol) select symbol insert into Out;",
    "from S#window.frequent(3, symbol) select symbol, sum(volume) as t group by symbol "
    "insert into Out;",
    "from S#window.length(2) as a join S#window.length(2) as b on a.volume == b.volume "
    "select a.symbol insert into Out;",
    "from S as a unidirectional join S#window.lengthBatch(2) as b on a.volume == b.volume "
    "select a.symbol insert into Out;",
]


@pytest.mark.parametrize("body", FORMERLY_LEFT_OUT_JOINS)
def test_formerly_left_out_joins_and_windows_match_jax(body):
    ql = _head(16, 8) + PART.format(body=body)
    rows, ts = _events(48, 6, seed=len(body))
    rows = [(r[0], r[1], r[2] % 3) for r in rows]  # repeated volumes: the joins match
    got = {_pkg(m): _run(m, ql, [("S", rows, ts)], 20) for m in _managers()}
    assert len(got["siddhi_tpu"]["Out"]) > 3
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_time_window_join_on_table_raises_as_jax():
    """A join with a table side inside a partition: both packages refuse it
    with the same class and message (only plain streams join there)."""
    ql = (_head(16, 8) + "define table T (symbol string);\n" + PART.format(
        body="from S#window.time(1 sec) as a join T on a.symbol == T.symbol select a.symbol "
             "insert into Out;"))
    msgs = {}
    for mgr in _managers():
        with pytest.raises(Exception) as e:
            mgr.create_siddhi_app_runtime(ql)
        msgs[_pkg(mgr)] = (type(e.value).__name__, str(e.value))
    assert msgs["siddhi_tpu_torch"] == msgs["siddhi_tpu"]


# forms a partition took from the aggregation slice on (the lossyFrequent
# and cron windows, a lossyFrequent join side): each against JAX, the cron
# window under playback with its one-second fires reaching every partition
FORMERLY_LEFT_OUT_SPECIAL = [
    "from S#window.lossyFrequent(0.1, 0.01, symbol) select symbol insert into Out;",
    "from S#window.cron('*/1 * * * * ?') select symbol insert into Out;",
    "from S#window.length(2) as a join S#window.lossyFrequent(0.1, 0.01, volume) as b "
    "on a.volume == b.volume select a.symbol insert into Out;",
]


@pytest.mark.parametrize("body", FORMERLY_LEFT_OUT_SPECIAL)
def test_formerly_left_out_special_windows_match_jax(body):
    ql = ("@app:playback\n" if "cron" in body else "") + _head(16, 8) + PART.format(body=body)
    rows, _ts = _events(96, 6, seed=len(body))
    rows = [(r[0], r[1], r[2] % 3) for r in rows]  # repeated volumes: the join matches
    ts = [1_700_000_000_000 + 37 * i for i in range(96)]  # 3.5 s: cron fires
    got = {_pkg(m): _run(m, ql, [("S", rows, ts)], 20) for m in _managers()}
    assert len(got["siddhi_tpu"]["Out"]) > 10
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("body", [
    "from S[(T.symbol == symbol) in T] select symbol, price insert into Out;",
])
def test_left_out_forms_raise(body):
    """`in <table>` inside a partition: both packages raise JAX's KeyError
    (JAX compiles an inner query with no table in scope), message for
    message."""
    ql = _head(16, 8) + "define table T (symbol string);\n" + PART.format(body=body)
    msgs = []
    for mgr in _managers():
        with pytest.raises(KeyError) as ei:
            mgr.create_siddhi_app_runtime(ql)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == str(KeyError("'in T': no such table in scope"))


@pytest.mark.parametrize("window", ["", "#window.length(2)"])
@pytest.mark.parametrize("output", [
    "update T on T.symbol == symbol",
    "delete T on T.symbol == symbol",
    "update or insert into T on T.symbol == symbol",
])
def test_partitioned_table_mutation_raises_as_jax(window, output):
    """`update`, `delete` and `update or insert into` a table from inside a
    partition: the JAX package compiles the inner query with no table in
    scope, so both packages refuse the app with the same error class and
    message (the reference's TablePartitionTestCase runs them)."""
    ql = (_head(16, 8) + "define table T (symbol string, t long);\n"
          + PART.format(body=f"from S{window} select symbol, sum(volume) as t {output};"))
    msgs = {}
    for mgr in _managers():
        err = (JaxDefinitionNotExistError if _pkg(mgr) == "siddhi_tpu"
               else port_errors.DefinitionNotExistError)
        with pytest.raises(err) as info:
            mgr.create_siddhi_app_runtime(ql)
        msgs[_pkg(mgr)] = str(info.value)
        mgr.shutdown()
    assert msgs["siddhi_tpu_torch"] == msgs["siddhi_tpu"] == "'T' is not a defined table"
