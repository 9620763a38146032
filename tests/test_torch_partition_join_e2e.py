"""Joins and the sort and frequent windows inside a partition, end to end
through both packages on the CPU: the same SiddhiQL app and events through
`siddhi_tpu` (JAX) and `siddhi_tpu_torch` (device="cpu"), compared with
`bench._rows_match` (floats within a relative 2e-4, the rest exact, the
same row order): two-stream joins and self-joins; inner, left, right and
full outer joins; `insert all events` (EXPIRED probes); lengthBatch,
externalTime, sort and frequent sides; a unidirectional side; a range
partition; group-by with aggregators over the joined rows of each
partition; a slot overflowing `@app:joinCapacity`; keys past the
partition capacity; chip_smoke.py's paths PJ, PSW and PFQ at a small size;
and a JAX partitioned join state carried in through
`interop.partition_state_from_jax`. At batch 16; the full outer join with
`insert all events` also at 33.
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
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    partition_state_from_jax,
    state_to_numpy,
)
from tests.test_torch_partition_e2e import _managers, _pkg, _port, _run  # noqa: E402

HEAD = """@app:batch(size='{batch}') @app:partitionCapacity(size='{cap}') {extra}
define stream A (symbol string, price float, volume long, ets long);
define stream B (symbol string, price float, volume long, ets long);
"""
BOTH = "partition with (symbol of A, symbol of B) begin @info(name='q') {body} end;"
SELF = "partition with (symbol of A) begin @info(name='q') {body} end;"
SEL = "select a.symbol as s, a.price as ap, b.price as bp, b.volume as bv"
APPS = {
    "inner": BOTH.format(body=(
        "from A#window.length(3) as a join B#window.length(4) as b on a.volume == b.volume "
        f"{SEL} insert into Out;")),
    "left_outer": BOTH.format(body=(
        "from A#window.length(2) as a left outer join B#window.length(3) as b "
        f"on a.volume == b.volume and b.price > 20 {SEL} insert into Out;")),
    "right_outer": BOTH.format(body=(
        "from A#window.length(3) as a right outer join B#window.length(2) as b "
        "on a.volume == b.volume select b.symbol as s, a.price as ap, b.price as bp "
        "insert into Out;")),
    "full_outer_all": BOTH.format(body=(
        "from A#window.length(3) as a full outer join B#window.length(3) as b "
        "on a.volume == b.volume select a.symbol as s, b.symbol as t, a.price as ap, "
        "b.price as bp insert all events into Out;")),
    "self_join": SELF.format(body=(
        "from A#window.length(3) as a join A#window.length(3) as b on a.volume == b.volume "
        f"{SEL} insert all events into Out;")),
    "self_unidirectional": SELF.format(body=(
        "from A as a unidirectional join A#window.lengthBatch(3) as b "
        f"on a.volume == b.volume {SEL} insert into Out;")),
    "length_batch": BOTH.format(body=(
        "from A#window.lengthBatch(3) as a join B#window.length(3) as b "
        f"on a.volume == b.volume {SEL} insert all events into Out;")),
    "external_time": BOTH.format(body=(
        "from A#window.externalTime(ets, 40) as a join B#window.externalTime(ets, 30) as b "
        f"on a.volume == b.volume {SEL} insert all events into Out;")),
    "sort_side": BOTH.format(body=(
        "from A#window.sort(3, price, 'desc') as a join B#window.length(3) as b "
        f"on a.volume == b.volume {SEL} insert all events into Out;")),
    "frequent_side": BOTH.format(body=(
        "from A#window.length(3) as a right outer join B#window.frequent(2, volume) as b "
        "on a.volume == b.volume select b.symbol as s, a.price as ap, b.price as bp "
        "insert all events into Out;")),
    "range": (
        "partition with (price < 50 as 'low' or price >= 50 as 'high' of A, "
        "volume < 3 as 'low' or volume >= 3 as 'high' of B) begin @info(name='q') "
        "from A#window.length(3) as a join B#window.length(3) as b on a.volume == b.volume "
        f"{SEL} insert into Out; end;"),
    "group_by": BOTH.format(body=(
        "from A#window.length(4) as a join B#window.length(4) as b on a.volume == b.volume "
        "select a.symbol as s, b.volume as v, sum(a.price) as t, count() as n, "
        "max(b.price) as hi group by b.volume having n > 1 insert into Out;")),
    "overflow": BOTH.format(body=(
        "from A#window.length(8) as a join B#window.length(8) as b "
        f"{SEL} insert into Out;")),
}
EXTRA = {"overflow": "@app:joinCapacity(size='5')"}


def _events(n: int, symbols: int, seed: int):
    """Rows (symbol, price, volume in 1..5, ets) with 3 ms ticks; ets runs
    with the ticks (a few disordered)."""
    rng = np.random.default_rng(seed)
    names = [f"K{i}" for i in range(symbols)]
    ts = [1_700_000_000_000 + 3 * i for i in range(n)]
    rows = [(names[int(rng.integers(0, symbols))], float(np.float32(rng.uniform(0, 100))),
             int(rng.integers(1, 6)), int(ts[i] - 1_700_000_000_000 + rng.integers(-4, 2)))
            for i in range(n)]
    return rows, ts


def _two_feeds(batch: int, seed: int):
    ra, ta = _events(5 * batch, 7, seed)
    rb, tb = _events(4 * batch, 9, seed + 1)
    return [("A", ra, ta), ("B", rb, tb)]


@pytest.mark.parametrize("case,batch", [(c, 16) for c in sorted(APPS)]
                         + [("full_outer_all", 33)])
def test_join_app_matches_jax(case, batch):
    """Calls of 1.5 batches alternating between the streams; a 6-slot key
    table over 7 and 9 symbols (keys past capacity join nothing)."""
    ql = HEAD.format(batch=batch, cap=6, extra=EXTRA.get(case, "")) + APPS[case]
    feeds = _two_feeds(batch, seed=len(case) + batch)
    if case.startswith("self"):
        feeds = feeds[:1]
    got = {_pkg(m): _run(m, ql, feeds, 3 * batch // 2) for m in _managers()}
    assert len(got["siddhi_tpu"]["Out"]) > 10
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("path", sorted(chip_smoke.PJ_APPS))
def test_chip_smoke_path_small(path):
    """chip_smoke.py's PJ, PSW and PFQ at batch 32, capacity 16 over 12
    symbols (PJ: Trades and Quotes alternating call by call)."""
    ql = chip_smoke.partition_join_app(path, 32, 16)
    rng = np.random.default_rng(8)
    names = [f"SYM{i:02d}" for i in range(12)]

    def feed(n, seed, vmax):
        r = np.random.default_rng(seed)
        return ([(names[int(r.integers(0, 12))], float(np.float32(r.uniform(0, 100))),
                  int(r.integers(1, vmax))) for _ in range(n)],
                [1_700_000_000_000 + i for i in range(n)])

    if path == "PJ":
        (rt_, tt), (rq, tq) = feed(160, 7, 20), feed(160, 8, 20)
        feeds = [("Trades", rt_, tt), ("Quotes", rq, tq)]
    else:
        rows, ts = feed(256, 7, 8 if path == "PFQ" else 1000)
        feeds = [("StockStream", rows, ts)]
    del rng
    got = {_pkg(m): _run(m, ql, feeds, 32) for m in _managers()}
    assert len(got["siddhi_tpu"]["Out"]) > 20
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_jax_join_state_carried_in():
    """Three calls a stream through JAX, its key table and [P]-tiled join
    state (both rings, the selector's carries) and the interned strings
    into the port, then three more through both: equal rows, and equal
    states after."""
    ql = HEAD.format(batch=16, cap=8, extra="") + APPS["group_by"]
    (_a, ra, ta), (_b, rb, tb) = _two_feeds(16, seed=5)
    jmgr, pmgr = _managers()
    jrt = jmgr.create_siddhi_app_runtime(ql)
    prt = pmgr.create_siddhi_app_runtime(ql)
    got = {"jax": [], "port": []}
    jrt.add_callback("Out", lambda evs: got["jax"].extend(tuple(e.data) for e in evs))
    prt.add_callback("Out", lambda evs: got["port"].extend(tuple(e.data) for e in evs))
    jrt.start()
    prt.start()
    hs = {rt: (rt.get_input_handler("A"), rt.get_input_handler("B")) for rt in (jrt, prt)}

    def send(rt, lo):
        ha, hb = hs[rt]
        ha.send_many(ra[lo:lo + 16], timestamps=ta[lo:lo + 16])
        hb.send_many(rb[lo:lo + 16], timestamps=tb[lo:lo + 16])

    for lo in range(0, 48, 16):
        send(jrt, lo)
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
    for lo in range(48, 96, 16):
        send(jrt, lo)
        send(prt, lo)
    assert len(got["jax"]) > 5
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(state_to_numpy(ppart.ptable),
                            jax.tree_util.tree_map(np.asarray, jpart.ptable))
    want = jax.tree_util.tree_map(np.asarray, jpart.queries[0].state)
    have = state_to_numpy(ppart.queries[0].state)
    np.testing.assert_equal(have["join"], want["join"])
    for h, w in zip(jax.tree_util.tree_leaves(have["sel"]), jax.tree_util.tree_leaves(want["sel"]),
                    strict=True):
        np.testing.assert_allclose(h.astype(np.float64), w.astype(np.float64), rtol=2e-4)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()


@pytest.mark.parametrize("window", ["sort(3, price)", "frequent(2, volume)"])
def test_special_window_state_carried_in(window):
    """A [P]-tiled sort or frequent window state from JAX into the port:
    the same rows after, and the same state."""
    ql = (HEAD.format(batch=16, cap=8, extra="") + SELF.format(
        body=f"from A#window.{window} select symbol, price, count() as n "
             "insert all events into Out;"))
    (_a, ra, ta), _b = _two_feeds(16, seed=9)
    jmgr, pmgr = _managers()
    jrt, prt = (m.create_siddhi_app_runtime(ql) for m in (jmgr, pmgr))
    got = {"jax": [], "port": []}
    jrt.add_callback("Out", lambda evs: got["jax"].extend(tuple(e.data) for e in evs))
    prt.add_callback("Out", lambda evs: got["port"].extend(tuple(e.data) for e in evs))
    jrt.start()
    prt.start()
    jh, ph = jrt.get_input_handler("A"), prt.get_input_handler("A")
    jh.send_many(ra[:32], timestamps=ta[:32])
    got["jax"].clear()
    jpart = jrt.partitions[0]
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    pt, st = partition_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jpart.ptable),
        {q.query_id: jax.tree_util.tree_map(np.asarray, q.state) for q in jpart.queries}, "cpu")
    prt.partitions[0].ptable = pt
    for q in prt.partitions[0].queries:
        q.state = st[q.query_id]
    jh.send_many(ra[32:80], timestamps=ta[32:80])
    ph.send_many(ra[32:80], timestamps=ta[32:80])
    assert len(got["jax"]) > 10
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(state_to_numpy(prt.partitions[0].queries[0].state["chain"]),
                            jax.tree_util.tree_map(np.asarray,
                                                   jpart.queries[0].state["chain"]))
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()


@pytest.mark.parametrize("body,match", [
    ("from A#window.time(1 sec) as a join B#window.length(2) as b on a.volume == b.volume "
     "select a.symbol insert into Out;", "time windows on join sides"),
    ("from A#window.length(2) as a join B#window.cron('*/1 * * * * ?') as b "
     "on a.volume == b.volume select a.symbol insert into Out;", "time windows on join sides"),
    ("from A#window.length(2) as a join T on a.symbol == T.symbol select a.symbol "
     "insert into Out;", "only plain streams"),
    ("from A#window.length(2) as a join B#window.length(2) as b on a.volume == b.volume "
     "select a.symbol as s insert into #I;", "#inner outputs"),
])
def test_join_refusals_as_jax(body, match):
    """The forms JAX refuses inside a partition: the port raises the same
    class with the same message."""
    ql = (HEAD.format(batch=16, cap=8, extra="") + "define table T (symbol string);\n"
          + BOTH.format(body=body))
    msgs = {}
    for mgr in _managers():
        with pytest.raises(Exception) as e:
            mgr.create_siddhi_app_runtime(ql)
        msgs[_pkg(mgr)] = (type(e.value).__name__, str(e.value))
    assert msgs["siddhi_tpu_torch"] == msgs["siddhi_tpu"]
    assert match in msgs["siddhi_tpu"][1]


def test_self_join_sees_keys_the_left_side_allocated():
    """A self-join runs its left side, then its right side, on each batch;
    the right side's slot assignment sees the keys the left one allocated
    (one key table), so both sides of a key share its slot."""
    ql = HEAD.format(batch=8, cap=3, extra="") + APPS["self_join"]
    rows = [("K1", 1.0, 2, 0), ("K2", 2.0, 2, 1), ("K1", 3.0, 2, 2), ("K3", 4.0, 2, 3),
            ("K4", 5.0, 2, 4), ("K2", 6.0, 2, 5)]
    ts = list(range(1, 7))
    got = {_pkg(m): _run(m, ql, [("A", rows, ts)], 6) for m in (_port(),
                                                                  siddhi_tpu.SiddhiManager())}
    assert got["siddhi_tpu_torch"] == got["siddhi_tpu"]
    assert {r[0] for r in got["siddhi_tpu_torch"]["Out"]} == {"K1", "K2", "K3"}
    assert siddhi_tpu_torch.__name__ == "siddhi_tpu_torch"
