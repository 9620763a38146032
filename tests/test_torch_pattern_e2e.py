"""Patterns and sequences end to end through both packages, live, on the
CPU: the same SiddhiQL app and the same events go through `siddhi_tpu`
(JAX) and `siddhi_tpu_torch` (device="cpu"), and the delivered rows must
match in order — bench.py's pattern_2state and count_sequence apps, the
verify cases, the batch-route apps of test_pattern_differential.py (also
against the JAX package's per-event scan, whose order within one timestamp
may differ), and every app of test_pattern.py and of the every / sequence /
count / within golden corpora, each of which runs on the port (by a batch
route or by the per-event scan, as in the JAX package), equals the JAX
package and passes its golden assertions. Floats match to a relative 2e-4
(bench.py:_rows_match); everything else exactly.
"""

import importlib
import inspect
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
import siddhi_tpu.core.pattern as jax_pattern  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    state_from_numpy,
    state_to_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _managers():
    return siddhi_tpu.SiddhiManager(), siddhi_tpu_torch.SiddhiManager(device="cpu")


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _collector(rows: list):
    return lambda t, ins, rem: rows.extend(("+",) + tuple(e.data) for e in ins or [])


def _verify_feed():
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
            for _ in range(96)]
    return ts, rows


@pytest.mark.parametrize("case", ["pattern_within", "count_seq"])
def test_verify_case(case):
    """bench.py's verify cases over the 96-event feed, one event per send,
    against the live JAX package and the frozen rows of VERIFY.json."""
    ts, rows = _verify_feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_CASES[case])
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
        frozen = json.load(f)["cpu"][case]
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
    assert bench._rows_match(got["siddhi_tpu_torch"], frozen)


# ---------------------------------------------------------------------------
# bench.py pattern_2state and count_sequence (BASELINE.json configs 4 and 5)
# ---------------------------------------------------------------------------


def _send_stock(rt, mgr, data, lo, hi, fused=True, calls=1, stream="StockStream"):
    for s in data["names"]:
        mgr.interner.intern(str(s))
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    h = rt.get_input_handler(stream)
    step = -(-(hi - lo) // calls)
    for c in range(lo, hi, step):
        e = min(c + step, hi)
        h.send_columns(data["ts"][c:e], {k: data[k][c:e] for k in ("symbol", "price", "volume")},
                       now=0)


def _run(mgr, app, data, n, fused, calls=1):
    rows, deliveries = [], [0]

    def cb(t, ins, rem):
        deliveries[0] += 1
        rows.extend(("+",) + tuple(e.data) for e in ins or [])

    rt = mgr.create_siddhi_app_runtime(app)
    rt.add_callback("q", cb)
    rt.start()
    _send_stock(rt, mgr, data, 0, n, fused=fused, calls=calls)
    fi = rt.junctions["StockStream"].fused_ingest
    fused_batches = fi.batches_fused if fi is not None else 0
    rt.shutdown()
    mgr.shutdown()
    return rows, deliveries[0], fused_batches


@pytest.mark.parametrize("batch", [32, 33, 4096])
@pytest.mark.parametrize("name", ["pattern_2state", "count_sequence"])
def test_bench_pattern_app(name, batch):
    """The port (fused where the call holds 2+ batches) against the JAX
    package's per-batch form, at batch 32, 33 and 4096."""
    n = 3 * 4096 + 77 if batch == 4096 else 60 * batch + 7
    data = bench._make_stock_data(n, seed=7)
    app = f"@app:batch(size='{batch}')\n" + bench.WORKLOADS[name][0]
    want, _, _ = _run(siddhi_tpu.SiddhiManager(), app, data, n, fused=False)
    got, _, fused = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), app, data, n, fused=True)
    assert fused > 0
    assert len(want) > 40
    assert got == want


def test_fused_equals_per_batch_equals_jax_per_batch():
    """pattern_2state at batch 64 with a small token table (chunks of 32, so
    forks, completions, the within purge and the chunk loop all run many
    times a batch): port fused = port per batch = JAX per batch, callback
    for callback; the JAX package's fused form delivers the same rows."""
    n = 40 * 64
    data = bench._make_stock_data(n, seed=3)
    app = "@app:batch(size='64')\n" + bench.WORKLOADS["pattern_2state"][0].replace(
        "size='4096'", "size='64'")
    seqs = {}
    for label, mk, fused in (
            ("port_fused", lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"), True),
            ("port_per_batch", lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"), False),
            ("jax_per_batch", siddhi_tpu.SiddhiManager, False),
            ("jax_fused", siddhi_tpu.SiddhiManager, True)):
        rows, calls, fused_batches = _run(mk(), app, data, n, fused)
        assert (fused_batches > 0) == fused
        seqs[label] = (rows, calls)
    assert len(seqs["jax_per_batch"][0]) > 30
    assert seqs["port_fused"] == seqs["port_per_batch"] == seqs["jax_per_batch"]
    assert seqs["jax_fused"][0] == seqs["jax_per_batch"][0]


TWO_STREAM_PATTERN = """
@app:batch(size='32')
define stream StockStream (symbol string, price float, volume long);
define stream Other (symbol string, price float, volume long);
@info(name='q')
from every a=StockStream[price > 70] -> b=Other[price < a.price and volume > 300]
within 200 milliseconds
select a.symbol as sa, b.symbol as sb, b.price as pb
insert into Out;
"""


def test_two_stream_pattern_fused_equals_per_batch():
    """A pattern over two streams, one fused endpoint on each over one token
    table: the port's fused callback sequence equals its per-batch one and
    the JAX package's, the streams alternating 3 batches a call."""
    data = bench._make_stock_data(6 * 32 * 2, seed=4)
    got = {}
    for label, mgr, fused in (("fused", siddhi_tpu_torch.SiddhiManager(device="cpu"), True),
                              ("per_batch", siddhi_tpu_torch.SiddhiManager(device="cpu"), False),
                              ("jax", siddhi_tpu.SiddhiManager(), False)):
        rt = mgr.create_siddhi_app_runtime(TWO_STREAM_PATTERN)
        out = got.setdefault(label, [])
        rt.add_callback("q", lambda t, ins, rem, _o=out: _o.append(
            [tuple(e.data) for e in ins or []]))
        rt.start()
        half = 6 * 32
        for k in range(2):
            lo = k * half // 2
            _send_stock(rt, mgr, data, lo, lo + half // 2, fused=fused)
            _send_stock(rt, mgr, data, half + lo, half + lo + half // 2, fused=fused,
                        stream="Other")
        for name in ("StockStream", "Other"):
            fi = rt.junctions[name].fused_ingest
            assert (fi is not None and fi.batches_fused > 0) == fused
        rt.shutdown()
        mgr.shutdown()
    assert sum(len(d) for d in got["jax"]) > 5
    assert got["fused"] == got["per_batch"]
    assert bench._rows_match(got["fused"], got["jax"])


# the bench apps with a rarer last state, so that many tokens are pending
# at any time, and a smaller token table
DENSE_EDITS = {
    "pattern_2state": (("size='4096'", "size='256'"), ("price < 5", "price < 0.5")),
    "count_sequence": (("size='512'", "size='64'"), ("size='8192'", "size='32'"),
                       ("price < 10", "price < 1")),
}


def _dense_app(name: str, batch: int) -> str:
    ql = bench.WORKLOADS[name][0]
    for a, b in DENSE_EDITS[name]:
        ql = ql.replace(a, b)
    return f"@app:batch(size='{batch}')\n" + ql


@pytest.mark.parametrize("name", sorted(DENSE_EDITS))
def test_jax_state_carried_in(name):
    """A JAX pattern state taken mid-stream (token table, captures, selector
    and timer lanes, as numpy) and its interner carried into the port: both
    continue on the same events to the same rows and the same state."""
    app = _dense_app(name, 32)
    data = bench._make_stock_data(32 * 24, seed=11)
    jmgr, pmgr = _managers()
    jrt, prt = jmgr.create_siddhi_app_runtime(app), pmgr.create_siddhi_app_runtime(app)
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    jrt.start()
    _send_stock(jrt, jmgr, data, 0, 32 * 12, fused=False, calls=12)
    state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    assert int(state["tok"]["active"].sum()) > 1
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(state, "cpu")
    got["jax"].clear()
    prt.start()
    _send_stock(jrt, jmgr, data, 32 * 12, 32 * 24, fused=False, calls=12)
    _send_stock(prt, pmgr, data, 32 * 12, 32 * 24, fused=False, calls=12)
    want_state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    got_state = state_to_numpy(prt.queries["q"].state)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"]) > 5
    assert got["port"] == got["jax"]
    np.testing.assert_equal(got_state, want_state)


@pytest.mark.parametrize("name", sorted(DENSE_EDITS))
def test_describe_state_counts(name):
    """describe_state's active instances per slot equal the JAX package's."""
    app = _dense_app(name, 64)
    data = bench._make_stock_data(64 * 5 + 9, seed=2)
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(app)
        rt.start()
        before = rt.queries["q"].describe_state()
        _send_stock(rt, mgr, data, 0, 64 * 5 + 9, fused=False, calls=6)
        d = rt.queries["q"].describe_state()
        got[_pkg(mgr)] = (before["states"], d["states"], d["active_instances"],
                          d["next_deadline_ms"], d["token_capacity"])
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"][2] > 1
    assert got["siddhi_tpu_torch"] == got["siddhi_tpu"]


# ---------------------------------------------------------------------------
# tests/test_pattern_differential.py: the batch-route apps
# ---------------------------------------------------------------------------

DIFF_SCHEMA = "define stream S (sym string, price float, volume int);\n"
COUNT_SEL = ("select a1[0].volume as v0, a1[1].volume as v1, a1[2].volume as v2, "
             "a1[3].volume as v3, a2.volume as va")
DIFF_APPS = {
    "every_count": (f"from every a1=S[price > 90.0]<2:4> -> a2=S[price < 10.0] {COUNT_SEL}",
                    160, 0, 7),
    "dense_count": (f"from every a1=S[price > 30.0]<2:4> -> a2=S[price < 20.0] {COUNT_SEL}",
                    96, 3, 32),
    "no_every_count": ("from a1=S[price > 80]<2:3> -> a2=S[price < 20] select a1[0].volume as "
                       "v0, a1[1].volume as v1, a2.volume as va", 120, 5, 16),
    "exact_count": ("from every a1=S[price > 70]<2> -> a2=S[price < 30] select a1[0].volume as "
                    "v0, a1[1].volume as v1, a2.volume as va", 120, 6, 24),
    "min_above_capacity": ("from every a1=S[price > 20]<10:> -> a2=S[price < 5] select "
                           "a1[0].volume as v0, a1[last].volume as vl, a2.volume as va",
                           200, 12, 40),
    "kleene_plus_unbounded": ("from every a1=S[price > 60]<1:> -> a2=S[price < 40] select "
                              "a1[0].volume as v0, a1[last].volume as vl, a2.volume as va",
                              120, 13, 24),
    "three_slot_tail": ("from every a1=S[price > 85]<1:3> -> a2=S[price < 15] -> "
                        "a3=S[volume > a2.volume] select a1[0].volume as v0, a2.volume as va, "
                        "a3.volume as vb", 160, 7, 32),
    "every_two_state": ("from every a1=S[price > 92] -> a2=S[price < 8] select a1.volume as v1, "
                        "a2.volume as v2", 160, 1, 32),
}


def _diff_data(n, seed):
    rng = np.random.default_rng(seed)
    return {"ts": np.arange(n, dtype=np.int64) + 1_000,
            "sym": rng.integers(1, 5, size=n).astype(np.int32),
            "price": rng.uniform(0.0, 100.0, size=n).astype(np.float32),
            "volume": rng.integers(1, 100, size=n).astype(np.int64)}


def _run_columns(mgr, ql, data, batch):
    rt = mgr.create_siddhi_app_runtime(f"@app:batch(size='{batch}')\n" + ql)
    got = []
    rt.add_callback("q", lambda ts, ins, rem: got.extend(
        (e.timestamp, tuple(e.data)) for e in ins or []))
    rt.start()
    rt.get_input_handler("S").send_columns(data["ts"], {k: v for k, v in data.items()
                                                        if k != "ts"})
    rt.shutdown()
    mgr.shutdown()
    return got


def _canon(rows):
    """Sorted within a timestamp: the scan route's order among completions
    of one event differs from the batch routes' (test_pattern_differential)."""
    out, i = [], 0
    while i < len(rows):
        j = i
        while j < len(rows) and rows[j][0] == rows[i][0]:
            j += 1
        out.extend(sorted(rows[i:j], key=repr))
        i = j
    return out


@pytest.mark.parametrize("app", sorted(DIFF_APPS))
def test_differential_app(app, monkeypatch):
    """The port against the JAX batch route exactly, and against the JAX
    per-event scan (FORCE_SCAN) up to the order within a timestamp."""
    ql, n, seed, batch = DIFF_APPS[app]
    ql = DIFF_SCHEMA + f"@info(name='q') {ql} insert into Out;"
    data = _diff_data(n, seed)
    got = _run_columns(siddhi_tpu_torch.SiddhiManager(device="cpu"), ql, data, batch)
    fast = _run_columns(siddhi_tpu.SiddhiManager(), ql, data, batch)
    monkeypatch.setattr(jax_pattern, "FORCE_SCAN", True)
    slow = _run_columns(siddhi_tpu.SiddhiManager(), ql, data, batch)
    assert fast
    assert got == fast
    assert _canon(got) == _canon(slow)


# ---------------------------------------------------------------------------
# the apps of test_pattern.py and of the every / sequence / count / within
# golden corpora
# ---------------------------------------------------------------------------


def _jax_batch_route(ql: str, query_name: str) -> bool:
    q = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql).queries[query_name]
    return (q.prog.fast_path_ok or q.prog.count_fast_ok) and not q.prog.needs_scheduler


def _both_packages(orig, checked: list):
    """Wrap a golden module's runner: run the app through the JAX package and
    through the port (the same runner with the port's manager) and hold the
    rows equal; return the port's rows to the golden's assertions. `checked`
    records the route each app took."""

    def run(ql, sends, query_name="query1", *args, **kwargs):
        g = orig.__globals__
        saved = g["SiddhiManager"]
        try:
            g["SiddhiManager"] = lambda: siddhi_tpu_torch.SiddhiManager(device="cpu")
            port = orig(ql, sends, query_name, *args, **kwargs)
        finally:
            g["SiddhiManager"] = saved
        want = orig(ql, sends, query_name, *args, **kwargs)
        assert bench._rows_match([list(r) for r in port], [list(r) for r in want])
        checked.append("batch" if _jax_batch_route(ql, query_name) else "scan")
        return port

    return run


GOLDEN_MODULES = ("tests.test_pattern", "tests.test_golden_every", "tests.test_golden_sequence",
                  "tests.test_golden_count", "tests.test_golden_within")


def _golden_cases():
    cases = []
    for modname in GOLDEN_MODULES:
        mod = importlib.import_module(modname)
        for cname, cls in sorted(vars(mod).items()):
            if not (cname.startswith("Test") and inspect.isclass(cls)):
                continue
            for mname in sorted(vars(cls)):
                meth = getattr(cls, mname)
                if mname.startswith("test_") and "run_" in inspect.getsource(meth):
                    cases.append((modname, cname, mname))
    return cases


GOLDEN_CASES = _golden_cases()


@pytest.mark.parametrize("modname,cname,mname", GOLDEN_CASES)
def test_golden_app(modname, cname, mname, monkeypatch):
    mod = importlib.import_module(modname)
    checked: list = []
    for runner in ("run_app", "run_ts"):
        orig = getattr(mod, runner, None)
        if orig is not None:
            monkeypatch.setattr(mod, runner, _both_packages(orig, checked))
    getattr(getattr(mod, cname)(), mname)()
    assert checked


def test_insert_into_chains_to_a_query():
    """A pattern's rows inserted into a stream feed a downstream query, with
    a two-stream pattern's steps driven from both input streams."""
    ql = """
    define stream A (sym string, price float, volume long);
    define stream B (sym string, price float, volume long);
    from every e1=A[price > 50] -> e2=B[price < e1.price]
    select e1.sym as s1, e2.sym as s2, e2.price as p2 insert into Mid;
    @info(name='q') from Mid[p2 > 10] select s1, s2, p2 insert into Out;
    """
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        ha, hb = rt.get_input_handler("A"), rt.get_input_handler("B")
        r = np.random.default_rng(21)
        for i in range(60):
            h = ha if r.random() < 0.5 else hb
            h.send((["IBM", "WSO2"][i % 2], float(r.uniform(0, 100)), i), timestamp=1000 + i)
        rt.shutdown()
        mgr.shutdown()
    assert len(got["siddhi_tpu"]) > 5
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


def test_within_expires():
    """test_pattern.py's within case, with explicit event times."""
    ql = """
    define stream StreamA (symbol string, price float, volume int);
    define stream StreamB (symbol string, price float, volume int);
    @info(name = 'query1')
    from every e1=StreamA -> e2=StreamB within 1 sec
    select e1.volume as v1, e2.volume as v2
    insert into OutStream;
    """
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        out = got.setdefault(_pkg(mgr), [])
        rt.add_callback("query1", lambda ts, ins, rm, _o=out: _o.extend(
            tuple(e.data) for e in ins or []))
        rt.start()
        ha, hb = rt.get_input_handler("StreamA"), rt.get_input_handler("StreamB")
        t0 = 1_700_000_000_000
        ha.send(("A", 1.0, 1), timestamp=t0)
        hb.send(("B", 1.0, 2), timestamp=t0 + 2000)
        ha.send(("A", 1.0, 3), timestamp=t0 + 3000)
        hb.send(("B", 1.0, 4), timestamp=t0 + 3500)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu_torch"] == got["siddhi_tpu"] == [(3, 4)]


SCAN_HEAD = bench.VERIFY_HEAD + "define stream S2 (symbol string, price float, volume long);\n"


def _scan_feed():
    rng = np.random.default_rng(8)
    return [("S" if rng.random() < 0.7 else "S2",
             (["WSO2", "IBM", "GOOG"][int(rng.integers(0, 3))],
              float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000))),
             1_700_000_000_000 + 200 * i) for i in range(120)]


@pytest.mark.parametrize("ql", [
    # logical (bench.py's logical_pattern verify case)
    "from every (e1=S[price > 90] and e2=S[volume > 500]) select e1.price as pa, "
    "e2.volume as vb insert into Out;",
    # absent
    "from e1=S[price > 50] -> not S[price < 10] for 1 sec select e1.price as p insert into Out;",
    # a multi-stream sequence
    "from every e1=S[price > 50], e2=S2[price < 40] select e1.price as p insert into Out;",
    # a count past the first state
    "from e1=S[price > 50] -> e2=S[price < 40]<2:3> select e1.price as p insert into Out;",
])
def test_scan_route_patterns_run(ql):
    """The four scan-route apps that raised "not ported yet" before the
    scan route was ported: the port's rows equal the JAX package's, under
    @app:playback, one event per send over two streams."""
    app = "@app:playback\n" + SCAN_HEAD + "@info(name='q') " + ql
    assert not _jax_batch_route(app, "q")
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(app)
        rt.add_callback("q", _collector(got.setdefault(_pkg(mgr), [])))
        rt.start()
        for sid, row, t in _scan_feed():
            rt.get_input_handler(sid).send(row, timestamp=t)
        rt.shutdown()
        mgr.shutdown()
    assert got["siddhi_tpu"]
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


@pytest.mark.parametrize("ql", [
    # a function call over a captured event in a condition
    "from every e1=S[price > 50] -> not S2[price < maximum(e1.price, 10.0)] for 1 sec "
    "select e1.price as p insert into Out;",
])
def test_scan_route_patterns_raise(ql):
    """A token-dependent condition outside the scan's condition programs
    raises "not ported yet" at app creation (the split of the filters is
    the same on either device)."""
    app = SCAN_HEAD + "@info(name='q') " + ql
    assert not _jax_batch_route(app, "q")
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        mgr.create_siddhi_app_runtime(app)
