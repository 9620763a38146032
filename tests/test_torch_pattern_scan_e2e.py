"""The per-event scan route end to end on the CPU: the logical_pattern verify
case against VERIFY.json; every app of the logical / absent golden corpora
(test_golden_logical.py, test_golden_absent.py, test_golden_absent_ref2.py,
test_golden_logical_absent_ref.py) and of test_pattern_late_timer.py
through siddhi_tpu_torch (device="cpu") under the golden's own assertions
(the JAX package passes them in those files); the batch-route differential
apps with both packages forced onto the scan (FORCE_SCAN), exactly equal;
scan-route apps over one and two streams against the JAX package; fused =
per batch = JAX per batch on a logical-then-cross-ref pattern, and a JAX
state carried in; describe_state's deadline; and a failing TIMER step
raising from the sender. Floats match to a relative 2e-4
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
import siddhi_tpu_torch.core.pattern as port_pattern  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    state_from_numpy,
    state_to_numpy,
)
from tests.test_torch_pattern_e2e import (  # noqa: E402
    DIFF_APPS,
    DIFF_SCHEMA,
    _diff_data,
    _run_columns,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def test_logical_pattern_verify_case():
    """bench.py's logical_pattern (the scan route) over the 96-event verify
    feed, one event per send, equals the frozen rows of VERIFY.json."""
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
            for _ in range(96)]
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime(bench.VERIFY_CASES["logical_pattern"])
    got = []
    rt.add_callback("q", lambda t, ins, rem: got.extend(
        [["+"] + list(e.data) for e in ins or []] + [["-"] + list(e.data) for e in rem or []]))
    rt.start()
    h = rt.get_input_handler("S")
    for i, r in enumerate(rows):
        h.send(r, timestamp=int(ts[i]))
    rt.shutdown()
    with open(os.path.join(ROOT, "VERIFY.json")) as f:
        frozen = json.load(f)["cpu"]["logical_pattern"]
    assert frozen
    assert bench._rows_match(got, frozen)


# ---------------------------------------------------------------------------
# the logical / absent golden corpora through the port
# ---------------------------------------------------------------------------

GOLDEN_MODULES = ("tests.test_golden_logical", "tests.test_golden_absent",
                  "tests.test_golden_absent_ref2", "tests.test_golden_logical_absent_ref",
                  "tests.test_pattern_late_timer")
# every golden app runs on the port, patterns inside partitions among them
UNPORTED: set = set()


def _golden_cases():
    """(module, class or None, test name, parametrize argument or None)."""
    cases = []
    for modname in GOLDEN_MODULES:
        mod = importlib.import_module(modname)
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("Test") and inspect.isclass(obj):
                cases += [(modname, name, m, None) for m in sorted(vars(obj))
                          if m.startswith("test_")]
            elif name.startswith("test_") and inspect.isfunction(obj):
                marks = [m for m in getattr(obj, "pytestmark", []) if m.name == "parametrize"]
                if marks:
                    argname, values = marks[0].args[:2]
                    cases += [(modname, None, name, (argname, v)) for v in values]
                else:
                    cases.append((modname, None, name, None))
    return cases


def _xfailed(fn) -> bool:
    return any(m.name == "xfail" for m in getattr(fn, "pytestmark", []))


@pytest.mark.parametrize("modname,cname,fname,param", _golden_cases())
def test_golden_app(modname, cname, fname, param, monkeypatch):
    """The golden test itself, with every SiddhiManager it makes the port's:
    its own assertions hold the port's rows to the reference's. A case the
    JAX package marks as a documented deviation (strict xfail) must deviate
    the same way here."""
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, "SiddhiManager", _port)
    monkeypatch.setattr(siddhi_tpu, "SiddhiManager", _port)  # in-test imports
    fn = getattr(getattr(mod, cname)(), fname) if cname else getattr(mod, fname)
    kwargs = {param[0]: param[1]} if param else {}
    if fname in UNPORTED:
        with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
            fn(**kwargs)
    elif _xfailed(getattr(mod, fname, None)):
        with pytest.raises(AssertionError):
            fn(**kwargs)
    else:
        fn(**kwargs)


# ---------------------------------------------------------------------------
# differential apps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", sorted(DIFF_APPS))
def test_forced_scan_equals_jax_forced_scan(app, monkeypatch):
    """The batch-route apps of test_pattern_differential.py with both
    packages forced onto the per-event scan: the same rows in the same
    order."""
    ql, n, seed, batch = DIFF_APPS[app]
    ql = DIFF_SCHEMA + f"@info(name='q') {ql} insert into Out;"
    data = _diff_data(n, seed)
    monkeypatch.setattr(jax_pattern, "FORCE_SCAN", True)
    monkeypatch.setattr(port_pattern, "FORCE_SCAN", True)
    got = _run_columns(_port(), ql, data, batch)
    want = _run_columns(siddhi_tpu.SiddhiManager(), ql, data, batch)
    assert want
    assert bench._rows_match([list(r) for r in got], [list(r) for r in want])


SCAN_APPS = {
    "logical_cross_ref": ("from every (e1=S[price > 80] and e2=S[volume > 80]) -> "
                          "e3=S[sym == e1.sym and price < e1.price - 60] within 300 milliseconds "
                          "select e1.volume as v1, e1.price as p1, e2.volume as v2, e3.price as p3"),
    "absent_keyed": ("from every e1=S[price > 85] -> not S[sym == e1.sym and price < 15] "
                     "for 20 milliseconds select e1.volume as v, e1.price as p"),
    "count_within": ("from every e1=S[price > 60]<2:4> -> e2=S[price < 30] within 40 milliseconds "
                     "select e1[0].price as a0, e1[last].price as al, e2.price as b"),
    "sequence_count": ("from every e1=S[price > 40]<1:3>, e2=S[price < 40] "
                       "select e1[0].volume as v0, e1[last].volume as vl, e2.volume as vb"),
    "every_block": ("from every (e1=S[price > 70] -> e2=S[price < 30]) -> e3=S[volume > 90] "
                    "select e1.price as p1, e2.price as p2, e3.volume as v3"),
    # conditions mixing capture-free conjuncts (hoisted into the row masks)
    # with capture reads
    "mixed_conjuncts": ("from every e1=S[price > 70] -> e2=S[price < 40 and sym == e1.sym and "
                        "volume > 20] within 200 milliseconds "
                        "select e1.price as p1, e2.price as p2, e2.volume as v2"),
    "mixed_nested": ("from every e1=S[price > 60] -> e2=S[(price < 50 and volume > 10) and "
                     "(sym == e1.sym and price < e1.price - 15)] or e3=S[volume > 95 and "
                     "price > e1.price] select e1.volume as v1, e2.price as p2, e3.price as p3"),
    "mixed_absent": ("from every e1=S[price > 80] -> not S[price < 20 and sym == e1.sym and "
                     "volume > 5] for 15 milliseconds select e1.volume as v, e1.price as p"),
}


@pytest.mark.parametrize("app", sorted(SCAN_APPS))
@pytest.mark.parametrize("batch", [16, 33])
def test_scan_app_against_jax(app, batch):
    """Scan-route apps under @app:playback through send_columns at batch 16
    and 33: the port's rows and their timestamps equal the JAX package's."""
    ql = "@app:playback\n" + DIFF_SCHEMA + f"@info(name='q') {SCAN_APPS[app]} insert into Out;"
    data = _diff_data(160, 17)
    got = _run_columns(_port(), ql, data, batch)
    want = _run_columns(siddhi_tpu.SiddhiManager(), ql, data, batch)
    assert len(want) > 2
    assert bench._rows_match([list(r) for r in got], [list(r) for r in want])


HOIST_APP = ("@app:playback\n" + DIFF_SCHEMA +
             "@info(name='q') from every e1=S[price > 50] -> e2=S[volume > 10 and "
             "sym == e1.sym and price * 2.0 < e1.price + 100.0 and not (price is null)] "
             "select e1.volume as v1, e2.volume as v2, e2.price as p2 insert into Out;")
HOIST_ROWS = [("A", 60.0, 1), ("A", 30.0, None), ("B", 55.0, 2), ("A", None, 30),
              ("A", 20.0, 40), ("B", 10.0, None), ("B", 40.0, 12), ("A", 70.0, 3),
              ("A", float("nan"), 50), ("A", 35.0, 11)]


def test_hoisted_conjuncts_over_nulls_match_jax():
    """A condition whose capture-free conjuncts, null volumes and prices
    among their operands, land in the row mask (two of its four conjuncts),
    one event a send: the rows equal JAX's."""
    outs = []
    for mgr in (siddhi_tpu.SiddhiManager(), _port()):
        rt = mgr.create_siddhi_app_runtime(HOIST_APP)
        out = []
        rt.add_callback("Out", lambda evs, _o=out: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        for i, row in enumerate(HOIST_ROWS):
            rt.get_input_handler("S").send(row, 1_000 + 5 * i)
        if mgr.__class__.__module__.startswith("siddhi_tpu_torch"):
            prog = rt.queries["q"].prog
            prog.compile_scan()
            e2 = prog.slots[1].atoms[0]
            assert len(prog._row_conds[(1, e2.ref_idx)]) == 2
            assert len(prog._progs[(1, e2.ref_idx)]) == 2
        rt.shutdown()
        outs.append(out)
    assert outs[0] and bench._rows_match([list(r) for r in outs[1]],
                                         [list(r) for r in outs[0]])


# ---------------------------------------------------------------------------
# the logical path: fused = per batch = JAX per batch, JAX state carried in
# ---------------------------------------------------------------------------

LOGICAL_APP = """
@app:patternCapacity(size='64')
@app:batch(size='64')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from every (e1=StockStream[price > 80] and e2=StockStream[volume > 900]) ->
    e3=StockStream[symbol == e1.symbol and price < e1.price - 70] within 1 sec
select e1.symbol as s, e1.price as p1, e2.volume as v2, e3.price as p3
insert into Out;
"""


def _collector(rows: list):
    return lambda t, ins, rem: rows.append([tuple(e.data) for e in ins or []])


def _send(rt, mgr, data, lo, hi, fused, calls):
    for s in data["names"]:
        mgr.interner.intern(str(s))
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    h = rt.get_input_handler("StockStream")
    step = -(-(hi - lo) // calls)
    for c in range(lo, hi, step):
        e = min(c + step, hi)
        h.send_columns(data["ts"][c:e], {k: data[k][c:e] for k in ("symbol", "price", "volume")},
                       now=0)


def test_logical_fused_equals_per_batch_equals_jax():
    """The logical-then-cross-ref pattern (chip_smoke's path L at batch 64):
    the port fused, the port per batch and the JAX package per batch deliver
    the same callback sequence."""
    n = 30 * 64
    data = bench._make_stock_data(n, seed=5)
    seqs = {}
    for label, mk, fused in (("fused", _port, True), ("per_batch", _port, False),
                             ("jax", siddhi_tpu.SiddhiManager, False)):
        mgr = mk()
        rt = mgr.create_siddhi_app_runtime(LOGICAL_APP)
        rows = seqs.setdefault(label, [])
        rt.add_callback("q", _collector(rows))
        rt.start()
        _send(rt, mgr, data, 0, n, fused, 5)
        fi = rt.junctions["StockStream"].fused_ingest
        assert (fi is not None and fi.batches_fused > 0) == fused
        rt.shutdown()
        mgr.shutdown()
    assert sum(len(r) for r in seqs["jax"]) > 5
    assert seqs["fused"] == seqs["per_batch"]
    assert bench._rows_match(seqs["fused"], seqs["jax"])


@pytest.mark.parametrize("app", ["logical", "sequence_count"])
def test_jax_scan_state_carried_in(app):
    """A JAX scan-route state taken mid-stream (token table with its fwd
    lane or its logical captures, the selector and timer_ts, as numpy) and
    its interner carried into the port: both continue to the same rows and
    the same state."""
    ql = LOGICAL_APP if app == "logical" else (
        "@app:patternCapacity(size='64')\n@app:batch(size='32')\n"
        "define stream StockStream (symbol string, price float, volume long);\n"
        "@info(name='q') from every e1=StockStream[price > 40]<1:3>, e2=StockStream[price < 40] "
        "select e1[0].volume as v0, e1[last].volume as vl, e2.volume as vb insert into Out;")
    data = bench._make_stock_data(64 * 12, seed=12)
    jmgr, pmgr = siddhi_tpu.SiddhiManager(), _port()
    jrt, prt = jmgr.create_siddhi_app_runtime(ql), pmgr.create_siddhi_app_runtime(ql)
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    jrt.start()
    _send(jrt, jmgr, data, 0, 64 * 6, False, 6)
    state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(state, "cpu")
    got["jax"].clear()
    prt.start()
    _send(jrt, jmgr, data, 64 * 6, 64 * 12, False, 6)
    _send(prt, pmgr, data, 64 * 6, 64 * 12, False, 6)
    want_state = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)
    got_state = state_to_numpy(prt.queries["q"].state)
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert sum(len(r) for r in got["jax"]) > 2
    assert bench._rows_match(got["port"], got["jax"])
    np.testing.assert_equal(got_state, want_state)


ABSENT_APP = """
@app:playback
@app:patternCapacity(size='32')
define stream StockStream (symbol string, price float, volume long);
@info(name='q')
from every e1=StockStream[price > 90] -> not StockStream[symbol == e1.symbol and price < 10]
    for 30 milliseconds
select e1.symbol as s, e1.price as p
insert into Out;
"""


def test_absent_describe_state_and_timers():
    """An absent pattern under playback, one event per send: the port's rows,
    describe_state (active instances per slot and next_deadline_ms) after
    every 10 events, and the TIMER steps it ran all match the JAX package."""
    data = bench._make_stock_data(120, seed=6)
    got = {}
    for pkg, mgr in (("jax", siddhi_tpu.SiddhiManager()), ("port", _port())):
        for s in data["names"]:
            mgr.interner.intern(str(s))
        rt = mgr.create_siddhi_app_runtime(ABSENT_APP)
        rows, states = [], []
        rt.add_callback("q", lambda t, ins, rem, _r=rows: _r.extend(
            (t, tuple(e.data)) for e in ins or []))
        rt.start()
        h = rt.get_input_handler("StockStream")
        for i in range(120):
            h.send((data["names"][data["symbol"][i] - 1], float(data["price"][i]),
                    int(data["volume"][i])), timestamp=int(data["ts"][i]) + 7 * i)
            if i % 10 == 9:
                d = rt.queries["q"].describe_state()
                states.append((d["states"], d["next_deadline_ms"]))
        rt.shutdown()
        mgr.shutdown()
        got[pkg] = (rows, states)
    assert len(got["jax"][0]) > 2
    assert any(dl is not None for _s, dl in got["jax"][1])
    assert got["port"][1] == got["jax"][1]
    assert bench._rows_match([list(r) for r in got["port"][0]],
                             [list(r) for r in got["jax"][0]])


def test_failing_timer_step_raises_from_sender():
    """A TIMER step that fails (under playback it runs on the sender's
    thread, inside the clock advance) raises from the send that drove it."""
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime(ABSENT_APP)
    rt.start()
    qr = rt.queries["q"]

    def boom(t_ms):
        raise RuntimeError(f"timer step at {t_ms} failed")

    qr.receive_timer = boom
    h = rt.get_input_handler("StockStream")
    t0 = 1_700_000_000_000
    h.send(("IBM", 95.0, 10), timestamp=t0)  # arms a deadline at t0 + 30
    with pytest.raises(RuntimeError, match="timer step"):
        h.send(("IBM", 50.0, 10), timestamp=t0 + 100)
    rt.shutdown()
    mgr.shutdown()
