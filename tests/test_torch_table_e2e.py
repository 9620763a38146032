"""In-memory tables end to end through both packages on the CPU: the same
SiddhiQL app and events through `siddhi_tpu` (JAX) and `siddhi_tpu_torch`
(device="cpu") — the table_crud verify case against VERIFY.json and JAX;
every test of tests/test_table.py and tests/test_table_update_parallel.py
and of the primary-key and index-table golden corpora under its own
assertions with the port's manager swapped in (the record-store tests
with the port's record-store SPI, extension registry and expression
classes), the update apps of test_table_update_parallel.py
also against JAX; the table paths of chip_smoke.py (TAB-PK, TAB-IX,
TAB-DENSE, TAB-UPSERT, TAB-JOIN) at capacity 64 and batch 32/33 against JAX,
fused and per batch; an auto-indexed update whose index gains and loses
duplicates, with no host read in the update; a JAX table state carried in
through interop; describe_state; a @store table against JAX;
the forms left out raising "not ported yet". Floats match to a relative
2e-4 (bench.py:_rows_match); everything else exactly.
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

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core import errors as port_errors  # noqa: E402
from siddhi_tpu_torch.core import table as port_table  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    state_from_numpy,
    state_to_numpy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _feed_rows():
    """bench.py:_leg_verify's 96-event feed, one event per send."""
    rng = np.random.default_rng(99)
    ts = np.arange(96, dtype=np.int64) * 7 + 1_700_000_000_000
    rows = [(["WSO2", "IBM", "GOOG", "MSFT"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0.0, 100.0), 3)), int(rng.integers(1, 1000)))
            for _ in range(96)]
    return ts, rows


def test_table_crud_verify_case():
    ql, sq = bench.VERIFY_TABLE_CASES["table_crud"]
    ts, rows = _feed_rows()
    got = {}
    for name, mgr in (("jax", siddhi_tpu.SiddhiManager()), ("port", _port())):
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        got[name] = sorted(list(e.data) for e in rt.query(sq))
        rt.shutdown()
        mgr.shutdown()
    with open(os.path.join(ROOT, "VERIFY.json")) as f:
        frozen = json.load(f)["cpu"]["table_crud"]
    assert got["port"] == frozen
    assert bench._rows_match(got["port"], got["jax"])


# ---------------------------------------------------------------------------
# the JAX package's table tests and golden corpora, on the port
# ---------------------------------------------------------------------------

MODULES = ("tests.test_table", "tests.test_table_update_parallel",
           "tests.test_golden_pktable_ref", "tests.test_golden_indextable_ref")
# the record-store tests import the JAX package's store SPI, extension
# registry and expression classes: the port's take their place
RECORD_STORE_TESTS = {"test_store_backed_table_survives_restart", "test_lazy_store_pushdown"}


def _swap_record_store_modules(monkeypatch) -> None:
    import siddhi_tpu.core.extension as jax_ext
    import siddhi_tpu.core.record_table as jax_records
    import siddhi_tpu.query_api.expression as jax_expr

    import siddhi_tpu_torch.core.extension as port_ext
    import siddhi_tpu_torch.core.record_table as port_records
    import siddhi_tpu_torch.query_api.expression as port_expr

    monkeypatch.setattr(jax_records, "InMemoryRecordStore", port_records.InMemoryRecordStore)
    monkeypatch.setattr(jax_records, "RecordStore", port_records.RecordStore)
    monkeypatch.setattr(jax_ext, "extension", port_ext.extension)
    for name in ("Compare", "CompareOp", "Constant", "Variable"):
        monkeypatch.setattr(jax_expr, name, getattr(port_expr, name))


def _cases():
    """(module, class or None, test name, parametrize argument or None)."""
    cases = []
    for modname in MODULES:
        mod = importlib.import_module(modname)
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("Test") and inspect.isclass(obj):
                cases += [(modname, name, m, None) for m in sorted(vars(obj))
                          if m.startswith("test")]
            elif name.startswith("test_") and inspect.isfunction(obj):
                marks = [m for m in getattr(obj, "pytestmark", []) if m.name == "parametrize"]
                if marks:
                    argname, values = marks[0].args[:2]
                    cases += [(modname, None, name, (argname, v)) for v in values]
                else:
                    cases.append((modname, None, name, None))
    return cases


@pytest.mark.parametrize("modname,cname,fname,param", _cases())
def test_jax_table_test_on_the_port(modname, cname, fname, param, monkeypatch):
    """The test itself, with every SiddhiManager it makes the port's (its
    error classes and, for the update-path tests, the planner module the
    port's): its own assertions hold the port's rows."""
    mod = importlib.import_module(modname)
    for m in {mod, importlib.import_module("tests.test_golden_pktable_ref")}:
        monkeypatch.setattr(m, "SiddhiManager", _port)
        for err in ("SiddhiAppCreationError", "SiddhiParserError"):
            if hasattr(m, err):
                monkeypatch.setattr(m, err, getattr(port_errors, err))
    monkeypatch.setattr(siddhi_tpu, "SiddhiManager", _port)  # in-test imports
    if hasattr(mod, "table_mod"):
        monkeypatch.setattr(mod, "table_mod", port_table)
    if fname in RECORD_STORE_TESTS:
        _swap_record_store_modules(monkeypatch)
    fn = getattr(getattr(mod, cname)(), fname) if cname else getattr(mod, fname)
    kwargs = {param[0]: param[1]} if param else {}
    fn(**kwargs)


@pytest.mark.parametrize("case", sorted(importlib.import_module(
    "tests.test_table_update_parallel").CASES))
@pytest.mark.parametrize("pk", [False, True])
def test_update_apps_match_jax(case, pk, monkeypatch):
    """The update apps of test_table_update_parallel.py (20 loaded rows, 40
    updates with repeated keys, one per send) on the port and on JAX, both
    on the planner's path and forced sequential."""
    mod = importlib.import_module("tests.test_table_update_parallel")
    ql = (mod.PK_BASE if pk else mod.BASE) + mod.CASES[case]
    want = mod._run(ql, force_sequential=False)
    monkeypatch.setattr(mod, "SiddhiManager", _port)
    monkeypatch.setattr(mod, "table_mod", port_table)
    for forced in (False, True):
        assert mod._run(ql, force_sequential=forced) == want


# ---------------------------------------------------------------------------
# the table paths of chip_smoke.py at capacity 64
# ---------------------------------------------------------------------------


def _drive(mgr, label: str, n: int, batch: int, n_batches: int, fused: bool = True) -> dict:
    """chip_smoke.run_table_path's traffic through either package."""
    rt = mgr.create_siddhi_app_runtime(chip_smoke.TAB_APPS[label].format(batch=batch, n=n))
    got = {q: [] for q in ("q", "q2") if q in rt.queries}
    for q, rows in got.items():
        rt.add_callback(q, lambda t, ins, rem, _r=rows: _r.extend(tuple(e.data) for e in ins or []))
    rt.start()
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    load, span = chip_smoke.TAB_LOAD[label]
    lk = np.arange(int(n * load), dtype=np.int64)
    rt.get_input_handler("Loader").send_columns(lk, {"k": lk, "v": lk})
    total = batch * n_batches
    ks = np.random.default_rng(3).integers(0, int(n * span), size=total).astype(np.int64)
    vs = np.arange(total, dtype=np.int64)
    dk = np.random.default_rng(4).integers(0, n, size=total).astype(np.int64)
    stream = "Q" if label == "TAB-JOIN" else "S"
    h = rt.get_input_handler(stream)
    for c, lo in enumerate(range(0, total, chip_smoke.TAB_CALL * batch)):
        hi = min(total, lo + chip_smoke.TAB_CALL * batch)
        cols = {"k": ks[lo:hi]} if stream == "Q" else {"k": ks[lo:hi], "v": vs[lo:hi]}
        h.send_columns(vs[lo:hi], cols)
        if label == "TAB-DENSE" and c % 2 == 1:
            rt.get_input_handler("D").send_columns(vs[lo:lo + batch], {"k": dk[lo:lo + batch]})
    table = [tuple(e.data) for e in rt.query("from T select k, v")]
    rt.shutdown()
    mgr.shutdown()
    return {"table": table, "rows": got}


@pytest.mark.parametrize("label", sorted(chip_smoke.TAB_APPS))
@pytest.mark.parametrize("batch", [32, 33])
def test_table_path(label, batch):
    """Each table path at capacity 64 over 20 batches: the port fused, the
    port per batch, chip_smoke.run_table_path and JAX per batch agree."""
    want = _drive(siddhi_tpu.SiddhiManager(), label, 64, batch, 20, fused=False)
    fused = _drive(_port(), label, 64, batch, 20)
    per_batch = _drive(_port(), label, 64, batch, 20, fused=False)
    smoke = chip_smoke.run_table_path("cpu", label, 64, batch, 20)
    assert want["table"] and fused == per_batch
    assert {"table": smoke["table"], "rows": smoke["rows"]} == fused
    assert fused["table"] == want["table"] and fused["rows"] == want["rows"]
    if label == "TAB-JOIN":
        assert fused["rows"]["q"] and fused["rows"]["q2"]


def test_fused_chunk_threads_the_table():
    """A fused chunk runs the K steps of every query on the stream in
    order, each reading the table the previous one wrote: an update and an
    in-condition on one stream, 100 events at batch 16, equal to per batch
    and to JAX per batch."""
    app = """@app:batch(size='16')
    define stream S (k long, v long);
    @capacity(size='32') define table T (k long, v long);
    @info(name='w') from S select k, v update or insert into T on T.k == k;
    @info(name='q') from S[(T.k == k - 1) in T] select k, v insert into Out;
    """
    rng = np.random.default_rng(21)
    ks = rng.integers(0, 40, 100).astype(np.int64)
    vs = np.arange(100, dtype=np.int64)
    out = {}
    for name, mgr, fused in (("jax", siddhi_tpu.SiddhiManager(), False), ("fused", _port(), True),
                             ("per_batch", _port(), False)):
        rt = mgr.create_siddhi_app_runtime(app)
        rows = []
        rt.add_callback("q", lambda t, ins, rem, _r=rows: _r.extend(tuple(e.data)
                                                                   for e in ins or []))
        rt.start()
        if not fused:
            for j in rt.junctions.values():
                j.fused_ingest = None
        rt.get_input_handler("S").send_columns(vs, {"k": ks, "v": vs})
        if fused:
            assert rt.junctions["S"].fused_ingest.chunks_dispatched > 0
        out[name] = (rows, [tuple(e.data) for e in rt.query("from T select k, v")])
        rt.shutdown()
        mgr.shutdown()
    assert out["fused"] == out["per_batch"] == out["jax"]
    assert out["jax"][0]


def test_auto_index_choice_stays_on_the_device(monkeypatch):
    """An equality update without @PrimaryKey auto-indexes its column and
    takes the indexed path while the index holds no duplicate, the dense
    path while it does (JAX's lax.cond). Loads that add and deletes that
    remove duplicate keys flip that flag between updates; the port, fused
    and per batch, equals JAX per batch, and its update reads nothing to
    the host (the kernels' plain versions aside, which stand in for
    launches on the card)."""
    import torch

    app = """@app:batch(size='8')
    define stream L (k long, v long);
    define stream S (k long, v long);
    define stream D (k long);
    @capacity(size='48') define table T (k long, v long);
    @info(name='load') from L insert into T;
    @info(name='upd') from S select k, v update T on T.k == k;
    @info(name='del') from D select k delete T on T.k == k;
    """
    rng = np.random.default_rng(33)
    steps = [("L", np.arange(20)), ("S", rng.integers(0, 24, 20)),
             ("L", np.array([3, 5, 5, 11])), ("S", rng.integers(0, 24, 20)),
             ("D", np.array([5, 11])), ("S", rng.integers(0, 24, 20)),
             ("L", np.array([7])), ("S", np.array([7, 7, 3, 30]))]

    def run(mgr, fused):
        rt = mgr.create_siddhi_app_runtime(app)
        rt.start()
        if not fused:
            for j in rt.junctions.values():
                j.fused_ingest = None
        seen = []
        for i, (stream, keys) in enumerate(steps):
            k = np.asarray(keys, dtype=np.int64)
            v = np.arange(len(k), dtype=np.int64) + 100 * i
            cols = {"k": k} if stream == "D" else {"k": k, "v": v}
            rt.get_input_handler(stream).send_columns(v, cols)
            seen.append([tuple(e.data) for e in rt.query("from T select k, v")])
        rt.shutdown()
        mgr.shutdown()
        return seen

    want = run(siddhi_tpu.SiddhiManager(), False)
    guard = {"on": False, "gates": 0}

    def fail(*_a, **_k):
        raise AssertionError("host read inside InMemoryTable.update")

    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, **k: fail() if guard["on"] else _o(self, *a, **k))

    def lifted(fn):
        def call(*a, **k):
            on, guard["on"] = guard["on"], False
            try:
                return fn(*a, **k)
            finally:
                guard["on"] = on
        return call

    for kname in ("table_match", "table_index_probe", "table_index_build"):
        monkeypatch.setattr(port_table.K, kname, lifted(getattr(port_table.K, kname)))
    real_match, real_update = port_table.K.table_match, port_table.InMemoryTable.update

    def match(*a, **k):
        guard["gates"] += len(a) > 6 and a[6] is not None
        return real_match(*a, **k)

    def update(self, *a, **k):
        guard["on"] = True
        try:
            return real_update(self, *a, **k)
        finally:
            guard["on"] = False

    monkeypatch.setattr(port_table.K, "table_match", match)
    monkeypatch.setattr(port_table.InMemoryTable, "update", update)
    assert run(_port(), True) == want
    assert run(_port(), False) == want
    assert guard["gates"] > 0
    assert any(len(set(k for k, _v in rows)) < len(rows) for rows in want)  # duplicates held


def test_jax_table_state_carried_in():
    """Load and update a table in JAX, carry its state (index lanes
    included) and interned strings into the port, then send both the same
    next events."""
    app = """define stream S (sym string, v long);
    define stream U (sym string, v long);
    @PrimaryKey('sym') @capacity(size='16') define table T (sym string, v long);
    @info(name='ins') from S insert into T;
    @info(name='upd') from U select sym, v update T set T.v = T.v + v on T.sym == sym;
    @info(name='up2') from U[v > 5] select sym, v update T on T.sym == sym;
    """
    jmgr, pmgr = siddhi_tpu.SiddhiManager(), _port()
    jrt = jmgr.create_siddhi_app_runtime(app)
    jrt.start()
    for i, s in enumerate(["A", "B", "C", "A", "D"]):
        jrt.get_input_handler("S").send((s, i), timestamp=i + 1)
    jrt.get_input_handler("U").send(("B", 7), timestamp=9)
    tree = {k: (np.asarray(v) if k != "cols" else {n: np.asarray(c) for n, c in v.items()})
            for k, v in jrt.tables["T"].state.items()}
    assert "ix_order.sym" in tree and int(tree["valid"].sum()) == 4
    prt = pmgr.create_siddhi_app_runtime(app)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.tables["T"].state = state_from_numpy(tree, "cpu")
    np.testing.assert_equal(state_to_numpy(prt.tables["T"].state), tree)
    prt.start()
    for rt in (jrt, prt):
        rt.get_input_handler("U").send(("A", 3), timestamp=10)
        rt.get_input_handler("U").send(("C", 9), timestamp=11)
        rt.get_input_handler("S").send(("E", 4), timestamp=12)
        rt.get_input_handler("S").send(("B", 1), timestamp=13)  # a duplicate key: dropped
    want = [tuple(e.data) for e in jrt.query("from T select sym, v")]
    assert [tuple(e.data) for e in prt.query("from T select sym, v")] == want
    np.testing.assert_equal(
        state_to_numpy(prt.tables["T"].state),
        {k: (np.asarray(v) if k != "cols" else {n: np.asarray(c) for n, c in v.items()})
         for k, v in jrt.tables["T"].state.items()})
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()


def test_describe_state():
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime("""define stream S (k long, v long);
    @PrimaryKey('k') @capacity(size='8') define table T (k long, v long);
    from S insert into T;""")
    rt.start()
    for i in range(3):
        rt.get_input_handler("S").send((i, i))
    assert rt.describe_state()["tables"]["T"] == {
        "capacity": 8, "primary_keys": ["k"], "indexes": [], "record_store": False, "rows": 3}
    rt.shutdown()
    mgr.shutdown()


def test_flags_logged_once(caplog):
    """The overflow, dropped-duplicate and rekey-conflict flags are logged
    once per query, as the JAX package does."""
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime("""define stream S (k long, v long);
    define stream R (k long, v long);
    @PrimaryKey('k') @capacity(size='2') define table T (k long, v long);
    @info(name='ins') from S insert into T;
    @info(name='rekey') from R select k, v update T set T.k = k on T.v == v;""")
    rt.start()
    for row in [(1, 1), (1, 5), (2, 2), (3, 3), (4, 4)]:
        rt.get_input_handler("S").send(row)
    rt.get_input_handler("R").send((2, 1))  # onto the live key 2
    rt.get_input_handler("R").send((2, 1))
    rt.shutdown()
    mgr.shutdown()
    text = caplog.text
    assert text.count("ran out of capacity") == 1
    assert text.count("already stored") == 1
    assert text.count("rekeying matched rows") == 1


UNPORTED_FORMS = {
    "on_error": """define stream S (k long);
        @OnError(action='LOG') define table T (k long);
        from S insert into T;""",
    "pattern_in_table": """define stream S (k long);
        define table T (k long);
        from every e1=S[(T.k == k) in T] -> e2=S select e1.k as k insert into Out;""",
    "table_program_form": """define stream S (k long, v long);
        define table T (k long, v long);
        from S update T set T.v = v on convert(T.k, 'int') == 3;""",
}


@pytest.mark.parametrize("form", sorted(UNPORTED_FORMS))
def test_left_out_forms_raise(form):
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        _port().create_siddhi_app_runtime(UNPORTED_FORMS[form])


# the table forms the earlier slices' tests held to "not ported yet"
# (test_torch_groupby_e2e.py, test_torch_join_e2e.py test_outside_the_slice_raises)
FORMS_THAT_RAISED = [
    "define table T (symbol string, price float); "
    "from S select symbol, price insert into T;",
    "define table T (symbol string, price float); from S select symbol, price insert into T; "
    "@info(name='q') from S join T on S.symbol == T.symbol select S.symbol, T.price as p "
    "insert into Out;",
]


@pytest.mark.parametrize("ql", FORMS_THAT_RAISED)
def test_forms_that_raised_match_jax(ql):
    """Over the 96-event verify feed, one event per send: the table's rows
    (and the join's callback rows) equal JAX's."""
    ts, rows = _feed_rows()
    got = {}
    for name, mgr in (("jax", siddhi_tpu.SiddhiManager()), ("port", _port())):
        rt = mgr.create_siddhi_app_runtime(bench.VERIFY_HEAD + ql)
        out = []
        if "@info(name='q')" in ql:
            rt.add_callback("q", lambda t, ins, rem, _o=out: _o.extend(
                tuple(e.data) for e in ins or []))
        rt.start()
        h = rt.get_input_handler("S")
        for i, r in enumerate(rows):
            h.send(r, timestamp=int(ts[i]))
        got[name] = (out, [tuple(e.data) for e in rt.query("from T select symbol, price")])
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"][1]) == 96
    assert bench._rows_match(got["port"], got["jax"])


def test_store_query_over_a_window_or_aggregation_raises():
    """A store query over a name that is no table, window or aggregation
    raises JAX's class and message."""
    from siddhi_tpu.core import errors as jax_errors

    for mgr, err in ((siddhi_tpu.SiddhiManager(), jax_errors.DefinitionNotExistError),
                     (_port(), port_errors.DefinitionNotExistError)):
        rt = mgr.create_siddhi_app_runtime("define stream S (k long); define table T (k long);")
        with pytest.raises(err, match="'W' is not a defined table, window, or aggregation"):
            rt.query("from W select k")
        mgr.shutdown()


def test_record_store_table_matches_jax():
    """A @store table (the left-out form test_left_out_forms_raise held to
    "not ported yet" until the named-window slice) against JAX: stored rows
    loaded at creation, the table's rows after inserts and a delete, the
    snapshot written through, and every table lane after a restart over
    that snapshot."""
    import siddhi_tpu.core.record_table as jax_records

    import siddhi_tpu_torch.core.record_table as port_records

    app = """define stream S (k long, v double); define stream D (k long);
        @store(type='memory', store.id='t9') @PrimaryKey('k') @capacity(size='64')
        define table T (k long, v double);
        from S insert into T; from D delete T on T.k == k;"""
    got = {}
    for name, mgr, records in (("jax", siddhi_tpu.SiddhiManager(), jax_records),
                               ("port", _port(), port_records)):
        records.InMemoryRecordStore.clear_all()
        records.InMemoryRecordStore._data["t9"] = [(100, 1.25), (-7, -0.0)]
        rt = mgr.create_siddhi_app_runtime(app)
        rt.start()
        for i in range(40):
            rt.get_input_handler("S").send((i % 23, i * 0.5), timestamp=1 + i)
            if i % 7 == 3:
                rt.get_input_handler("D").send((i % 5,), timestamp=1 + i)
        rows = [tuple(e.data) for e in rt.query("from T select k, v")]
        rt.shutdown()
        stored = list(records.InMemoryRecordStore._data["t9"])
        rt2 = mgr.create_siddhi_app_runtime(app)
        lanes = rt2.tables["T"].state
        got[name] = (rows, stored, lanes)
        rt2.shutdown()
        mgr.shutdown()
        records.InMemoryRecordStore.clear_all()
    assert len(got["jax"][0]) > 15
    assert got["port"][:2] == got["jax"][:2]
    np.testing.assert_equal(
        state_to_numpy(got["port"][2]),
        {k: (np.asarray(v) if k != "cols" else {n: np.asarray(c) for n, c in v.items()})
         for k, v in got["jax"][2].items()})
