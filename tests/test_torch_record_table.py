"""`@store` record tables end to end through both packages on the CPU:

- tests/test_table.py's `test_store_backed_table_survives_restart` and
  `test_lazy_store_pushdown` and tests/test_aggregation.py's
  `TestAggregationRestartRebuild` under their own assertions, with the
  port's SiddhiManager and, where they import them, its record-store SPI,
  extension registry and expression classes swapped in;
- parity cases, the same apps and events through `siddhi_tpu` (JAX) and
  `siddhi_tpu_torch` (device="cpu"): a materialized `@store` table (stored
  rows loaded at creation, inserts, updates and deletes written through,
  every table lane after a restart over the snapshot), a lazy store's
  pushdown staged for a store query (the rows, and nothing left in the
  table), a lazy store refusing a streaming write as JAX does, and a
  `@store` aggregation (every duration table's lanes and the rebuilt
  in-flight stores after a restart, and the store queries' rows).

Ints and strings compare exactly, every table and store lane bit for bit,
delivered floats within bench.py:_rows_match's relative 2e-4.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402, F401

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu.core.record_table as jax_records  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
import siddhi_tpu_torch.core.record_table as port_records  # noqa: E402
from siddhi_tpu_torch.interop import aggregation_state_from_jax, state_to_numpy  # noqa: E402


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _pairs():
    """(package, manager, its record-store module) for JAX, then the port."""
    return (("jax", siddhi_tpu.SiddhiManager(), jax_records),
            ("port", _port(), port_records))


def _np_table(state: dict) -> dict:
    return {k: (np.asarray(v) if k != "cols" else {n: np.asarray(c) for n, c in v.items()})
            for k, v in state.items()}


def _swap(monkeypatch) -> None:
    import siddhi_tpu.core.extension as jax_ext
    import siddhi_tpu.query_api.expression as jax_expr

    import siddhi_tpu_torch.core.extension as port_ext
    import siddhi_tpu_torch.query_api.expression as port_expr

    monkeypatch.setattr(jax_records, "InMemoryRecordStore", port_records.InMemoryRecordStore)
    monkeypatch.setattr(jax_records, "RecordStore", port_records.RecordStore)
    monkeypatch.setattr(jax_ext, "extension", port_ext.extension)
    for name in ("Compare", "CompareOp", "Constant", "Variable"):
        monkeypatch.setattr(jax_expr, name, getattr(port_expr, name))


# ---------------------------------------------------------------------------
# the JAX package's record-store tests, on the port
# ---------------------------------------------------------------------------

JAX_TESTS = [
    ("tests.test_table", "TestRecordStore", "test_store_backed_table_survives_restart"),
    ("tests.test_table", "TestLazyQueryableStore", "test_lazy_store_pushdown"),
    ("tests.test_aggregation", "TestAggregationRestartRebuild",
     "test_store_backed_restart_rebuilds_inflight"),
]


def _find(modname: str, fname: str):
    mod = importlib.import_module(modname)
    for obj in vars(mod).values():
        if isinstance(obj, type) and fname in vars(obj):
            return mod, getattr(obj(), fname)
    raise LookupError(fname)


@pytest.mark.parametrize("modname,_cname,fname", JAX_TESTS)
def test_jax_record_store_test_on_the_port(modname, _cname, fname, monkeypatch):
    mod, fn = _find(modname, fname)
    monkeypatch.setattr(mod, "SiddhiManager", _port)
    monkeypatch.setattr(siddhi_tpu, "SiddhiManager", _port)  # in-test imports
    _swap(monkeypatch)
    fn()


# ---------------------------------------------------------------------------
# parity: a materialized @store table
# ---------------------------------------------------------------------------

TABLE_APP = """define stream S (sym string, v double, n long); define stream U (sym string, v double);
define stream D (sym string);
@store(type='memory', store.id='rt1') @capacity(size='64')
define table T (sym string, v double, n long);
@info(name='ins') from S insert into T;
@info(name='upd') from U select sym, v update T set T.v = T.v + v on T.sym == sym;
@info(name='del') from D delete T on T.sym == sym;
@info(name='look') from U join T on U.sym == T.sym select U.sym as s, T.n as n insert into O;"""


def test_store_table_write_through_and_restart_match_jax():
    rng = np.random.default_rng(31)
    syms = [f"K{i}" for i in range(12)]
    feed = [(syms[int(rng.integers(0, 12))], float(np.float32(rng.normal())),
             int(rng.integers(-5, 5))) for _ in range(48)]
    got = {}
    for name, mgr, records in _pairs():
        records.InMemoryRecordStore.clear_all()
        records.InMemoryRecordStore._data["rt1"] = [("K3", -0.0, 7), ("K99", 1.5, -1)]
        rt = mgr.create_siddhi_app_runtime(TABLE_APP)
        joined = []
        rt.add_callback("look", lambda t, ins, rem, _o=joined: _o.extend(
            tuple(e.data) for e in ins or []))
        rt.start()
        hs, hu, hd = (rt.get_input_handler(s) for s in "SUD")
        for i, row in enumerate(feed):
            hs.send(row, timestamp=i)
            if i % 5 == 2:
                hu.send((syms[i % 12], 0.25), timestamp=i)
            if i % 9 == 4:
                hd.send((syms[(i * 7) % 12],), timestamp=i)
        rows = [tuple(e.data) for e in rt.query("from T select sym, v, n")]
        rt.shutdown()
        stored = list(records.InMemoryRecordStore._data["rt1"])
        rt2 = mgr.create_siddhi_app_runtime(TABLE_APP)  # loads the snapshot
        lanes = _np_table(rt2.tables["T"].state) if name == "jax" else \
            state_to_numpy(rt2.tables["T"].state)
        rt2.shutdown()
        mgr.shutdown()
        records.InMemoryRecordStore.clear_all()
        got[name] = (joined, rows, stored, lanes)
    assert len(got["jax"][1]) > 10 and got["jax"][0]
    assert bench._rows_match(got["port"][:3], got["jax"][:3])
    np.testing.assert_equal(got["port"][3], got["jax"][3])


# ---------------------------------------------------------------------------
# parity: a lazy store
# ---------------------------------------------------------------------------


def _lazy_store(records, expr, calls: list):
    """A lazy store over 300 rows that pushes `v > <const>` down and returns
    every row for any other condition."""

    class Lazy(records.RecordStore):
        ROWS = [(f"S{i}", float(i) / 4, i % 7) for i in range(300)]

        def load(self):
            return None

        def query(self, on, interner):
            calls.append(on)
            if (isinstance(on, expr.Compare) and on.op is expr.CompareOp.GT
                    and isinstance(on.right, expr.Constant)):
                return [r for r in self.ROWS if r[1] > on.right.value]
            return list(self.ROWS)

    return Lazy


LAZY_QUERIES = ("from T on v > 70.0 select sym, v, n",
                "from T on n == 3 select sym, v order by v desc limit 4",
                "from T select n, count() as c group by n")


def test_lazy_store_pushdown_matches_jax():
    import siddhi_tpu.core.extension as jax_ext
    import siddhi_tpu.query_api.expression as jax_expr

    import siddhi_tpu_torch.core.extension as port_ext
    import siddhi_tpu_torch.query_api.expression as port_expr

    app = """define stream S (sym string, v double, n long);
    @store(type='lazymock') @capacity(size='512') define table T (sym string, v double, n long);"""
    got = {}
    for (name, mgr, records), ext, expr in zip(_pairs(), (jax_ext, port_ext),
                                               (jax_expr, port_expr)):
        calls = []
        ext.extension("store", "lazymock")(_lazy_store(records, expr, calls))
        rt = mgr.create_siddhi_app_runtime(app)
        rt.start()
        rows = [[tuple(e.data) for e in rt.query(q)] for q in LAZY_QUERIES]
        live = int(np.asarray(rt.tables["T"].state["valid"]).sum())
        rt.shutdown()
        mgr.shutdown()
        got[name] = (rows, [c is None for c in calls], live)
    assert got["jax"][0][0] and got["jax"][2] == 0
    assert bench._rows_match(got["port"], got["jax"])


def test_lazy_store_refuses_a_streaming_write_as_jax():
    app = """define stream S (sym string, v double, n long);
    @store(type='lazymock2') define table T (sym string, v double, n long);
    from S insert into T;"""
    import siddhi_tpu.core.extension as jax_ext
    import siddhi_tpu.query_api.expression as jax_expr

    import siddhi_tpu_torch.core.extension as port_ext
    import siddhi_tpu_torch.query_api.expression as port_expr

    errs = {}
    for (name, mgr, records), ext, expr in zip(_pairs(), (jax_ext, port_ext),
                                               (jax_expr, port_expr)):
        ext.extension("store", "lazymock2")(_lazy_store(records, expr, []))
        rt = mgr.create_siddhi_app_runtime(app)
        rt.start()
        with pytest.raises(Exception) as ei:
            rt.get_input_handler("S").send(("A", 1.0, 1), timestamp=1)
        errs[name] = (type(ei.value).__name__, str(ei.value))
        rt.shutdown()
        mgr.shutdown()
    assert errs["port"] == errs["jax"]


# ---------------------------------------------------------------------------
# parity: a @store aggregation, restarted
# ---------------------------------------------------------------------------

AGG_APP = """define stream S (symbol string, price float, volume long, ts long);
@store(type='memory', store.id='ragg')
define aggregation A from S select symbol, avg(price) as ap, sum(volume) as total,
min(price) as lo, max(price) as hi group by symbol aggregate by ts every sec ... hour;"""
AGG_QUERIES = ("from A per 'min' select AGG_TIMESTAMP, symbol, ap, total, lo, hi",
               "from A per 'hour' select AGG_TIMESTAMP, symbol, total")


def test_store_aggregation_restart_matches_jax():
    """Events over three minutes into a `@store` aggregation, then a restart
    without a snapshot: every duration table's lanes and the in-flight
    stores rebuilt from them bit for bit, and the store queries' rows."""
    rng = np.random.default_rng(77)
    t0 = 1_496_289_720_000
    n = 90
    events = [(["A", "B", "C"][int(rng.integers(0, 3))], float(np.float32(rng.uniform(1, 9))),
               int(rng.integers(1, 50)), t0 + 2_000 * i) for i in range(n)]
    got = {}
    for name, mgr, records in _pairs():
        records.InMemoryRecordStore.clear_all()
        rt = mgr.create_siddhi_app_runtime(AGG_APP)
        rt.start()
        h = rt.get_input_handler("S")
        for i, e in enumerate(events):
            h.send(e, timestamp=1 + i)
        before = [[tuple(x.data) for x in rt.query(q)] for q in AGG_QUERIES]
        rt.shutdown()
        rt2 = mgr.create_siddhi_app_runtime(AGG_APP)
        ar = rt2.aggregations["A"]
        tables = {t.table_id: (_np_table(t.state) if name == "jax" else state_to_numpy(t.state))
                  for t in ar.tables.values()}
        state = state_to_numpy(aggregation_state_from_jax(ar.state, "cpu") if name == "jax"
                               else ar.state)
        after = [[tuple(x.data) for x in rt2.query(q)] for q in AGG_QUERIES]
        rt2.shutdown()
        mgr.shutdown()
        records.InMemoryRecordStore.clear_all()
        got[name] = (before, after, tables, state)
    assert got["jax"][1][0] and any(int(t["valid"].sum()) for t in got["jax"][2].values())
    assert bench._rows_match(got["port"][:2], got["jax"][:2])
    for tid, lanes in got["jax"][2].items():
        np.testing.assert_equal(got["port"][2][tid], lanes, err_msg=tid)
    for part in ("keys", "used", "bucket", "vals"):
        np.testing.assert_equal(got["port"][3][part], got["jax"][3][part], err_msg=part)
