"""Named windows and triggers end to end through both packages on the CPU:
the same SiddhiQL app and the same events through `siddhi_tpu` (JAX) and
`siddhi_tpu_torch` (device="cpu"), rows compared in order (ints and strings
exactly, floats within bench.py:_rows_match's relative 2e-4):

- every test of tests/test_named_window_trigger.py under its own
  assertions with the port's SiddhiManager (and cron parser) swapped in,
  the wall-clock trigger tests among them;
- every window type as a named window, the three `output` modes, two
  readers, `insert into W` from a filtering query;
- named-window join sides: the stream side and the window side
  triggering, `unidirectional` on either, `insert all events`;
- store queries over a named window with `on`, `group by`, `order by`,
  `limit` and `offset`;
- triggers `at every`, cron and `'start'` under @app:playback;
- chip_smoke.py's path NW at a small width (send_columns, one trigger step
  every few calls, the store query after each call);
- the partition forms: `insert into W` from inside a partition runs, and
  reading W inside a partition (or partitioning W) raises JAX's class and
  message.
"""

import importlib
import inspect

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402, F401

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.utils.cron import CronSchedule  # noqa: E402

HEAD = "@app:playback @app:batch(size='16')\n" \
       "define stream S (symbol string, price float, volume long, ets long);\n"


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _managers():
    return siddhi_tpu.SiddhiManager(), _port()


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _feed(n: int = 60, seed: int = 15):
    rng = np.random.default_rng(seed)
    rows = [(["A", "B", "C", "D"][int(rng.integers(0, 4))],
             float(np.round(rng.uniform(0, 100), 3)), int(rng.integers(1, 400)), 1 + 29 * i)
            for i in range(n)]
    return rows, [1 + 37 * i for i in range(n)]


def _collector(rows: list):
    return lambda t, ins, rem: rows.extend(
        [("+",) + tuple(e.data) for e in (ins or [])]
        + [("-",) + tuple(e.data) for e in (rem or [])])


def _run(ql, queries=("r1",), streams=(), store_queries=(), feed=None, send=None):
    """Each package: the app under HEAD, a callback on each query id and
    stream name, the events one a send (after a send_many of the first 16),
    then the store queries. Returns {package: [rows of each, in order]}."""
    rows, ts = feed or _feed()
    got = {}
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(HEAD + ql)
        outs = [[] for _ in (*queries, *streams)]
        for q, o in zip(queries, outs):
            rt.add_callback(q, _collector(o))
        for s, o in zip(streams, outs[len(queries):]):
            rt.add_callback(s, lambda evs, _o=o: _o.extend(tuple(e.data) for e in evs))
        rt.start()
        if send is not None:
            send(rt, rows, ts)
        else:
            h = rt.get_input_handler("S")
            h.send_many(rows[:16], timestamps=ts[:16])
            for r, t in zip(rows[16:], ts[16:]):
                h.send(r, timestamp=t)
        for q in store_queries:
            outs.append([tuple(e.data) for e in rt.query(q)])
        rt.shutdown()
        mgr.shutdown()
        got[_pkg(mgr)] = outs
    return got


def _match(got):
    assert any(got["siddhi_tpu"]), "the JAX package delivered nothing"
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])


# ---------------------------------------------------------------------------
# the JAX package's named-window and trigger tests, on the port
# ---------------------------------------------------------------------------

MOD = "tests.test_named_window_trigger"


def _jax_cases():
    mod = importlib.import_module(MOD)
    return [(name, m) for name, obj in sorted(vars(mod).items())
            if name.startswith("Test") and inspect.isclass(obj)
            for m in sorted(vars(obj)) if m.startswith("test")]


def test_every_named_window_trigger_test_is_covered():
    assert len(_jax_cases()) == 12


@pytest.mark.parametrize("cname,fname", _jax_cases())
def test_jax_named_window_trigger_test_on_the_port(cname, fname, monkeypatch):
    """The test itself with every SiddhiManager it makes the port's, and the
    port's cron parser: its own assertions hold the port's rows."""
    mod = importlib.import_module(MOD)
    monkeypatch.setattr(mod, "SiddhiManager", _port)
    monkeypatch.setattr(mod, "CronSchedule", CronSchedule)
    getattr(getattr(mod, cname)(), fname)()


# ---------------------------------------------------------------------------
# every window type as a named window
# ---------------------------------------------------------------------------

WINDOWS = [
    ("length(4)", "all"), ("length(4)", "current"), ("length(4)", "expired"),
    ("time(100)", "all"), ("timeLength(200, 3)", "expired"), ("externalTime(ets, 90)", "all"),
    ("lengthBatch(4)", "all"), ("timeBatch(200)", "current"),
    ("externalTimeBatch(ets, 100)", "all"), ("sort(3, price, 'desc')", "all"),
    ("frequent(2, symbol)", "all"), ("lossyFrequent(0.3, 0.1, symbol)", "all"),
    ("cron('*/1 * * * * ?')", "all"),
]


@pytest.mark.parametrize("window,mode", WINDOWS)
def test_named_window_types_match_jax(window, mode):
    """`insert into W` from a filtering query; two readers (a projection of
    every event kind and a grouped sum); a store query over the live
    window at the end."""
    ql = (f"define window W (symbol string, price float, volume long, ets long) {window} "
          f"output {mode} events;\n"
          "from S[price > 10] select symbol, price, volume, ets insert into W;\n"
          "@info(name='r1') from W select symbol, price insert all events into O1;\n"
          "@info(name='r2') from W select symbol, sum(volume) as t group by symbol "
          "insert into O2;")
    _match(_run(ql, queries=("r1", "r2"), store_queries=("from W select symbol, price",)))


# ---------------------------------------------------------------------------
# named-window join sides
# ---------------------------------------------------------------------------

JOIN_HEAD = ("define stream Q (sym string, lim float);\n"
             "define window W (symbol string, price float, volume long, ets long) length(6) "
             "output all events;\n"
             "from S insert into W;\n")
JOINS = [
    # the stream side triggers; the window side triggers too
    "@info(name='r1') from Q#window.length(3) join W on Q.sym == W.symbol "
    "select Q.sym as s, W.price as p, Q.lim as l insert into O;",
    # the stream side alone
    "@info(name='r1') from Q#window.length(3) unidirectional join W on W.price > Q.lim "
    "select Q.sym as s, W.symbol as w, W.price as p insert into O;",
    # the window side alone, its expired emissions probing too
    "@info(name='r1') from W unidirectional join Q#window.length(3) on W.symbol == Q.sym "
    "select W.symbol as s, W.price as p, Q.lim as l insert all events into O;",
    # an outer join from the window's side
    "@info(name='r1') from W left outer join Q#window.length(2) on W.symbol == Q.sym "
    "select W.symbol as s, Q.lim as l insert into O;",
]


def _send_both(rt, rows, ts):
    hs, hq = rt.get_input_handler("S"), rt.get_input_handler("Q")
    for i, (r, t) in enumerate(zip(rows, ts)):
        hs.send(r, timestamp=t)
        if i % 3 == 1:
            hq.send((["A", "B", "C", "D"][i % 4], float(20 * (i % 5))), timestamp=t + 1)


@pytest.mark.parametrize("ql", JOINS)
def test_named_window_join_sides_match_jax(ql):
    _match(_run(JOIN_HEAD + ql, send=_send_both))


# ---------------------------------------------------------------------------
# store queries over a named window
# ---------------------------------------------------------------------------

STORE_QUERIES = (
    "from W select symbol, price, volume",
    "from W on price > 30 select symbol, price",
    "from W select symbol, sum(volume) as t group by symbol",
    "from W select symbol, sum(volume) as t group by symbol order by t desc limit 2",
    "from W on volume > 50 select symbol, price order by price desc limit 3 offset 1",
    "from W select count() as n, max(price) as mx",
)


@pytest.mark.parametrize("window", ["length(12)", "lengthBatch(7)", "time(400)"])
def test_store_queries_over_a_named_window_match_jax(window):
    ql = (f"define window W (symbol string, price float, volume long, ets long) {window};\n"
          "from S insert into W;")
    got = _run(ql, queries=(), store_queries=STORE_QUERIES)
    assert all(got["siddhi_tpu"][:2])
    _match(got)


# ---------------------------------------------------------------------------
# triggers under @app:playback
# ---------------------------------------------------------------------------

TRIGGERS = [
    "define trigger T at every 500 milliseconds;",
    "define trigger T at '*/1 * * * * ?';",
    "define trigger T at 'start';",
]


@pytest.mark.parametrize("trigger", TRIGGERS)
def test_triggers_under_playback_match_jax(trigger):
    """The trigger's own stream, a query reading it, and a join of its
    fires against a window of S."""
    ql = (trigger + "\n@info(name='r1') from T select triggered_time insert into O1;\n"
          "@info(name='r2') from T join S#window.length(2) as s "
          "select T.triggered_time as t, s.symbol as sym insert into O2;")
    got = _run(ql, queries=("r1", "r2"), streams=("T",))
    assert got["siddhi_tpu"][0]
    _match(got)


# ---------------------------------------------------------------------------
# path NW at a small width
# ---------------------------------------------------------------------------


def _nw_run(mgr, app: str, data: dict, names, calls: int, size: int) -> dict:
    """chip_smoke.run_nw's drive for either package: send_columns of
    pre-interned trades, the store query after each call."""
    rt = mgr.create_siddhi_app_runtime(app)
    for s in names:
        mgr.interner.intern(s)
    cur = {k: [] for k in ("board", "avg", "top", "ticks")}
    for q in ("board", "avg", "top"):
        rt.add_callback(q, lambda t, ins, rem, _q=q: cur[_q].extend(
            tuple(e.data) for e in ins or []))
    rt.add_callback("Tick", lambda evs: cur["ticks"].extend(e.data[0] for e in evs))
    rt.start()
    h = rt.get_input_handler("Trades")
    out = {k: [] for k in (*cur, "query")}
    for c in range(calls):
        for v in cur.values():
            v.clear()
        lo, hi = c * size, (c + 1) * size
        h.send_columns(data["ts"][lo:hi], {k: data[k][lo:hi]
                                           for k in ("symbol", "venue", "price", "volume")}, now=0)
        out["query"].append([tuple(e.data) for e in rt.query(chip_smoke.NW_QUERY)])
        for k, v in cur.items():
            out[k].append(list(v))
    rt.shutdown()
    mgr.shutdown()
    return out


def test_nw_path_small_matches_jax():
    """chip_smoke.py's NW app with a 512-row window, 256-event calls (the
    trigger fires every fourth call), 12 calls: every callback's rows and
    the store query's, call by call."""
    w, size, calls = 512, 256, 12
    data, names = chip_smoke.nw_data(calls * size)
    app = chip_smoke.nw_app(w=w, batch=size, groups=4096)
    got = {_pkg(m): _nw_run(m, app, data, names, calls, size) for m in _managers()}
    want = got["siddhi_tpu"]
    assert sum(map(len, want["ticks"])) >= 2 and any(len(b) == 10 for b in want["board"])
    for k in want:
        assert bench._rows_match(got["siddhi_tpu_torch"][k], want[k]), k


# ---------------------------------------------------------------------------
# the partition forms
# ---------------------------------------------------------------------------


def test_insert_into_a_named_window_from_a_partition_matches_jax():
    ql = ("define window W (symbol string, price float) length(5) output all events;\n"
          "partition with (symbol of S) begin\n"
          "from S#window.length(2) select symbol, max(price) as price insert into W;\nend;\n"
          "@info(name='r1') from W select symbol, price insert all events into O;")
    _match(_run(ql))


PARTITION_REFUSALS = [
    # reading a named window inside a partition
    "define window W (symbol string, price float) length(5);\n"
    "from S select symbol, price insert into W;\n"
    "partition with (symbol of S) begin from W select symbol insert into O; end;",
    # joining one inside a partition
    "define window W (symbol string, price float) length(5);\n"
    "partition with (symbol of S) begin from S#window.length(2) join W "
    "on S.symbol == W.symbol select S.symbol as s insert into O; end;",
    # partitioning one
    "define window W (symbol string, price float) length(5);\n"
    "partition with (symbol of W) begin from W select symbol insert into O; end;",
]


@pytest.mark.parametrize("ql", PARTITION_REFUSALS)
def test_named_window_partition_forms_raise_as_jax(ql):
    errs = {}
    for mgr in _managers():
        with pytest.raises(Exception) as ei:
            mgr.create_siddhi_app_runtime(HEAD + ql)
        errs[_pkg(mgr)] = (type(ei.value).__name__, str(ei.value))
        mgr.shutdown()
    assert errs["siddhi_tpu_torch"] == errs["siddhi_tpu"]


def test_onerror_on_a_named_window_raises():
    """@OnError on a window definition stays outside the port."""
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        _port().create_siddhi_app_runtime(
            HEAD + "@OnError(action='LOG') define window W (symbol string) length(2);\n"
            "from S select symbol insert into W;")
