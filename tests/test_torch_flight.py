"""The flight recorder (`@flightRecorder(size='N')`, SIDDHI_TPU_FLIGHT=N) on
the port against the JAX package, on the CPU:

- tests/test_introspection.py's TestFlightRecorderUnit and
  TestFlightRecorderEngine under their own assertions with the port's
  SiddhiManager, FlightRecorder, StreamSchema, AttrType, InternTable and
  error class swapped in (the test that dumps into the error store waits
  for the error store);
- the same app and events through both packages: the recorded events of a
  per-batch and of a fused stream, the env override on every junction,
  beside @app:lineage's arena;
- malformed sizes and options raise JAX's class and message; a malformed or
  negative SIDDHI_TPU_FLIGHT arms nothing and an oversized one is clamped,
  as in JAX.

Everything is exact: the recorder keeps copies of the input rows.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402, F401

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.core.event import StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType, InternTable  # noqa: E402
from siddhi_tpu_torch.observability.flight import (  # noqa: E402
    FlightRecorder,
    flight_env_size,
)

MOD = "tests.test_introspection"
JAX_CASES = [
    ("TestFlightRecorderUnit", "test_ring_keeps_newest_oldest_first"),
    ("TestFlightRecorderUnit", "test_oversized_batch_keeps_only_tail"),
    ("TestFlightRecorderUnit", "test_wrap_across_batches"),
    ("TestFlightRecorderUnit", "test_string_attrs_decode_through_interner"),
    ("TestFlightRecorderEngine", "test_per_batch_sends_recorded"),
    ("TestFlightRecorderEngine", "test_fused_columnar_path_recorded"),
    ("TestFlightRecorderEngine", "test_env_override_arms_every_junction"),
    ("TestFlightRecorderEngine", "test_bad_annotation_rejected"),
]


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _managers():
    return siddhi_tpu.SiddhiManager(), _port()


@pytest.mark.parametrize("cname,fname", JAX_CASES)
def test_jax_flight_test_on_the_port(cname, fname, monkeypatch):
    """The test itself with the port's classes swapped in: its own
    assertions hold the port's rings."""
    mod = importlib.import_module(MOD)
    for name, obj in (("SiddhiManager", _port), ("FlightRecorder", FlightRecorder),
                      ("StreamSchema", StreamSchema), ("InternTable", InternTable),
                      ("AttrType", AttrType), ("SiddhiAppCreationError", SiddhiAppCreationError)):
        monkeypatch.setattr(mod, name, obj)
    case = getattr(mod, cname)()
    kw = {"monkeypatch": monkeypatch} if "env" in fname else {}
    getattr(case, fname)(**kw)


def test_annotated_stream_keeps_the_last_events_as_jax():
    """The app the port used to accept silently: @flightRecorder(size='4')
    keeps the last four events, as JAX does."""
    ql = ("@flightRecorder(size='4') define stream S (v long);\n"
          "from S select v insert into Out;")
    recs = []
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        for i in range(6):
            rt.get_input_handler("S").send([i], timestamp=1000 + i)
        recs.append(rt.flight_record("S"))
        assert rt.junctions["S"].flight.describe_state()["total"] == 6
        mgr.shutdown()
    assert recs[0] == recs[1] == [(1002, (2,)), (1003, (3,)), (1004, (4,)), (1005, (5,))]


@pytest.mark.parametrize("fused", [False, True])
def test_recorded_events_match_jax(fused):
    """A string, float and long stream with @flightRecorder(size='50'),
    beside @app:lineage: 96 events through send_columns (the fused path, or
    per batch with the engines detached) — the ring, its describe_state and
    the insert target's ring (env override) equal JAX's."""
    ql = ("@app:batch(size='16') @app:lineage(capacity='64')\n"
          "@flightRecorder(size='50') define stream S (symbol string, price float, volume long);\n"
          "@info(name='q') from S[price > 20]#window.length(4) "
          "select symbol, sum(volume) as v insert into Out;")
    rng = np.random.default_rng(5)
    n = 96
    ts = 1_700_000_000_000 + 3 * np.arange(n, dtype=np.int64)
    syms = rng.choice(["A", "B", "C"], n)
    price = rng.uniform(0, 100, n).astype(np.float32)
    vol = rng.integers(1, 1000, n).astype(np.int64)
    got = []
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        if not fused:
            rt.junctions["S"].fused_ingest = None
        ids = {s: mgr.interner.intern(s) for s in ("A", "B", "C")}
        rt.get_input_handler("S").send_columns(
            ts, {"symbol": np.asarray([ids[s] for s in syms], np.int32), "price": price,
                 "volume": vol}, now=int(ts[-1]))
        fi = rt.junctions["S"].fused_ingest
        got.append((rt.flight_record("S"), rt.junctions["S"].flight.describe_state(),
                    rt.junctions["S"].lineage.describe_state(),
                    fi.chunks_dispatched if fi is not None else 0))
        mgr.shutdown()
    assert got[0][:3] == got[1][:3]
    assert len(got[1][0]) == 50 and got[1][0][-1][1][0] == syms[-1]
    assert (got[1][3] > 0) == fused


def test_env_override_and_annotation_sizes_match_jax(monkeypatch):
    """SIDDHI_TPU_FLIGHT arms every junction (the insert target too); an
    explicit larger @flightRecorder size wins on its stream."""
    monkeypatch.setenv("SIDDHI_TPU_FLIGHT", "3")
    ql = ("@flightRecorder(size='5') define stream S (v long);\n"
          "define stream T (v long);\n"
          "from S select v insert into Out;\nfrom T select v insert into Out2;")
    got = []
    for mgr in _managers():
        rt = mgr.create_siddhi_app_runtime(ql)
        rt.start()
        for i in range(7):
            rt.get_input_handler("S").send([i], timestamp=10 + i)
        rt.get_input_handler("T").send([99], timestamp=20)
        got.append((rt.flight_records(), mgr.flight_records(),
                    {sid: j.flight.size for sid, j in rt.junctions.items()}))
        mgr.shutdown()
    assert got[0] == got[1]
    assert got[1][2] == {"S": 5, "T": 3, "Out": 3, "Out2": 3}


@pytest.mark.parametrize("ann", ["size='0'", "size='x'", "size='70000'", "turbo='on'",
                                 "'12', '13'"])
def test_malformed_annotation_raises_as_jax(ann):
    ql = f"@flightRecorder({ann}) define stream S (v long);\nfrom S select v insert into O;"
    msgs = []
    for mgr in _managers():
        with pytest.raises(Exception) as ei:
            mgr.create_siddhi_app_runtime(ql)
        msgs.append((type(ei.value).__name__, str(ei.value)))
    assert msgs[0] == msgs[1], msgs
    assert msgs[1][1].startswith("stream 'S': ")


@pytest.mark.parametrize("value,want", [("", 0), ("abc", 0), ("-3", 0), ("7", 7),
                                        ("999999", 65536)])
def test_env_size_rules_match_jax(value, want, monkeypatch):
    from siddhi_tpu.observability.flight import flight_env_size as jax_env_size

    monkeypatch.setenv("SIDDHI_TPU_FLIGHT", value)
    assert flight_env_size() == jax_env_size() == want
