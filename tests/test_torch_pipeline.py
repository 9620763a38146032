"""The port's double-buffered ingest pipeline (siddhi_tpu_torch/core/pipeline.py),
on the CPU, as tests/test_pipeline.py holds the JAX package's: pipelined
sends deliver exactly what serial sends deliver (same rows, same per-batch
callback grouping, same order), callbacks complete before send_columns
returns, the @pipeline options and the env override resolve as in the JAX
package, pooled slots are never aliased by a shipped chunk, and drain
failures go to the exception handler or back to the sender. Tolerance: none —
pipelined and serial run the same operations on the same inputs.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.core import pipeline as JP  # noqa: E402
from siddhi_tpu_torch.core import pipeline as PP  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate_pipeline_env(monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_PIPELINE", raising=False)


HEAD = "@app:batch(size='64')\ndefine stream S (symbol string, price float, volume long);\n"
SERIAL_HEAD = (
    "@app:batch(size='64')\n@pipeline(disable='true')\n"
    "define stream S (symbol string, price float, volume long);\n"
)
CB_BODY = """@info(name='q') from S#window.length(16)
    select symbol, avg(price) as ap insert into Out;"""


def _feed(n, seed=42):
    rng = np.random.default_rng(seed)
    return (
        np.arange(n, dtype=np.int64) + 1_700_000_000_000,
        {
            "symbol": rng.integers(1, 5, size=n).astype(np.int32),
            "price": rng.uniform(0.0, 100.0, size=n).astype(np.float32),
            "volume": rng.integers(1, 100, size=n).astype(np.int64),
        },
    )


def _boot(ql, callback=None):
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(ql)
    if callback is not None:
        rt.add_callback("q", callback)
    for s in ["A", "B", "C", "D"]:
        mgr.interner.intern(s)
    rt.start()
    return mgr, rt


def _run_cb(ql, n, sends=1):
    got = []
    mgr, rt = _boot(ql, callback=lambda ts, ins, rem: got.append((
        ts, [tuple(e.data) for e in (ins or [])], [tuple(e.data) for e in (rem or [])],
    )))
    ts, cols = _feed(n)
    step = n // sends
    for lo in range(0, n, step):
        rt.get_input_handler("S").send_columns(
            ts[lo : lo + step], {k: v[lo : lo + step] for k, v in cols.items()})
    fi = rt.junctions["S"].fused_ingest
    stats = fi.describe_state()
    rt.shutdown()
    mgr.shutdown()
    return got, stats


@pytest.mark.parametrize("n,sends", [(64 * 40, 1), (64 * 70 + 3, 2), (64 * 9, 3)])
def test_pipelined_delivery_matches_serial(n, sends):
    pipelined, ps = _run_cb(HEAD + CB_BODY, n, sends)
    serial, ss = _run_cb(SERIAL_HEAD + CB_BODY, n, sends)
    assert ps["pipeline_enabled"] and not ss["pipeline_enabled"]
    assert ps["chunks"] == ss["chunks"] > 0
    assert pipelined == serial
    assert sum(len(i) for _t, i, _r in pipelined) > 50


def test_callbacks_complete_before_send_returns():
    order = []
    mgr, rt = _boot(
        HEAD + "@info(name='q') from S[price >= 0] select symbol, price insert into Out;",
        callback=lambda ts, ins, rem: order.extend(p for _s, p in (e.data for e in (ins or []))),
    )
    h = rt.get_input_handler("S")
    ts, cols = _feed(64 * 8)
    cols["price"] = np.arange(64 * 8, dtype=np.float32)
    h.send_columns(ts, cols)
    n_before = len(order)
    assert n_before == 64 * 8  # everything drained before send returned
    assert order == [float(i) for i in range(64 * 8)]
    h.send(("A", 1e6, 1))
    assert order[-1] == 1e6 and len(order) == n_before + 1
    rt.shutdown()
    mgr.shutdown()


def test_reentrant_send_from_callback_takes_serial_path():
    """A callback that sends again runs on the drain worker; its send must
    not wait on the pipeline it is draining."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        HEAD + "@info(name='q') from S[price >= 0] select symbol, price insert into Out;")
    for s in ["A", "B", "C", "D"]:
        mgr.interner.intern(s)
    h = rt.get_input_handler("S")
    seen, again = [], []

    def cb(ts, ins, rem):
        seen.append(len(ins))
        if not again:
            again.append(1)
            t2, c2 = _feed(64 * 2, seed=7)
            h.send_columns(t2 + 10**6, c2)

    rt.add_callback("q", cb)
    rt.start()
    h.send_columns(*_feed(64 * 4))
    assert sum(seen) == 64 * 6
    assert rt.junctions["S"].fused_ingest.chunks_dispatched == 2
    rt.shutdown()


@pytest.mark.parametrize("head", [HEAD, SERIAL_HEAD], ids=["pipelined", "serial"])
def test_concurrent_senders_lose_no_event(head):
    """More sender threads than cores, with a short switch interval: every
    event of every call is delivered once, and the engine counts each."""
    mgr, rt = _boot(head + "@info(name='q') from S[price >= 0] select symbol, price "
                    "insert into Out;", callback=lambda ts, ins, rem: got.append(len(ins)))
    h = rt.get_input_handler("S")
    got, errors = [], []
    sizes = [64 * 2, 64 * 3 + 5, 64 * 4]

    def sender(seed):
        try:
            for n in sizes:
                h.send_columns(*_feed(n, seed=seed))
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=sender, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert sum(got) == 12 * sum(sizes)
    assert rt.junctions["S"].fused_ingest.events_fused == 12 * sum(sizes)
    rt.shutdown()


def _fused(rt):
    fi = rt.junctions["S"].fused_ingest
    assert fi is not None
    return fi


def test_pipeline_annotation_depth_and_disable():
    mgr, rt = _boot(
        "@app:batch(size='64')\n@pipeline(depth='3')\n"
        "define stream S (symbol string, price float, volume long);\n" + CB_BODY
    )
    fi = _fused(rt)
    assert fi.pipeline_enabled and fi.pipeline_depth == 3
    rt.shutdown()
    mgr, rt = _boot(SERIAL_HEAD + CB_BODY)
    assert not _fused(rt).pipeline_enabled
    rt.shutdown()


BAD = ["@pipeline(depth='x')", "@pipeline(depth='0')", "@pipeline(depth='64')",
       "@pipeline(disable='maybe')", "@pipeline(bogus='1')"]


@pytest.mark.parametrize("ann", BAD)
def test_pipeline_annotation_rejects_bad_options(ann):
    ql = f"@app:batch(size='64')\n{ann}\ndefine stream S (symbol string, price float, " \
         "volume long);\n" + CB_BODY
    with pytest.raises(SiddhiAppCreationError):
        siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)


class _Ann:
    def __init__(self, elements):
        self.elements = elements

    def element(self, key, default=None):
        for k, v in self.elements:
            if k == key:
                return v
        return default


@pytest.mark.parametrize("elements", [
    [], [("depth", "3")], [("disable", "true")], [("depth", "x")], [("bogus", "1")],
    [(None, "2")], [("depth", "8"), ("disable", "false")],
])
@pytest.mark.parametrize("env", [None, "0", "1"])
def test_resolution_agrees_with_jax(elements, env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("SIDDHI_TPU_PIPELINE", env)
    ann = _Ann(elements)
    assert list(PP.iter_pipeline_annotation_problems(ann)) == list(
        JP.iter_pipeline_annotation_problems(ann))
    try:
        want = JP.resolve_pipeline_annotation(ann)
    except siddhi_tpu.core.errors.SiddhiAppCreationError:
        with pytest.raises(SiddhiAppCreationError):
            PP.resolve_pipeline_annotation(ann)
        return
    assert PP.resolve_pipeline_annotation(ann) == want


def test_pipeline_env_override(monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_PIPELINE", "0")
    mgr, rt = _boot(HEAD + CB_BODY)
    assert not _fused(rt).pipeline_enabled
    rt.shutdown()
    monkeypatch.setenv("SIDDHI_TPU_PIPELINE", "1")
    mgr, rt = _boot(SERIAL_HEAD + CB_BODY)  # env wins over disable='true'
    assert _fused(rt).pipeline_enabled
    rt.shutdown()


class _Schema:
    stream_id = "S"


class _Junction:
    schema = _Schema()
    exception_handler = None


class _Event:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_wire_slot_reuse_gated_per_shipment():
    """A shipped chunk never aliases its pooled slot (on the CPU: a copy), a
    slot is reused round-robin, and acquire() waits on the slot's copy
    event before handing the buffer out again."""
    pl = PP.IngestPipeline(_Junction(), "cpu", depth=2)
    a = pl.acquire(2, 16)
    a.wire[:] = 7
    a.counts[:] = (3, 4)
    a.bases[:] = (10, 20)
    wire, counts, bases = pl.ship(a)
    assert wire.data_ptr() != a.host.data_ptr()
    a.wire[:] = 0  # a later encode into the slot does not reach the shipment
    assert bool((wire == 7).all())
    assert counts.tolist() == [3, 4] and bases.tolist() == [10, 20]
    pl.retire(a)
    assert a.dev is None
    b = pl.acquire(2, 16)
    assert b is not a  # depth 2: two slots per (K, bytes)
    ev = _Event()
    a.event = ev  # a copy out of `a` is pending (as ship() records on the card)
    assert pl.acquire(2, 16) is a and ev.waited == 1 and a.event is None
    assert pl.acquire(4, 16) not in (a, b)  # another K: another pool
    pl.close()


def _boom(ts, ins, rem):
    raise RuntimeError("poisoned callback")


@pytest.mark.parametrize("head", [HEAD, SERIAL_HEAD], ids=["pipelined", "serial"])
def test_drain_error_routes_to_exception_handler(head):
    mgr, rt = _boot(head + CB_BODY, callback=_boom)
    seen = []
    rt.set_exception_handler(seen.append)
    rt.get_input_handler("S").send_columns(*_feed(64 * 8))  # must not raise
    assert seen and isinstance(seen[0], RuntimeError)
    rt.shutdown()


@pytest.mark.parametrize("head", [HEAD, SERIAL_HEAD], ids=["pipelined", "serial"])
def test_drain_error_propagates_without_handler(head):
    mgr, rt = _boot(head + CB_BODY, callback=_boom)
    with pytest.raises(RuntimeError, match="poisoned callback"):
        rt.get_input_handler("S").send_columns(*_feed(64 * 8))
    rt.shutdown()


def test_drain_error_matches_jax_routing():
    """The JAX package routes the same poisoned delivery the same way."""
    for mgr in (siddhi_tpu.SiddhiManager(), siddhi_tpu_torch.SiddhiManager(device="cpu")):
        rt = mgr.create_siddhi_app_runtime(HEAD + CB_BODY)
        rt.add_callback("q", _boom)
        for s in ["A", "B", "C", "D"]:
            mgr.interner.intern(s)
        seen = []
        rt.set_exception_handler(seen.append)
        rt.start()
        rt.get_input_handler("S").send_columns(*_feed(64 * 8))
        assert seen and str(seen[0]) == "poisoned callback"
        rt.shutdown()
        mgr.shutdown()
