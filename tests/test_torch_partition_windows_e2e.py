"""The time and batch windows inside partitions, end to end through both
packages on the CPU: the same SiddhiQL app and events through `siddhi_tpu`
(JAX) and `siddhi_tpu_torch` (device="cpu") — time, timeLength,
externalTime, lengthBatch, timeBatch (with a start time) and
externalTimeBatch (with an idle timeout) inside a partition, at batch 16 and
33, under @app:playback where time matters. Group-by inside a partition is
in test_torch_partition_groupby_e2e.py; order-by, limit, rate limiting,
stream functions, #inner streams and chip_smoke's paths in
test_torch_partition_select_e2e.py; they share this file's helpers. Floats
match to a relative 2e-4 (bench.py:_rows_match); everything else exactly.
Both packages' time windows run at 64 slots (`make_window.__defaults__`):
the JAX distinctCount builds a [rows, K, K] mask.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.core import windows as jax_windows  # noqa: E402
from siddhi_tpu_torch.core import windows as port_windows  # noqa: E402

SMALL_W = 64
HEAD = ("@app:batch(size='{batch}') @app:partitionCapacity(size='16') {extra}\n"
        "define stream S (symbol string, price float, volume long, ets long);\n")
PART = "partition with (symbol of S) begin\n{body}\nend;"


@pytest.fixture(autouse=True)
def small_windows(monkeypatch):
    """Both packages' time windows at SMALL_W slots."""
    for mod in (jax_windows, port_windows):
        monkeypatch.setattr(mod.make_window, "__defaults__", (SMALL_W,))


def _managers():
    return siddhi_tpu.SiddhiManager(), siddhi_tpu_torch.SiddhiManager(device="cpu")


def _pkg(mgr) -> str:
    return type(mgr).__module__.split(".")[0]


def _events(n: int, symbols: int, seed: int, volumes: int = 4):
    """Rows of 12 keys, 37 ms apart, `ets` out of order by up to 60 ms."""
    rng = np.random.default_rng(seed)
    ts = [1_700_000_000_000 + 37 * i for i in range(n)]
    rows = [(f"K{int(rng.integers(0, symbols))}", float(np.float32(rng.uniform(0, 100))),
             int(rng.integers(1, volumes + 1)), ts[i] + int(rng.integers(-60, 61)))
            for i in range(n)]
    return rows, ts


def _run(mgr, ql, rows, ts, chunk, outs=("Out",)):
    rt = mgr.create_siddhi_app_runtime(ql)
    got = {o: [] for o in outs}
    for o in outs:
        rt.add_callback(o, lambda evs, _g=got[o]: _g.extend(tuple(e.data) for e in evs))
    rt.start()
    h = rt.get_input_handler("S")
    for lo in range(0, len(rows), chunk):
        h.send_many(rows[lo:lo + chunk], timestamps=ts[lo:lo + chunk])
    rt.shutdown()
    mgr.shutdown()
    return got


# name -> (body, playback)
APPS = {
    "time": ("@info(name='q') from S#window.time(1 sec) select symbol, sum(volume) as t, "
             "max(price) as hi, count() as n insert all events into Out;", True),
    "time_length": ("@info(name='q') from S#window.timeLength(1 sec, 3) select symbol, "
                    "avg(price) as ap, min(price) as lo insert all events into Out;", True),
    "external_time": ("@info(name='q') from S#window.externalTime(ets, 500) select symbol, "
                      "count() as n, min(price) as lo, distinctCount(volume) as dc "
                      "insert all events into Out;", False),
    "length_batch": ("@info(name='q') from S#window.lengthBatch(3) select symbol, "
                     "sum(volume) as t, count() as n insert all events into Out;", False),
    "length_batch_current": ("@info(name='q') from S#window.lengthBatch(3) select symbol, "
                             "sum(volume) as t insert into Out;", False),
    "time_batch": ("@info(name='q') from S#window.timeBatch(1 sec) select symbol, "
                   "sum(volume) as t, count() as n insert into Out;", True),
    "time_batch_start": ("@info(name='q') from S#window.timeBatch(1 sec, 1700000000100) "
                         "select symbol, "
                         "avg(price) as ap, max(price) as hi insert all events into Out;", True),
    "external_time_batch": ("@info(name='q') from S#window.externalTimeBatch(ets, 500) "
                            "select symbol, sum(price) as s insert all events into Out;", False),
    "external_time_batch_timeout": (
        "@info(name='q') from S#window.externalTimeBatch(ets, 500, 0, 300) select symbol, "
        "sum(price) as s, count() as n insert all events into Out;", True),
}


def _app(apps: dict, name: str, batch: int, prelude: str = "") -> str:
    body, playback = apps[name]
    extra = "@app:playback" if playback else ""
    return HEAD.format(batch=batch, extra=extra) + prelude + PART.format(body=body)


def check_app(apps: dict, name: str, batch: int, prelude: str = "") -> None:
    """An app at its batch size through both packages, in calls of 2.5
    batches, 12 keys in a 16-slot key table: the same rows."""
    rows, ts = _events(5 * batch, 12, seed=batch + len(name))
    ql = _app(apps, name, batch, prelude)
    got = {_pkg(m): _run(m, ql, rows, ts, 5 * batch // 2) for m in _managers()}
    want = got["siddhi_tpu"]
    assert len(want["Out"]) > 3
    assert bench._rows_match(got["siddhi_tpu_torch"], want)


@pytest.mark.parametrize("batch", [16, 33])
@pytest.mark.parametrize("name", sorted(APPS))
def test_app_matches_jax(name, batch):
    check_app(APPS, name, batch)
