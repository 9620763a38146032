"""Order-by, limit/offset, output rate limiting, stream functions, script
functions and #inner streams inside partitions end to end through both
packages on the CPU (JAX `siddhi_tpu` and the port on device="cpu"), at
batch 16 and 33; and paths PTE, PTB and PTT of chip_smoke.py at a small
size. The helpers are test_torch_partition_windows_e2e.py's. Floats match
to a relative 2e-4 (bench.py:_rows_match); everything else exactly.
"""

import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from tests.test_torch_partition_windows_e2e import (  # noqa: E402,F401
    _events,
    _managers,
    _pkg,
    _run,
    check_app,
    small_windows,
)

# name -> (body, playback)
APPS = {
    "order_by_limit": ("@info(name='q') from S#window.length(3) select symbol, price "
                       "order by price desc limit 2 offset 1 insert into Out;", False),
    "order_by_batch": ("@info(name='q') from S#window.lengthBatch(4) select symbol, price, "
                       "volume order by volume, price desc insert into Out;", False),
    "limit": ("@info(name='q') from S select symbol, price limit 2 insert into Out;", False),
    "output_last": ("@info(name='q') from S select symbol, price output last every 3 events "
                    "insert into Out;", False),
    "output_first_grouped": ("@info(name='q') from S select symbol, volume, sum(price) as s "
                             "group by volume output first every 4 events insert into Out;",
                             False),
    "output_all": ("@info(name='q') from S#window.lengthBatch(2) select symbol, sum(price) as s "
                   "output all every 5 events insert into Out;", False),
    "output_all": ("@info(name='q') from S#window.lengthBatch(2) select symbol, sum(price) as s "
                   "output all every 5 events insert into Out;", False),
    "pol2cart": ("@info(name='q') from S#pol2Cart(price, volume)[x > 0] select symbol, x, y "
                 "insert into Out;", False),
    "script_function": ("@info(name='q') from S#window.lengthBatch(2) select symbol, "
                        "twice(price) as p2, sum(volume) as t insert into Out;", False),
    "inner_batch_time": (
        "@info(name='a') from S#window.lengthBatch(2) select symbol, sum(volume) as t "
        "insert into #A; @info(name='q') from #A#window.time(1 sec) select symbol, "
        "sum(t) as tt, count() as n insert all events into Out;", True),
    "inner_group_time_batch": (
        "@info(name='a') from S[price > 5] select symbol, volume, price insert into #A; "
        "@info(name='q') from #A#window.timeBatch(1 sec) select symbol, volume, "
        "sum(price) as s group by volume insert into Out;", True),
}
FUNCTION = "define function twice[python] return double { return data[0] * 2.0 };\n"


@pytest.mark.parametrize("batch", [16, 33])
@pytest.mark.parametrize("name", sorted(APPS))
def test_app_matches_jax(name, batch):
    check_app(APPS, name, batch, FUNCTION if name == "script_function" else "")


@pytest.mark.parametrize("path", ["PTE", "PTB", "PTT"])
def test_chip_smoke_paths_match_jax(path):
    """chip_smoke's partitioned window paths at batch 33, capacity 16 over
    12 keys (PTB's three price bands as written), in calls of 40 events."""
    ql = chip_smoke.partition_window_app(path, batch=33, cap=16).replace("StockStream", "S")
    rows, ts = _events(160, 12, seed=len(path))
    got = {_pkg(m): _run(m, ql, rows, ts, 40) for m in _managers()}
    assert len(got["siddhi_tpu"]["Out"]) > 10
    assert bench._rows_match(got["siddhi_tpu_torch"], got["siddhi_tpu"])
