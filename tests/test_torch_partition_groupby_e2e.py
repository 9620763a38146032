"""Group-by inside partitions end to end through both packages on the CPU
(JAX `siddhi_tpu` and the port on device="cpu"): one group table a
partition (K33), with every aggregator, having, the batch-mode collapse and
RESET rows of each partition, windowless and after length, time, lengthBatch
and timeBatch windows, at batch 16 and 33; a group table overflowing in one
partition; and a JAX partition state carried in through
`partition_state_from_jax`. The helpers are test_torch_partition_windows_e2e
.py's. Floats match to a relative 2e-4 (bench.py:_rows_match); everything
else exactly.
"""

import logging

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    interned_values,
    load_interned,
    partition_state_from_jax,
    state_to_numpy,
)
from tests.test_torch_partition_windows_e2e import (  # noqa: E402,F401
    HEAD,
    PART,
    _app,
    _events,
    _managers,
    _run,
    check_app,
    small_windows,
)

# name -> (body, playback)
APPS = {
    "group_by": ("@info(name='q') from S[price > 10] select symbol, volume, sum(price) as s, "
                 "count() as n, maxForever(price) as mf group by volume having n > 1 "
                 "insert into Out;", False),
    "group_by_time_batch": (
        "@info(name='q') from S#window.timeBatch(1 sec) select symbol, volume, "
        "avg(price) as ap, sum(volume) as t, count() as n, stdDev(price) as sd, "
        "distinctCount(ets) as dc, min(price) as lo, max(price) as hi, minForever(price) as mf, "
        "maxForever(price) as xf group by volume insert all events into Out;", True),
    "group_by_length_batch": (
        "@info(name='q') from S#window.lengthBatch(4) select symbol, volume, sum(price) as s, "
        "count() as n group by volume having s > 20 insert into Out;", False),
    "group_by_time": ("@info(name='q') from S#window.time(1 sec) select symbol, volume, "
                      "sum(price) as s, max(price) as hi group by volume "
                      "insert all events into Out;", True),
    "every_aggregator_batch": (
        "@info(name='q') from S#window.lengthBatch(4) select symbol, sum(volume) as s, "
        "count() as n, avg(price) as ap, stdDev(price) as sd, min(volume) as lo, "
        "max(price) as hi, minForever(price) as mf, maxForever(volume) as xf, "
        "distinctCount(volume) as dc insert all events into Out;", False),
}


@pytest.mark.parametrize("batch", [16, 33])
@pytest.mark.parametrize("name", sorted(APPS))
def test_app_matches_jax(name, batch):
    check_app(APPS, name, batch)


def test_group_table_overflows_in_one_partition(caplog):
    """@app:groupCapacity(size='3') and six volumes in each partition: the
    groups past the third lose their carry in their own partition only,
    as in JAX; the port logs the overflow once."""
    ql = ("@app:groupCapacity(size='3')\n" + _app(APPS, "group_by_length_batch", 16)).replace(
        "having s > 20 ", "")
    rows, ts = _events(96, 4, seed=3, volumes=6)
    jax_rows = _run(siddhi_tpu.SiddhiManager(), ql, rows, ts, 40)
    with caplog.at_level(logging.ERROR):
        port_rows = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), ql, rows, ts, 40)
    assert len(jax_rows["Out"]) > 10 and bench._rows_match(port_rows, jax_rows)
    msgs = [r.message for r in caplog.records if r.name.startswith("siddhi_tpu_torch")
            and "group-by slot table overflowed" in r.message]
    assert len(msgs) == 1


def test_jax_partition_state_carried_in():
    """Four calls through JAX, its key table and [P]-tiled query states (a
    grouped externalTimeBatch into an #inner externalTime window; the
    interned strings too) into the port, then four more calls through both:
    equal rows, and equal window and group states after."""
    body = ("@info(name='a') from S#window.externalTimeBatch(ets, 500) select symbol, volume, "
            "ets, sum(price) as s, count() as n group by volume insert into #A; "
            "@info(name='q') from #A#window.externalTime(ets, 800) select symbol, volume, s, "
            "max(s) as hi insert all events into Out;")
    ql = HEAD.format(batch=16, extra="") + PART.format(body=body)
    rows, ts = _events(128, 10, seed=21)
    jmgr, pmgr = _managers()
    jrt = jmgr.create_siddhi_app_runtime(ql)
    prt = pmgr.create_siddhi_app_runtime(ql)
    got = {"jax": [], "port": []}
    jrt.add_callback("Out", lambda evs: got["jax"].extend(tuple(e.data) for e in evs))
    prt.add_callback("Out", lambda evs: got["port"].extend(tuple(e.data) for e in evs))
    jrt.start()
    prt.start()
    jh, ph = jrt.get_input_handler("S"), prt.get_input_handler("S")
    for lo in range(0, 64, 16):
        jh.send_many(rows[lo:lo + 16], timestamps=ts[lo:lo + 16])
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
    for lo in range(64, 128, 16):
        jh.send_many(rows[lo:lo + 16], timestamps=ts[lo:lo + 16])
        ph.send_many(rows[lo:lo + 16], timestamps=ts[lo:lo + 16])
    assert len(got["jax"]) > 10
    assert bench._rows_match(got["port"], got["jax"])
    for q in jpart.queries:
        want = jax.tree_util.tree_map(np.asarray, q.state)
        have = state_to_numpy(prt.queries[q.query_id].state)
        np.testing.assert_equal(have["chain"], want["chain"])
        if "group" in want["sel"]:
            np.testing.assert_equal(have["sel"]["group"], want["sel"]["group"])
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
