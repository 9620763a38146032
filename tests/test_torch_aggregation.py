"""The incremental aggregation's step (the plain K44 with the stock lanes
around it) and find merge (the plain K45 with the recompose) against the
JAX package's `AggregationRuntime` (jitted `_step_full`, `_find_impl`), on
the CPU, with inputs made from a seed with numpy, three batches carried:
every lane of the stores and spills, the spill counts, the overflow flag,
next_timer and every lane of each duration table after each batch, then
each `per`'s find (closed rows and the merged in-flight store) — ints
exact, floats bit for bit (NaN payloads and -0.0 count; the adds run one
row at a time in the scan's order in both).

The feeds hold this step's traps: a month end, Feb 29 and a year end,
timestamps before 1970, TIMER rows (an event-time aggregation's bucket
ends), a filter, int, long and float arguments with NaN prices, a
composite string + float group key with -0.0 and 0.0, a group table of 4
overflowing, batches of 1, 33 and 513 rows, and batches spanning more
than four finest buckets (a fifth close rolls up but is not spilled, and
sets the flag).
"""

import calendar
import datetime as dt

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch  # noqa: E402
from siddhi_tpu_torch.interop import aggregation_state_from_jax, state_to_numpy  # noqa: E402
from siddhi_tpu_torch.ops.aggregation import align_bucket  # noqa: E402
from siddhi_tpu_torch.query_api.definition import Duration  # noqa: E402

STREAM = "define stream S (symbol string, price float, volume long, qty int, ts long);\n"
APPS = {
    # every base kind and argument type, a filter, sec ... year
    "full": STREAM + (
        "define aggregation A from S[volume > 100] select symbol, avg(price) as ap, "
        "sum(volume) as sv, sum(qty) as sq, sum(price) as sp, count() as n, min(price) as lo, "
        "max(price) as hi, min(qty) as lq, max(volume) as hv, price as lp group by symbol "
        "aggregate by ts every sec ... year;"),
    # a composite string + float key, sec and min
    "composite": STREAM + (
        "define aggregation A from S select symbol, price, sum(volume) as sv, count() as n, "
        "min(price) as lo, max(price) as hi group by symbol, price aggregate by ts "
        "every sec, min;"),
    # the events' own timestamps: the finest bucket's end is a TIMER step
    "event_time": STREAM + (
        "define aggregation A from S select symbol, sum(volume) as sv, max(qty) as hq, "
        "avg(price) as ap group by symbol aggregate every sec ... hour;"),
}
PRICES = np.array([np.nan, -0.0, 0.0, 1.5, 2.5, 7.25, 99.0], np.float32)


def _ms(*args) -> int:
    return calendar.timegm(dt.datetime(*args).timetuple()) * 1000


def _runtimes(app: str, g: int):
    ql = f"@app:aggGroupCapacity(size='{g}')\n" + APPS[app]
    jrt = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql)
    prt = siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)
    return jrt.aggregations["A"], prt.aggregations["A"]


def _batch(rng, b: int, t0: int, step: int, symbols: int, prices=None, timers=0.0):
    """Rows at t0 + running sums of random steps (the ts lane and the
    events' own ts alike); some rows TIMER, the last few invalid."""
    ts = t0 + np.cumsum(rng.integers(0, step + 1, b)).astype(np.int64)
    kind = np.where(rng.random(b) < timers, 2, 0).astype(np.int8)
    valid = np.ones(b, bool)
    if b > 4:
        valid[-2:] = False
    price = (rng.uniform(0, 100, b).astype(np.float32) if prices is None
             else prices[rng.integers(0, len(prices), b)])
    cols = {"symbol": rng.integers(1, symbols + 1, b).astype(np.int32), "price": price,
            "volume": rng.integers(0, 1000, b).astype(np.int64),
            "qty": rng.integers(-50, 50, b).astype(np.int32), "ts": ts}
    jb = JaxBatch(ts=jnp.asarray(ts), kind=jnp.asarray(kind), valid=jnp.asarray(valid),
                  cols={n: jnp.asarray(c) for n, c in cols.items()})
    pb = EventBatch(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                    valid=torch.from_numpy(valid),
                    cols={n: torch.from_numpy(c.copy()) for n, c in cols.items()})
    return jb, pb, int(ts[-1])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tree(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree(got[k], want[k], f"{where}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=where)


def _jax_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_state(jar, par, where):
    want = state_to_numpy(aggregation_state_from_jax(_jax_np(jar.state), "cpu"))
    _assert_tree(state_to_numpy(par.state), want, where)
    for dur, jt in jar.tables.items():
        _assert_tree(state_to_numpy(par.tables[Duration[dur.name]].state), _jax_np(jt.state),
                     f"{where} table {dur.name}")


def _run(app, g, feeds):
    """Each batch through both runtimes' receive (the step, then the
    spilled rows into the duration tables): every lane after each; then
    each per's find."""
    jar, par = _runtimes(app, g)
    flags = []
    for i, (jb, pb, now) in enumerate(feeds):
        jaux = jar.receive(jb, now)
        paux = par.receive(pb, now)
        _check_state(jar, par, f"{app} G={g} batch {i}")
        flags.append(bool(jaux["agg_overflow"]))
        assert bool(paux["agg_overflow"]) == flags[-1]
        assert ("next_timer" in paux) == ("next_timer" in jaux)
        if "next_timer" in jaux:
            assert int(paux["next_timer"]) == int(jaux["next_timer"])
    for per in jar.durations:
        want = jax.jit(lambda st, ts, _p=per: jar._find_impl(_p, st, ts, 0))(
            jar.state, jar.tables[per].state)
        got = par.find(Duration[per.name], None)
        _assert_tree({"ts": got.ts.numpy(), "valid": got.valid.numpy(),
                      "cols": {n: c.numpy() for n, c in got.cols.items()}},
                     _jax_np({"ts": want.ts, "valid": want.valid, "cols": want.cols}),
                     f"{app} G={g} find per {per.name}")
    return jar, flags


@pytest.mark.parametrize("b,g,starts,step", [
    # a leap day, the month end after it and a year end; each batch spans
    # tens of seconds: more than four closes of the finest duration
    (513, 64, [_ms(2024, 2, 28, 23, 59, 40), _ms(2024, 2, 29, 23, 59, 40),
               _ms(2024, 12, 31, 23, 59, 40)], 150),
    # four group slots for eight symbols: the stores overflow
    (33, 4, [_ms(2023, 12, 31, 23, 59, 59), _ms(2024, 1, 31, 23, 59, 59),
             _ms(2024, 3, 31, 23, 59, 59)], 60),
    # one row a batch across 1970's start (negative buckets)
    (1, 64, [_ms(1969, 12, 31, 23, 59, 59), _ms(1970, 1, 1, 0, 0, 0),
             _ms(1970, 1, 1, 0, 1, 0)], 400),
])
def test_full_chain_matches_jax(b, g, starts, step):
    rng = np.random.default_rng(b * 7 + g)
    feeds = [_batch(rng, b, t0, step, 8, timers=0.05) for t0 in starts]
    jar, flags = _run("full", g, feeds)
    if b == 513:
        assert int(jar.state["spill_n"][0]) > 4 and flags[-1]  # a fifth close a batch
    if g == 4:
        assert any(flags)  # a fifth symbol finds no slot


@pytest.mark.parametrize("b", [33, 513])
def test_composite_key_with_nan_and_signed_zero(b):
    rng = np.random.default_rng(b)
    feeds = [_batch(rng, b, _ms(2024, 6, 1, 0, 0, 57) + i * 90_000, 8, 3, prices=PRICES,
                    timers=0.1) for i in range(3)]
    _run("composite", 64, feeds)


def test_event_time_timer_rows():
    """No `aggregate by`: TIMER rows step the chain at the events' clock,
    and each step's next_timer is the finest bucket's end."""
    rng = np.random.default_rng(3)
    feeds = [_batch(rng, 33, _ms(2024, 2, 29, 23, 59, 58) + i * 1_500, 70, 5, timers=0.2)
             for i in range(3)]
    _run("event_time", 64, feeds)


@pytest.mark.parametrize("dur", list(Duration))
def test_align_bucket_matches_jax(dur):
    """The civil calendar over ten thousand instants from 1600 to 2400,
    month and leap-year edges among them, against the JAX package's."""
    from siddhi_tpu.core.aggregation import align_bucket as jax_align
    from siddhi_tpu.query_api.definition import Duration as JaxDuration

    rng = np.random.default_rng(11)
    ts = rng.integers(_ms(1600, 1, 1), _ms(2400, 1, 1), 10_000).astype(np.int64)
    edges = np.array([_ms(2024, 2, 29), _ms(2024, 3, 1) - 1, _ms(2000, 2, 29), _ms(1900, 3, 1),
                      _ms(1969, 12, 31, 23, 59, 59), 0, -1, _ms(2100, 12, 31, 23, 59, 59)])
    ts = np.concatenate([ts, edges])
    want = np.asarray(jax_align(jnp.asarray(ts), JaxDuration[dur.name]))
    got = align_bucket(torch.from_numpy(ts), dur.value).numpy()
    np.testing.assert_array_equal(got, want)
