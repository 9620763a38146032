"""A partitioned batch window's running sums, through both packages on the
CPU. The JAX package runs the flat `running_sum` of `siddhi_tpu/ops/
prefix.py` (csum - csum[last RESET], plus the carry before the first RESET)
vmapped over the partitions, so within one batch a NaN, an inf or a large
earlier bucket of a partition leaks into that partition's later buckets.
The port copies it (`core/aggregators.py` `_leaky_sum`, K8 keyed by
partition; ROADMAP section 3, the faults of the reference it copies).

- The plain route (`partition_era_ctx` then `_leaky_sum`) against JAX
  `running_sum` vmapped over P lanes with the partition masks, with two or
  more buckets of one partition closing in one batch, for float32 sums with
  NaN, +inf and 1e8 and int64 counts; the carries too.
- Apps through `siddhi_tpu.SiddhiManager()` and
  `siddhi_tpu_torch.SiddhiManager(device="cpu")` at batch 16 and 33 under
  playback, one `send_many` a call: sum, count, avg, stdDev, `having` and
  `insert all events` after lengthBatch, and after timeBatch and
  externalTimeBatch; rows equal in order, NaN equal to NaN, floats within
  a relative 2e-4 (floor 1.0, as bench.py:_rows_match, which reads NaN as
  unequal to NaN).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.ops import prefix as jprefix  # noqa: E402
from siddhi_tpu_torch.core.aggregators import _leaky_sum  # noqa: E402
from siddhi_tpu_torch.core.groupby import partition_ctx, partition_era_ctx, slot_first  # noqa: E402

RTOL = 2e-4


@jax.jit
def _jax_vmapped(masks, resets, contrib, carry):
    return jax.vmap(lambda m, r, c: jprefix.running_sum(jnp.where(m, contrib, 0), r, c))(
        masks, resets, carry)


@pytest.mark.parametrize("p,b", [(1, 16), (3, 33), (8, 257)])
@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_plain_route_matches_vmapped_running_sum(p, b, dtype):
    """`_leaky_sum` over a partition context with RESET eras against JAX's
    running_sum vmapped over [P] lanes: every member row's value and every
    carry; each partition closes two or more buckets in the batch."""
    rng = np.random.default_rng(p * 7 + b + len(dtype))
    slot = rng.integers(0, p + 1, b).astype(np.int32)  # slot p: no partition
    reset = rng.random(b) < 0.2
    for q in range(p):  # at least two RESET rows a partition
        rows = np.flatnonzero(slot == q)
        if len(rows) >= 3:
            reset[rows[[0, len(rows) // 2]]] = True
    member = slot < p
    if dtype == "float32":
        # sums exact in any order (the JAX package's cumsum on the CPU is an
        # associative scan, the port's a running one): halves, NaN and
        # infinities in the rows, 1e8 in the carries
        vals = rng.choice(np.array([1.0, 2.0, 3.5, -1.0, 0.5, np.nan, np.inf, -np.inf],
                                   np.float32), b, p=[.3, .2, .2, .1, .1, .04, .03, .03])
        carry = rng.choice(np.array([0.0, 1.0, 1e8, np.nan], np.float32), p)
    else:
        vals = rng.integers(-1, 2, b).astype(np.int64)
        carry = rng.integers(0, 5, p).astype(np.int64)
    contrib = np.where(member & ~reset, vals, 0).astype(vals.dtype)
    masks = jnp.asarray(member)[None, :] & (jnp.asarray(slot)[None, :] == jnp.arange(p)[:, None])
    resets = masks & jnp.asarray(reset)[None, :]
    want_run, want_carry = _jax_vmapped(masks, resets, jnp.asarray(contrib), jnp.asarray(carry))
    ts = torch.from_numpy(slot)
    ctx = partition_era_ctx(partition_ctx(ts, slot_first(ts, p), p, torch.zeros((), dtype=bool)),
                            torch.from_numpy(reset & member))
    run, new_carry = _leaky_sum(torch.from_numpy(carry.copy()), torch.from_numpy(contrib), ctx)
    cols = np.arange(b)
    got, want = run.numpy()[member], np.asarray(want_run)[slot[member], cols[member]]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL, equal_nan=True)
        np.testing.assert_allclose(new_carry.numpy(), np.asarray(want_carry), rtol=RTOL,
                                   atol=RTOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(new_carry.numpy(), np.asarray(want_carry))


HEAD = ("@app:playback @app:batch(size='{batch}') @app:partitionCapacity(size='8')\n"
        "define stream S (sym string, p float, v int, ets long);\n")
PART = "partition with (sym of S) begin\n{body}\nend;"
APPS = {
    "length_sum_count": "from S#window.lengthBatch(2) select sym, sum(p) as s, count() as n "
                        "insert into Out;",
    "length_avg_std": "from S#window.lengthBatch(3) select sym, avg(p) as a, stdDev(p) as sd, "
                      "sum(v) as t insert into Out;",
    "length_having": "from S#window.lengthBatch(2) select sym, sum(p) as s having s > 2.5 "
                     "insert into Out;",
    "length_all_events": "from S#window.lengthBatch(2) select sym, sum(p) as s, count() as n "
                         "insert all events into Out;",
    "time_batch": "from S#window.timeBatch(20 milliseconds) select sym, sum(p) as s, "
                  "avg(p) as a, count() as n insert into Out;",
    "external_time_batch": "from S#window.externalTimeBatch(ets, 20 milliseconds) select sym, "
                           "sum(p) as s, stdDev(p) as sd, count() as n insert all events into Out;",
}
PRICES = {
    "nan": [float("nan"), 1.0, 2.0, 3.0],
    "inf": [float("inf"), 1.0, 2.0, 3.0],
    "large": [1e8, 1.0, 2.0, 1.0],
}
# 1e8 beside small prices rounds by the order of the additions: the port
# adds in row order (ops/prefix.py running_sum_ref), the JAX package's cumsum
# on the CPU is an associative scan. With only current events both orders
# round alike; with the expired events of `insert all events` they do not,
# so those apps are compared on NaN and inf.
CASES = [(label, prices) for label in APPS for prices in PRICES
         if prices != "large" or "all events" not in APPS[label]]


def _rows(prices: list, n: int, symbols: int, seed: int):
    """n rows 1 ms apart over `symbols` symbols; each symbol's prices cycle
    through `prices` so every partition's first bucket holds the trap."""
    rng = np.random.default_rng(seed)
    out, seen = [], {}
    for i in range(n):
        s = f"S{int(rng.integers(0, symbols))}"
        k = seen.get(s, 0)
        seen[s] = k + 1
        out.append((s, float(prices[k % len(prices)]), int(rng.integers(1, 5)), 100 + 3 * i))
    return out


def _run(mgr, app: str, rows: list, chunk: int):
    rt = mgr.create_siddhi_app_runtime(app)
    out = []
    rt.add_callback("Out", lambda evs: out.extend(tuple(e.data) for e in evs))
    rt.start()
    h = rt.get_input_handler("S")
    for lo in range(0, len(rows), chunk):
        part = rows[lo:lo + chunk]
        h.send_many(part, [r[3] for r in part])
    rt.shutdown()
    return out


def _same(a, b) -> bool:
    """Rows equal in order: NaN equals NaN, floats within RTOL (floor 1.0)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None:
                    if x is not y:
                        return False
                elif math.isnan(x) or math.isnan(y):
                    if not (math.isnan(x) and math.isnan(y)):
                        return False
                elif math.isinf(x) or math.isinf(y):
                    if x != y:
                        return False
                elif abs(x - y) > RTOL * max(1.0, abs(x), abs(y)):
                    return False
            elif x != y:
                return False
    return True


@pytest.mark.parametrize("batch", [16, 33])
@pytest.mark.parametrize("label,prices", CASES)
def test_app_matches_jax(label, prices, batch):
    app = HEAD.format(batch=batch) + PART.format(body=APPS[label])
    rows = _rows(PRICES[prices], 40, 3, batch)
    want = _run(siddhi_tpu.SiddhiManager(), app, rows, 40)
    got = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), app, rows, 40)
    assert want, "the app delivers rows"
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("prices,want", [
    ([float("nan"), 1.0, 2.0, 3.0], [("A", None, 2), ("A", None, 2)]),
    ([1e8, 1.0, 2.0, 1.0], [("A", 1e8, 2), ("A", 0.0, 2)]),
])
def test_leak_gives_the_reference_rows(prices, want):
    """One send_many of four rows of symbol A; the second
    bucket's sum carries the first's NaN, or loses its small values to
    1e8's rounding, as in JAX."""
    app = (HEAD.format(batch=16) + PART.format(body=APPS["length_sum_count"]))
    rows = [("A", p, 1, t + 1) for t, p in enumerate(prices)]
    assert _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), app, rows, 4) == want
