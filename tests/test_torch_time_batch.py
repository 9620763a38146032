"""The time-driven batch windows' step (timeBatch / externalTimeBatch) against
the JAX package's `BatchWindow.apply` time branch, on the CPU, with inputs
made from a seed with numpy: every valid output lane, the padding, the new
buffers, the bucket start, the idle deadline, next_timer and the expanded
membership, all exact, over carried batches with holes, TIMER rows, empty
bucket gaps, buckets past the w slots, a start time and an idle timeout that
is stale or elapsed, at rank 0 and after a CURRENT row.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.event import StreamSchema as JaxSchema  # noqa: E402
from siddhi_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.core.windows import BatchWindow as JaxBatchWindow  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.core.windows import (  # noqa: E402
    NO_TIMER,
    BatchWindow,
    time_batch_rows,
    time_batch_step,
)
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402

ATTRS = [("symbol", "STRING"), ("price", "FLOAT"), ("ets", "LONG"), ("hot", "BOOL")]
T0 = 1_700_000_000_000
LONG_NULL = np.iinfo(np.int64).min

# mode -> (time attribute, start time, timeout, the JAX window's use_scheduler)
MODES = {
    "timebatch": (None, None, None, True),
    "timebatch_start": (None, T0 + 3, None, True),
    "ext": ("ets", None, None, False),
    "ext_start": ("ets", T0 - 17, None, False),
    "ext_timeout": ("ets", None, 40, False),
}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _feed(rng, b, t_next, duration, timer_share):
    """One batch: times rising 0-3 ms a row with a jump of several durations
    now and then (empty buckets), holes in `valid`, and, for a window that
    takes timers, TIMER rows (null payload, the clock's time in ts)."""
    step = rng.integers(0, 4, b)
    step[rng.random(b) < 0.01] = duration * 3 + 1
    ts = t_next + np.cumsum(step).astype(np.int64)
    kind = np.where(rng.random(b) < timer_share, 2, 0).astype(np.int8)
    if timer_share and rng.random() < 0.5:
        kind[0] = 2  # a TIMER before any CURRENT row (rank 0)
    cols = {
        "symbol": rng.integers(1, 6, b).astype(np.int32),
        "price": rng.uniform(0, 100, b).astype(np.float32),
        "ets": ts.copy(),
        "hot": rng.random(b) < 0.5,
    }
    timer = kind == 2
    cols["symbol"][timer] = 0
    cols["price"][timer] = np.nan
    cols["ets"][timer] = LONG_NULL
    cols["hot"][timer] = False
    return {"ts": ts, "kind": kind, "valid": rng.random(b) < 0.85, "cols": cols}


def _run(b, w, mode, emit_expired, steps, seed, duration=10):
    time_attr, start, timeout, sched = MODES[mode]
    rng = np.random.default_rng(seed)
    jschema = JaxSchema("S", [(a, JaxAttrType[t]) for a, t in ATTRS])
    jwin = JaxBatchWindow(jschema, "S", capacity=w, duration_ms=duration, time_attr=time_attr,
                          use_scheduler=sched, start_time=start, timeout_ms=timeout)
    jwin.emit_expired = emit_expired
    jstate = jwin.init_state()

    @jax.jit
    def jax_step(st, jb, now):
        st, flow = jwin.apply(st, JaxFlow(batch=jb, ref="S", now=now))
        return st, flow.batch, flow.member, flow.aux.get("next_timer")

    schema = StreamSchema("S", [(a, AttrType[t]) for a, t in ATTRS])
    win = BatchWindow(schema, "S", None, "cpu", capacity=w, duration_ms=duration,
                      time_attr=time_attr, start_time=start, timeout_ms=timeout)
    assert win.needs_scheduler == jwin.needs_scheduler
    state = win.init_state()
    np.testing.assert_equal(state_to_numpy(state), _np_tree(jstate))
    t_next, now, flushes = T0, T0, 0
    for _ in range(steps):
        f = _feed(rng, b, t_next, duration, timer_share=0.05 if sched or timeout else 0.0)
        t_next = int(f["ts"][-1]) + 1
        if timeout is not None:
            # the clock just before or just past the armed deadline
            dl = int(np.asarray(jstate["timeout_deadline"]))
            now = dl + int(rng.choice([-5, 5])) if dl != NO_TIMER else now + 7
        jb = JaxBatch(ts=jnp.asarray(f["ts"]), kind=jnp.asarray(f["kind"]),
                      valid=jnp.asarray(f["valid"]),
                      cols={k: jnp.asarray(v) for k, v in f["cols"].items()})
        jstate, jout, jmember, jnext = jax_step(jstate, jb, jnp.int64(now))
        batch = EventBatch(ts=torch.from_numpy(f["ts"]), kind=torch.from_numpy(f["kind"]),
                           valid=torch.from_numpy(f["valid"]),
                           cols={k: torch.from_numpy(v) for k, v in f["cols"].items()})
        wts = batch.cols[time_attr] if time_attr else batch.ts
        out, birth, death, state, next_timer = time_batch_step(
            state, batch, wts, torch.tensor(now), w, duration, start, timeout, win.timer_mode,
            emit_expired)
        rows = time_batch_rows(b, w, emit_expired)
        v = np.asarray(jout.valid)
        assert out.valid.shape == (rows,) and v.shape == (rows,)
        np.testing.assert_array_equal(out.valid.numpy(), v)
        assert not v[v.sum():].any()  # valid rows first, padding after
        for got, want in [(out.ts, jout.ts), (out.kind, jout.kind)] + [
            (out.cols[a], jout.cols[a]) for a, _ in ATTRS
        ]:
            np.testing.assert_array_equal(got.numpy()[v], np.asarray(want)[v])
            assert not got.numpy()[~v].any()  # padding is zero
        np.testing.assert_equal(state_to_numpy(state), _np_tree(jstate))
        if jnext is not None:
            assert int(next_timer) == int(jnext)
        else:
            assert int(next_timer) == NO_TIMER and not win.needs_scheduler
        if emit_expired:
            p = torch.arange(rows)[:, None]
            member = (birth[None, :] <= p) & (p < death[None, :])
            np.testing.assert_array_equal(member.numpy(), np.asarray(jmember))
        else:
            assert birth is None and jmember is None
        flushes += int((out.kind.numpy()[v] == 3).sum())
    return flushes, int(np.asarray(jstate["cur_n"]))


@pytest.mark.parametrize("b,w,mode,emit_expired", [
    (1, 4, "timebatch", True),
    (33, 4, "timebatch", True),
    (33, 16, "timebatch_start", True),
    (513, 16, "ext", True),
    (513, 4, "ext_start", False),
    (4097, 1024, "timebatch", False),
    (4097, 1024, "ext", True),
    (33, 16, "ext_timeout", True),
    (513, 16, "ext_timeout", False),
    (1, 4, "ext_timeout", True),
])
def test_time_batch_step(b, w, mode, emit_expired):
    """Four carried batches (sixteen of one row): every valid lane, the
    padding, the new buffers and scalars, next_timer and the expanded
    membership equal the JAX step's."""
    steps = 16 if b == 1 else 4
    flushes, _ = _run(b, w, mode, emit_expired, steps, seed=b * 31 + w + len(mode))
    assert flushes >= 1


def test_open_bucket_past_w():
    """A bucket longer than w slots: the rows past them drop from the open
    bucket (dead lanes) while the count runs on, exactly as JAX keeps it."""
    flushes, cur_n = _run(513, 4, "ext", True, 2, seed=5, duration=10_000)
    assert cur_n > 4


def test_state_round_trip():
    """The time branch's state (buffers, bucket_start, timeout_deadline)
    travels between the packages leaf for leaf."""
    jschema = JaxSchema("S", [(a, JaxAttrType[t]) for a, t in ATTRS])
    jwin = JaxBatchWindow(jschema, "S", capacity=16, duration_ms=10, time_attr="ets",
                          timeout_ms=40)
    tree = _np_tree(jwin.init_state())
    tree["bucket_start"] = np.int64(T0)
    tree["timeout_deadline"] = np.int64(T0 + 40)
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    np.testing.assert_equal(back, tree)
