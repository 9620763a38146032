"""Each kernel's plain PyTorch version against its JAX counterpart, on the CPU,
with inputs made from a seed with numpy.

Tolerances: ints, bools and positions match exactly. Float32 running sums
match to a relative 2e-4 (the rule of bench.py:_rows_match), taken relative to
the largest running value so far (floor 1.0): the port and the JAX blocked
scan add in different orders, and each one's rounding error scales with the
magnitude its float32 accumulator has carried, not with the current value
(a running sum that swings back near zero keeps the error of the large sums
before it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.core.aggregators import ExtremeAggregator as JaxExtreme  # noqa: E402
from siddhi_tpu.core.aggregators import FlowInfo as JaxFlowInfo  # noqa: E402
from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.event import StreamSchema as JaxSchema  # noqa: E402
from siddhi_tpu.core.executor import CompiledExpr as JaxExpr  # noqa: E402
from siddhi_tpu.core.executor import Env as JaxEnv  # noqa: E402
from siddhi_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from siddhi_tpu.core.types import AttrType as JaxAttrType  # noqa: E402
from siddhi_tpu.core.windows import SlidingWindow as JaxSlidingWindow  # noqa: E402
from siddhi_tpu.ops.prefix import running_sum as jax_running_sum  # noqa: E402
from siddhi_tpu_torch.core.aggregators import window_extreme  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.core.windows import SlidingWindow, length_window_step  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from siddhi_tpu_torch.ops.prefix import running_sum  # noqa: E402

RTOL = 2e-4


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum.accumulate(np.maximum(np.abs(a), np.abs(b)).reshape(-1))
    return np.all(np.abs(a - b).reshape(-1) <= RTOL * np.maximum(1.0, scale))


# ---------------------------------------------------------------------------
# K2: running_sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 32, 33, 513, 4097])
@pytest.mark.parametrize("dtype", ["float32", "int64"])
@pytest.mark.parametrize("with_resets", [False, True])
def test_running_sum(b, dtype, with_resets):
    rng = np.random.default_rng(1000 + b)
    if dtype == "float32":
        contrib = rng.uniform(-100, 100, b).astype(np.float32)
        base = np.float32(rng.uniform(-50, 50))
    else:
        contrib = rng.integers(-1000, 1000, b).astype(np.int64)
        base = np.int64(rng.integers(-50, 50))
    reset = rng.random(b) < (0.05 if with_resets else 0.0)
    if with_resets and b > 2:
        reset[b // 2] = True
    want_run, want_carry = jax.jit(jax_running_sum)(
        jnp.asarray(contrib), jnp.asarray(reset), jnp.asarray(base)
    )
    run, carry = running_sum(
        torch.from_numpy(contrib), torch.from_numpy(reset), torch.tensor(base)
    )
    assert run.dtype == torch.from_numpy(contrib).dtype and carry.shape == ()
    if dtype == "float32":
        assert _close(run.numpy(), want_run)
        assert carry.item() == run[-1].item()
    else:
        np.testing.assert_array_equal(run.numpy(), np.asarray(want_run))
        assert int(carry) == int(want_carry)


# ---------------------------------------------------------------------------
# K1: the length-window step
# ---------------------------------------------------------------------------

ATTRS = [("symbol", "STRING"), ("price", "FLOAT"), ("volume", "LONG"), ("hot", "BOOL")]


def _feed(rng, b, start_ts):
    """One partial batch: holes in `valid`, a few TIMER rows."""
    valid = rng.random(b) < 0.7
    valid[rng.integers(b // 2, b):] = False  # ragged tail
    kind = np.where(rng.random(b) < 0.1, 2, 0).astype(np.int8)
    return {
        "ts": start_ts + np.arange(b, dtype=np.int64) * 3,
        "kind": kind,
        "valid": valid,
        "cols": {
            "symbol": rng.integers(1, 6, b).astype(np.int32),
            "price": rng.uniform(0, 100, b).astype(np.float32),
            "volume": rng.integers(-(2**40), 2**40, b).astype(np.int64),
            "hot": rng.random(b) < 0.5,
        },
    }


@pytest.mark.parametrize("b", [32, 33])
@pytest.mark.parametrize("w", [1, 5, 50])
def test_length_window_step(w, b):
    rng = np.random.default_rng(10 * w + b)
    jschema = JaxSchema("S", [(n, JaxAttrType[t]) for n, t in ATTRS])
    jwin = JaxSlidingWindow(jschema, "S", capacity=w)
    jstate = jwin.init_state()

    @jax.jit
    def jax_step(st, jb):
        st, flow = jwin.apply(st, JaxFlow(batch=jb, ref="S", now=jnp.int64(0)))
        return st, flow.batch, flow.member

    win = SlidingWindow(StreamSchema("S", [(n, AttrType[t]) for n, t in ATTRS]), "S", w, "cpu")
    state = win.init_state()
    np.testing.assert_equal(state_to_numpy(state), _np_tree(jstate))
    for step in range(4):
        f = _feed(rng, b, 1_700_000_000_000 + 1000 * step)
        jb = JaxBatch(
            ts=jnp.asarray(f["ts"]), kind=jnp.asarray(f["kind"]),
            valid=jnp.asarray(f["valid"]),
            cols={k: jnp.asarray(v) for k, v in f["cols"].items()},
        )
        jstate, jout, jmember = jax_step(jstate, jb)
        batch = EventBatch(
            ts=torch.from_numpy(f["ts"]), kind=torch.from_numpy(f["kind"]),
            valid=torch.from_numpy(f["valid"]),
            cols={k: torch.from_numpy(v) for k, v in f["cols"].items()},
        )
        out, birth, death, state = length_window_step(state, batch, w)
        for got, want in [(out.ts, jout.ts), (out.kind, jout.kind), (out.valid, jout.valid)] + [
            (out.cols[n], jout.cols[n]) for n, _ in ATTRS
        ]:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_equal(state_to_numpy(state), _np_tree(jstate))
        p = torch.arange(2 * b)[:, None]
        member = (birth[None, :] <= p) & (p < death[None, :])
        np.testing.assert_array_equal(member.numpy(), np.asarray(jmember))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_state_round_trip():
    tree = {"chain": {"cols": {"a": np.arange(3, dtype=np.int32)},
                      "seq": np.array([-1, 4, 5], np.int64), "total": np.int64(6)},
            "sel": {"aggs": [{"sum": np.float32(1.5), "count": np.float32(2)},
                             np.int64(7)]}}
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    np.testing.assert_equal(back, tree)
    assert back["chain"]["total"].dtype == np.int64
    assert back["sel"]["aggs"][0]["sum"].dtype == np.float32


# ---------------------------------------------------------------------------
# K3: the windowed extreme
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", ["FLOAT", "INT", "LONG"])
@pytest.mark.parametrize("is_min", [True, False])
def test_window_extreme(t, is_min):
    rng = np.random.default_rng(7 + is_min)
    rows, k = 70, 45
    birth = rng.integers(-1, 50, k).astype(np.int32)
    death = (birth + rng.integers(1, 12, k)).astype(np.int32)
    death[rng.random(k) < 0.2] = -1  # absent elements
    birth[-1], death[-1] = 65, np.iinfo(np.int32).max  # never evicted
    member = (birth[None, :] <= np.arange(rows)[:, None]) & (
        np.arange(rows)[:, None] < death[None, :])
    dtype = {"FLOAT": np.float32, "INT": np.int32, "LONG": np.int64}[t]
    vals = (rng.uniform(-1e3, 1e3, k) if t == "FLOAT" else rng.integers(-1e9, 1e9, k))
    vals = vals.astype(dtype)
    if t == "FLOAT":
        vals[k // 2] = np.nan
    assert (~member.any(axis=1)).any(), "the case must hold an empty window"
    key = ("S", None, "x")
    jagg = JaxExtreme(JaxExpr(JaxAttrType[t], lambda env: env.read(key)), is_min, forever=False)
    info = JaxFlowInfo(
        sign=jnp.zeros(rows, jnp.int8), active=jnp.zeros(rows, bool),
        reset=jnp.zeros(rows, bool), member=jnp.asarray(member),
        member_env=JaxEnv({key: jnp.asarray(vals)}),
    )
    _, want = jagg.apply(jagg.init(), info, JaxEnv({}))
    got = window_extreme(
        torch.from_numpy(vals), torch.from_numpy(birth), torch.from_numpy(death),
        rows, is_min, AttrType[t],
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
