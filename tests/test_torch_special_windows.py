"""The sort, frequent, lossyFrequent and cron window steps (the plain K25-K28)
against the JAX package's `SortWindow.apply`, `FrequentWindow.apply`,
`LossyFrequentWindow.apply` and `CronWindow.apply` (jitted), on the CPU,
with inputs made from a seed with numpy: every output lane over the whole
capacity (padding included), every state lane, and the overflow flag, bit
for bit, over carried batches with holes, EXPIRED and TIMER rows. The feeds
hold the traps of these scans: NaN, -0.0 and integer-null sort keys, `desc`
on integer and bool keys, ties, the arrival evicted, a full frequent table
evicting every key at once and dropping new keys, a lossy prune that evicts
the arrival, a cron TIMER row first in the batch, after CURRENT rows and on
an empty bucket, and buckets past their slots. Each stage's `view()` is held
against JAX's too.
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
from siddhi_tpu.core import windows_special as jax_special  # noqa: E402
from siddhi_tpu_torch.core import windows_special as port_special  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.flow import Flow  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402

ATTRS = [("symbol", "STRING"), ("price", "FLOAT"), ("volume", "LONG"), ("qty", "INT"),
         ("hot", "BOOL")]
T0 = 1_700_000_000_000
INT_NULL = np.iinfo(np.int32).min
LONG_NULL = np.iinfo(np.int64).min
PRICES = np.array([np.nan, -0.0, 0.0, 1.5, 2.5, 2.5, 7.0, -3.0], dtype=np.float32)
VOLUMES = np.array([LONG_NULL, -5, 0, 3, 3, 9, np.iinfo(np.int64).max], dtype=np.int64)
QTYS = np.array([INT_NULL, -1, 0, 2, 2, 4, np.iinfo(np.int32).max], dtype=np.int32)

KIND_CURRENT, KIND_EXPIRED, KIND_TIMER = 0, 1, 2


def _bits(a: np.ndarray) -> np.ndarray:
    """Floats by their bits (NaN payloads and -0.0 count), else the array."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tree_equal(got, want, where: str):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}")
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=where)


def _feed(rng, b, t_next, timer_share, n_symbols, first_nan=False):
    """One batch as numpy lanes: rising ts, holes in valid, EXPIRED rows (which
    these windows ignore) and TIMER rows (null payload)."""
    ts = t_next + np.cumsum(rng.integers(0, 4, b)).astype(np.int64)
    u = rng.random(b)
    kind = np.where(u < timer_share, KIND_TIMER,
                    np.where(u < timer_share + 0.05, KIND_EXPIRED, KIND_CURRENT)).astype(np.int8)
    valid = rng.random(b) > 0.1
    cols = {
        "symbol": rng.integers(1, n_symbols + 1, b).astype(np.int32),
        "price": PRICES[rng.integers(0, len(PRICES), b)],
        "volume": VOLUMES[rng.integers(0, len(VOLUMES), b)],
        "qty": QTYS[rng.integers(0, len(QTYS), b)],
        "hot": rng.random(b) < 0.5,
    }
    if first_nan:
        cols["price"][0], kind[0], valid[0] = np.nan, KIND_CURRENT, True
    timer = kind == KIND_TIMER
    for n, c in cols.items():
        c[timer] = {"symbol": 0, "price": np.nan, "volume": LONG_NULL, "qty": INT_NULL,
                    "hot": False}[n]
    return ts, kind, valid, cols


def _schemas():
    return (JaxSchema("S", [(n, JaxAttrType[t]) for n, t in ATTRS]),
            StreamSchema("S", [(n, AttrType[t]) for n, t in ATTRS]))


def _run(make_jax, make_port, b, batches, seed, timer_share=0.0, n_symbols=6,
         first_nan=False, start=None):
    """Run both stages over the same batches, each carrying its own state
    (from `start(numpy init state)` when given), and hold every step's
    output, flag and state equal."""
    jschema, pschema = _schemas()
    jwin, pwin = make_jax(jschema), make_port(pschema)
    jstate, pstate = jwin.init_state(), pwin.init_state()
    if start is not None:
        tree = start(state_to_numpy(pstate))
        jstate = jax.tree_util.tree_map(jnp.asarray, tree)
        pstate = state_from_numpy(tree, "cpu")
    step = jax.jit(lambda st, bat, now: (lambda r: (r[0], r[1].batch, r[1].aux))(
        jwin.apply(st, JaxFlow(batch=bat, ref="S", now=now))))
    rng = np.random.default_rng(seed)
    t_next = T0
    seen = {"rows": 0, "expired": 0, "overflow": 0}
    for i in range(batches):
        ts, kind, valid, cols = _feed(rng, b, t_next, timer_share, n_symbols,
                                      first_nan=first_nan and i == 0)
        t_next = int(ts[-1]) + 1
        now = t_next + 5
        jb = JaxBatch(ts=jnp.asarray(ts), kind=jnp.asarray(kind), valid=jnp.asarray(valid),
                      cols={n: jnp.asarray(c) for n, c in cols.items()})
        pb = EventBatch(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                        valid=torch.from_numpy(valid),
                        cols={n: torch.from_numpy(c.copy()) for n, c in cols.items()})
        jstate, jout, jaux = step(jstate, jb, jnp.asarray(now, jnp.int64))
        pstate, pflow = pwin.apply(pstate, Flow(batch=pb, ref="S",
                                                now=torch.tensor(now, dtype=torch.int64)))
        pout = pflow.batch
        where = f"batch {i}"
        for lane in ("ts", "kind", "valid"):
            _assert_tree_equal(getattr(pout, lane).numpy(), getattr(jout, lane), f"{where} {lane}")
        _assert_tree_equal(state_to_numpy(pout.cols), jax.tree_util.tree_map(np.asarray, jout.cols),
                           f"{where} cols")
        assert bool(pflow.aux["window_overflow"]) == bool(jaux["window_overflow"]), where
        _assert_tree_equal(state_to_numpy(pstate), jax.tree_util.tree_map(np.asarray, jstate),
                           f"{where} state")
        jvalid = np.asarray(jout.valid)
        seen["rows"] += int(jvalid.sum())
        seen["expired"] += int((jvalid & (np.asarray(jout.kind) == KIND_EXPIRED)).sum())
        seen["overflow"] += int(bool(jaux["window_overflow"]))
    jview = jax.tree_util.tree_map(np.asarray, jwin.view(jstate))
    pview = state_to_numpy(pwin.view(pstate))
    _assert_tree_equal(pview[0], jview[0], "view cols")
    _assert_tree_equal(pview[1], jview[1], "view ts")
    _assert_tree_equal(pview[2], jview[2], "view mask")
    return seen


def _batches(b):
    return 12 if b == 1 else 4


SORT_KEYS = {
    "price": [("price", False)],
    "price_desc": [("price", True)],
    "volume_desc_qty": [("volume", True), ("qty", False)],
    "qty_desc": [("qty", True)],
    "hot_desc_price": [("hot", True), ("price", False)],
}
SORT_CASES = [("price", 4, 33), ("price", 16, 513), ("price_desc", 4, 1), ("price_desc", 16, 33),
              ("volume_desc_qty", 4, 513), ("volume_desc_qty", 16, 33), ("qty_desc", 4, 33),
              ("hot_desc_price", 16, 513), ("hot_desc_price", 4, 1)]


@pytest.mark.parametrize("keys,n,b", SORT_CASES)
def test_sort_window_step(keys, n, b):
    ks = SORT_KEYS[keys]
    seen = _run(lambda s: jax_special.SortWindow(s, "S", n, ks),
                   lambda s: port_special.SortWindow(s, "S", n, ks, "cpu"),
                   b, _batches(b), seed=n * 1000 + b, timer_share=0.05,
                   first_nan=keys == "price")
    assert seen["expired"] > 0


def test_sort_nan_in_slot_zero_is_never_evicted():
    """A NaN key in slot 0 is never the victim (the fold's `a > NaN` and
    `a == NaN` are false), and a later NaN never wins; the same rows as JAX."""
    _run(lambda s: jax_special.SortWindow(s, "S", 4, [("price", False)]),
         lambda s: port_special.SortWindow(s, "S", 4, [("price", False)], "cpu"),
         33, 4, seed=5, first_nan=True)


FREQUENT_CASES = [(["symbol"], 4, 33), (["symbol"], 16, 513), ([], 4, 33), (["price"], 4, 1),
                  (["price"], 16, 33), (["symbol", "hot"], 4, 513)]


@pytest.mark.parametrize("keys,n,b", FREQUENT_CASES)
def test_frequent_window_step(keys, n, b):
    _run(lambda s: jax_special.FrequentWindow(s, "S", n, keys),
         lambda s: port_special.FrequentWindow(s, "S", n, keys, "cpu"),
         b, _batches(b), seed=7 * n + b, timer_share=0.05, n_symbols=8)


LOSSY_CASES = [(0.3, 0.1, ["symbol"], 33), (0.3, 0.1, ["symbol"], 513), (0.05, 0.01, [], 513),
               (0.5, 0.25, ["price"], 1), (0.5, 0.25, ["price"], 33), (0.2, 0.05, [], 33)]


@pytest.mark.parametrize("s,e,keys,b", LOSSY_CASES)
def test_lossy_frequent_window_step(s, e, keys, b):
    _run(lambda sch: jax_special.LossyFrequentWindow(sch, "S", s, e, keys),
         lambda sch: port_special.LossyFrequentWindow(sch, "S", s, e, keys, "cpu"),
         b, _batches(b), seed=int(s * 100) + b, timer_share=0.05, n_symbols=12)


@pytest.mark.parametrize("w,b", [(4, 1), (4, 33), (16, 33), (16, 513), (4, 513)])
def test_cron_window_step(w, b):
    """TIMER rows at ~1 in 8 rows: first in a batch, after CURRENT rows, on an
    empty bucket, and buckets past the w slots between fires."""
    share = 0.3 if b == 1 else 0.12 if w == 16 else 0.02
    _run(lambda s: jax_special.CronWindow(s, "S", "*/1 * * * * ?", capacity=w),
         lambda s: port_special.CronWindow(s, "S", "*/1 * * * * ?", "cpu", capacity=w),
         b, _batches(b), seed=w + b, timer_share=share)


def test_lossy_full_table_and_buffer_overflow():
    """A lossy table full of distinct keys (support 0.26, error 0.25: width
    4, 64 slots) one row before a bucket boundary: the first arrival finds
    no slot (the key-table flag), the prune then evicts all 64, and the
    arrivals that follow pass and are pruned again, past the B + c buffer."""

    def full(st):
        st["occ"][:] = True
        st["key"][:] = np.arange(10**6, 10**6 + 64)
        st["cnt"][:] = 1
        st["total"] = np.asarray(3, np.int64)
        return st

    seen = _run(lambda sch: jax_special.LossyFrequentWindow(sch, "S", 0.26, 0.25, []),
                lambda sch: port_special.LossyFrequentWindow(sch, "S", 0.26, 0.25, [], "cpu"),
                33, 2, seed=3, start=full)
    assert seen["overflow"] >= 1 and seen["expired"] >= 64
