"""The lossyFrequent and cron windows inside a partition: the plain K42
(`partition_lossy_frequent_window_step_ref`) and K43
(`partition_cron_window_step_ref`) against `jax.vmap` over P lanes of the JAX
package's `LossyFrequentWindow.apply` and `CronWindow.apply` on [P]-tiled
states with siddhi_tpu/core/partition.py's masks (`active & slot == p |
TIMER`), then `_flatten` and compaction, on the CPU, with inputs made from a
seed with numpy: P 1/8/33, B 1/33/513, three carried batches with holes,
keys past capacity, EXPIRED rows and TIMER rows anywhere (each reaches every
slot's cron window), NaN/-0.0 keys, a slot's lossy key table full one row
before a bucket end (no slot for the next key, then a prune of every key,
past its buffer), and cron buckets past their slots. Every row, slot and
first row, every state leaf and the flag exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.core.windows_special import CronWindow as JaxCron  # noqa: E402
from siddhi_tpu.core.windows_special import LossyFrequentWindow as JaxLossy  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType  # noqa: E402
from siddhi_tpu_torch.core.windows_special import _key_col  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from siddhi_tpu_torch.ops.partition import (  # noqa: E402
    partition_cron_window_step,
    partition_lossy_frequent_window_step,
)
from tests.test_torch_partition import ATTRS, JSCHEMA, _batch, _jtile, _port_batch  # noqa: E402
from tests.test_torch_partition_join import (  # noqa: E402
    _assert_rows,
    _flat_rows,
    _jax_window_step,
    _np_tree,
)

SHAPES = [(1, 1), (8, 33), (33, 513), (1, 513), (33, 1)]
PORT_ATTRS = [(n, AttrType[t]) for n, t in ATTRS]


def _check(step_port, win, p, b, seed, keyed=None, start=None):
    """Three batches through both; returns the overflow flags and the
    EXPIRED rows seen."""
    rng = np.random.default_rng(seed)
    step = _jax_window_step(win, p)
    jst = _jtile(win.init_state(), p)
    if start is not None:
        jst = start(jax.tree_util.tree_map(lambda x: np.array(x, copy=True), jst))
    pst = state_from_numpy(_np_tree(jst), "cpu")
    seen = {"overflow": 0, "expired": 0, "rows": 0}
    for i in range(3):
        d = _batch(rng, b, p, 1000 * i)
        if keyed is not None:
            keyed(rng, d)
        now = 1000 * i + 7
        jst, jout, jovf = step(jst, jnp.asarray(d["ts"]), jnp.asarray(d["kind"]),
                               jnp.asarray(d["valid"]),
                               {n: jnp.asarray(c) for n, c in d["cols"].items()},
                               jnp.asarray(d["slot"]), jnp.asarray(now, jnp.int64))
        pst, out, out_slot, out_first, ovf = step_port(pst, _port_batch(d),
                                                       torch.from_numpy(d["slot"]),
                                                       torch.tensor(now))
        lanes = {"ts": jout.ts, "kind": jout.kind, **{f"c.{n}": c for n, c in jout.cols.items()}}
        want, wslot, wfirst = _flat_rows(lanes, jout.valid)
        n = wslot.shape[0]
        _assert_rows(want, {"ts": out.ts, "kind": out.kind,
                            **{f"c.{nm}": c for nm, c in out.cols.items()}}, n)
        assert out.valid[:n].all() and not out.valid[n:].any()
        assert np.array_equal(out_slot.numpy()[:n], wslot)
        assert np.array_equal(out_first.numpy()[:n], wfirst)
        assert bool(ovf) == bool(np.asarray(jovf).any())
        np.testing.assert_equal(state_to_numpy(pst), _np_tree(jst))
        seen["overflow"] += bool(ovf)
        seen["expired"] += int((want["kind"] == 1).sum())
        seen["rows"] += n
    return seen


LOSSY = {"symbol": (0.3, 0.1, ["symbol"]), "price": (0.5, 0.25, ["price"]),
         "all": (0.2, 0.05, [])}


def _lossy_step(s, e, ks, p):
    def step(st, bt, sl, now):
        win_c = max(64, int(4.0 / e))
        width = max(1, int(1.0 / e + 0.9999999))
        key = _key_col(bt.cols, PORT_ATTRS, ks).expand(bt.ts.shape).contiguous()
        return partition_lossy_frequent_window_step(st, bt, key, sl, now, win_c, width, s, e, p)

    return step


@pytest.mark.parametrize("keys", sorted(LOSSY))
@pytest.mark.parametrize("p,b", SHAPES)
def test_partition_lossy_frequent_window_step(keys, p, b):
    """Each slot's own total, buckets and prunes; -0.0 and 0.0 distinct
    price keys."""
    s, e, ks = LOSSY[keys]

    def keyed(rng, d):  # few distinct values, so counts climb past the support
        d["cols"]["symbol"] = rng.integers(1, 4, d["ts"].shape[0]).astype(np.int32)

    seen = _check(_lossy_step(s, e, ks, p), JaxLossy(JSCHEMA, "S", s, e, ks), p, b,
                  seed=p * 100 + b + len(keys), keyed=keyed)
    assert seen["rows"] > 0 or b == 1


def test_partition_lossy_full_key_table_overflows():
    """Slot 2's table full of 64 distinct keys one row before a bucket end
    (support 0.26, error 0.25: width 4): its next new key finds no slot
    (the flag), the bucket end prunes all 64, and its later arrivals pass
    and are pruned again, past the B + c buffer; the other slots run as
    usual."""
    p = 4

    def full(st):
        st["occ"][2] = True
        st["key"][2] = np.arange(10**6, 10**6 + 64)
        st["cnt"][2] = 1
        st["total"][2] = 3
        return st

    def hot(rng, d):
        d["slot"][: d["ts"].shape[0] * 3 // 4] = 2
        d["kind"][:] = 0

    seen = _check(_lossy_step(0.26, 0.25, [], p), JaxLossy(JSCHEMA, "S", 0.26, 0.25, []), p, 33,
                  seed=5, keyed=hot, start=full)
    assert seen["overflow"] >= 1 and seen["expired"] >= 64


@pytest.mark.parametrize("w", [4, 16])
@pytest.mark.parametrize("p,b", SHAPES)
def test_partition_cron_window_step(w, p, b):
    """TIMER rows anywhere reach every slot: each non-empty bucket flushes
    (its previous bucket EXPIRED, a RESET, its rows CURRENT); at w = 4 the
    buckets fill past their slots."""
    win = JaxCron(JSCHEMA, "S", "*/1 * * * * ?", capacity=w)
    seen = _check(lambda st, bt, sl, now: partition_cron_window_step(st, bt, sl, now, w, p),
                  win, p, b, seed=p * 10 + b + w)
    if b == 513:
        assert seen["rows"] > 0 and seen["expired"] > 0
