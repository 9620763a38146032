"""Reset-aware running (prefix) reductions over a batch.

The reference updates aggregator state one event at a time, emitting the running
value after each event and zeroing state on RESET events
(reference: query/selector/attribute/aggregator/*.java — add/remove on
CURRENT/EXPIRED, reset on RESET). Batched, the per-event running values become
prefix reductions with reset barriers.

`running_sum` (csrc/running_sum.cu) and `running_extreme`
(csrc/running_extreme.cu) are hand-written CUDA kernels on the card; each
`*_ref` beside them is its plain PyTorch version, which the wrapper takes only
for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.types import float_arith, float_extreme, flush_subnormal, flushed_cumsum

# rows per scan tile of csrc/running_sum.cu and csrc/running_extreme.cu (kTile)
_SCAN_TILE = 32768
_EXTREME_SUFFIX = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64"}


def last_reset_index(reset: torch.Tensor) -> torch.Tensor:
    """For each position i, the largest j <= i with reset[j], else -1. [B] int32."""
    idx = torch.arange(reset.shape[-1], dtype=torch.int32, device=reset.device)
    marked = torch.where(reset, idx, torch.full_like(idx, -1))
    return torch.cummax(marked, 0).values


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b; on float32 as XLA's CPU code adds (core/types.py float_arith)."""
    return float_arith("add", a, b) if a.dtype == torch.float32 else a + b


def running_sum_ref(
    contrib: torch.Tensor, reset: torch.Tensor, base: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `running_sum`:
    run_i = csum_i - csum[last_reset_i] (+ base before the first reset), a
    float32 contribution or partial sum that is subnormal taken as a zero of
    its sign (XLA's CPU code, the JAX package's: core/types.py)."""
    csum = flushed_cumsum(flush_subnormal(contrib))
    lr = last_reset_index(reset)
    zero = torch.zeros((), dtype=csum.dtype, device=csum.device)
    at_lr = torch.where(lr >= 0, csum[lr.clamp(min=0).long()], zero)
    if csum.dtype == torch.float32:
        run = float_arith("sub", csum, at_lr, False, False)
    else:
        run = csum - at_lr
    run = add(run, torch.where(lr < 0, base, zero))
    return run, run[-1]


def running_sum(
    contrib: torch.Tensor, reset: torch.Tensor, base: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Running sum after each event with reset barriers.

    contrib: [B] float32 or int64 signed contributions (0 for invalid rows)
    reset:   [B] bool reset-event marks (a reset row's own contrib is dropped)
    base:    0-d carried sum from prior batches, same dtype
    returns: ([B] running values, 0-d new carry), both on contrib's device
    """
    if contrib.device.type == "cpu":
        return running_sum_ref(contrib, reset, base)
    kernels.require_cuda("running_sum", contrib, reset, base)
    n = contrib.shape[0]
    suffix = {torch.float32: "f32", torch.int64: "i64"}.get(contrib.dtype)
    if (
        suffix is None
        or contrib.dim() != 1
        or n == 0
        or reset.shape != contrib.shape
        or reset.dtype != torch.bool
        or base.shape != ()
        or base.dtype != contrib.dtype
    ):
        raise ValueError(
            "running_sum takes [n] float32/int64 contrib, [n] bool reset and a "
            f"0-d base of the same dtype; got {contrib.dtype}{list(contrib.shape)}, "
            f"{reset.dtype}{list(reset.shape)}, {base.dtype}{list(base.shape)}"
        )
    tiles = -(-n // _SCAN_TILE)
    run = torch.empty_like(contrib)
    carry = torch.empty_like(base)
    agg_v = torch.empty(tiles, dtype=contrib.dtype, device=contrib.device)
    agg_f = torch.empty(tiles, dtype=torch.int32, device=contrib.device)
    err = kernels.function(f"running_sum_{suffix}")(
        contrib.data_ptr(), reset.data_ptr(), base.data_ptr(), run.data_ptr(),
        carry.data_ptr(), agg_v.data_ptr(), agg_f.data_ptr(), n, kernels.stream(),
    )
    kernels.check(err, "running_sum")
    kernels.launches["running_sum"] += 1
    return run, carry


def extreme_identity(dtype: torch.dtype, is_min: bool) -> torch.Tensor:
    """0-d identity of min (+inf / int max) or max (-inf / int min)."""
    if dtype.is_floating_point:
        return torch.tensor(np.inf if is_min else -np.inf, dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if is_min else info.min, dtype=dtype)


def running_extreme_ref(values, active, reset, base, is_min):
    """Plain version of `running_extreme`, in the JAX package's formulation:
    inactive rows masked to the identity, a segmented scan that restarts at
    each reset, and the carry folded in before the first reset; a float32
    subnormal value reads as a zero of its sign (XLA's CPU code)."""
    ident = extreme_identity(values.dtype, is_min).to(values.device)
    op = extreme_op(values.dtype, is_min)
    masked = torch.where(active, flush_subnormal(values), ident)
    red = segmented_cum_extreme(masked, reset, is_min)
    base_eff = torch.where(last_reset_index(reset) < 0, flush_subnormal(base), ident)
    run = op(red, base_eff)
    return run, run[-1]


def running_extreme(values, active, reset, base, is_min: bool):
    """Running min/max after each row with reset barriers (no removal: the
    forever and unwindowed forms).

    values: [n] float32/int32/int64; active: [n] bool (valid CURRENT rows);
    reset: [n] bool; base: 0-d carry of the same dtype (the identity when
    nothing was seen). NaN propagates as in jnp.minimum/maximum.
    returns: ([n] running values, 0-d new carry)
    """
    if values.device.type == "cpu":
        return running_extreme_ref(values, active, reset, base, is_min)
    kernels.require_cuda("running_extreme", values, active, reset, base)
    n = values.shape[0]
    suffix = _EXTREME_SUFFIX.get(values.dtype)
    if (
        suffix is None or values.dim() != 1 or n == 0
        or active.shape != values.shape or active.dtype != torch.bool
        or reset.shape != values.shape or reset.dtype != torch.bool
        or base.shape != () or base.dtype != values.dtype
    ):
        raise ValueError(
            "running_extreme takes [n] float32/int32/int64 values, [n] bool active and "
            f"reset and a 0-d base of the same dtype; got {values.dtype}{list(values.shape)}, "
            f"{active.dtype}{list(active.shape)}, {reset.dtype}{list(reset.shape)}, "
            f"{base.dtype}{list(base.shape)}"
        )
    tiles = -(-n // _SCAN_TILE)
    run = torch.empty_like(values)
    carry = torch.empty_like(base)
    agg_v = torch.empty(tiles, dtype=values.dtype, device=values.device)
    agg_f = torch.empty(tiles, dtype=torch.int32, device=values.device)
    err = kernels.function(f"running_extreme_{suffix}")(
        values.data_ptr(), active.data_ptr(), reset.data_ptr(), base.data_ptr(),
        run.data_ptr(), carry.data_ptr(), agg_v.data_ptr(), agg_f.data_ptr(), n,
        int(is_min), kernels.stream(),
    )
    kernels.check(err, "running_extreme")
    kernels.launches["running_extreme"] += 1
    return run, carry


# ---------------------------------------------------------------------------
# segmented scans: the plain versions behind the group kernels
# (csrc/group_assign.cu, csrc/keyed_running_sum.cu, csrc/keep_last.cu)
# ---------------------------------------------------------------------------


def _segmented_scan(vals: torch.Tensor, seg_start: torch.Tensor, op) -> torch.Tensor:
    """Inclusive segment-wise scan: positions with seg_start restart the
    accumulator. Hillis-Steele rounds of shift-and-combine (log2 n of them),
    with the JAX package's combine: (a, b) -> b if b restarts, else op(a, b)."""
    v, f = vals, seg_start
    n = v.shape[0]
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def segmented_cumsum(vals: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segment-wise running sum (float32 adds as `add`'s)."""
    return _segmented_scan(vals, seg_start, add)


def extreme_op(dtype: torch.dtype, is_min: bool):
    """The min or max of two lanes: on float32 XLA's (core/types.py
    float_extreme: NaN wins, of zeros of both signs the minimum -0.0 and
    the maximum 0.0, in any order) over values that hold no subnormal."""
    if dtype == torch.float32:
        return lambda a, b: float_extreme(a, b, is_min, False, False)
    return torch.minimum if is_min else torch.maximum


def segmented_cum_extreme(
    vals: torch.Tensor, seg_start: torch.Tensor, is_min: bool
) -> torch.Tensor:
    """Inclusive segment-wise running min/max (`extreme_op`'s)."""
    return _segmented_scan(vals, seg_start, extreme_op(vals.dtype, is_min))


def segmented_carry(vals: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Propagate each segment's first value across the segment."""
    return _segmented_scan(vals, seg_start, lambda a, b: a)


def first_indices(mask: torch.Tensor, size: int, fill: int = -1) -> torch.Tensor:
    """Indices of the first `size` True positions, int32, `fill` past the
    last one."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    dst = torch.where(mask & (rank < size), rank, size).long()
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=mask.device)
    out[dst] = idx
    return out[:size]
