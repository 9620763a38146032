"""Scatter-set into a small fixed-capacity target, with dead lanes.

The semantics of the JAX package's `set_at` and `compact_set_at`: write
`src[i]` into `dst[idx[i]]` for every live lane; any index >= len(dst) (not
only the == G sentinel) is a dead lane whose write is dropped. At most one
live writer exists per target slot. `compact_set_at` differs from `set_at`
only in how the TPU schedules it (live writers sorted to the front), and
both split 64-bit lanes into int32 pairs for the TPU's scalar core; neither
is needed here, so one function serves both. This is the plain version: on
the card the writes happen inside the group kernels (csrc/group_assign.cu,
csrc/keyed_running_sum.cu) and the batch window's gathers
(csrc/batch_window.cu).
"""

from __future__ import annotations

import torch


def set_at(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A copy of `dst` with dst[idx[i]] = src[i] where 0 <= idx[i] < len(dst)."""
    n = dst.shape[0]
    live = (idx >= 0) & (idx < n)
    src = src.to(dst.dtype)
    if src.dim() == 0:
        src = src.expand(idx.shape)
    # the dead lanes write one spare row past the end, which is dropped: no
    # host read of how many lanes are live
    out = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    out[torch.where(live, idx, n).long()] = src
    return out[:n]

