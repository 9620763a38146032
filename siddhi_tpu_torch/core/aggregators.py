"""Attribute aggregators: streaming sum/count/avg/min/max over batches.

Reference: query/selector/attribute/aggregator/*.java — per-event add on CURRENT,
remove on EXPIRED, zero on RESET, type-specialized inner classes. Batched here:
per-event running outputs become reset-aware prefix reductions (ops/prefix.py),
or keyed segment reductions over a `[G]` slot table when a group-by is present
(ops/group.py); min/max under an upstream window reduce over the window's lazy
membership (exact expiry accounting) instead of incremental remove. Grouped
min/max waits for a key lane in the windowed-extreme kernel and raises "not
ported yet".

`window_extreme` is a hand-written CUDA kernel on the card
(csrc/window_extreme.cu); `window_extreme_ref` is its plain PyTorch version,
which the wrapper takes only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.executor import CompiledExpr, Env
from siddhi_tpu_torch.core.groupby import CompiledGroupBy, GroupCtx
from siddhi_tpu_torch.core.types import NUMPY_DTYPE, PHYSICAL_DTYPE, AttrType, null_value
from siddhi_tpu_torch.ops.group import keyed_running_sum
from siddhi_tpu_torch.ops.prefix import extreme_identity, running_sum


@dataclasses.dataclass
class FlowInfo:
    """Per-batch signals handed to aggregators by the selector.

    sign:   [B] +1 valid CURRENT, -1 valid EXPIRED, 0 otherwise
    reset:  [B] valid RESET rows
    birth_pos / death_pos: optional [K] int32 lazy window membership — row i
        sees element e iff birth_pos[e] <= i < death_pos[e] — and member_env,
        an Env over the K window elements; provided by window stages for
        exact min/max.
    group:  optional GroupCtx when the selector has a group-by.
    """

    sign: torch.Tensor
    reset: torch.Tensor
    birth_pos: Optional[torch.Tensor] = None
    death_pos: Optional[torch.Tensor] = None
    member_env: Optional[Env] = None
    group: Optional[GroupCtx] = None


class CompiledAggregator:
    """One aggregator instance in a selector; owns a slice of query state.

    With a group-by its state arrays gain a leading [G] axis indexed by the
    GroupCtx slot lane."""

    type: AttrType

    def __init__(self, device, group: Optional[CompiledGroupBy] = None):
        self.device = torch.device(device)
        self.group = group

    def _zeros(self, dtype) -> torch.Tensor:
        shape = (self.group.capacity,) if self.group is not None else ()
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def init(self):  # -> tree of device tensors
        raise NotImplementedError

    def apply(self, state, flow: FlowInfo, env: Env):  # -> (state', [B] col)
        raise NotImplementedError

    def _run_sum(self, state, contrib, flow: FlowInfo):
        """(run, carry): keyed over the group's segments, else flat."""
        if flow.group is not None:
            g = flow.group
            return keyed_running_sum(contrib.contiguous(), g.groups, flow.reset, state, g.slot)
        return running_sum(contrib, flow.reset, state)


class SumAggregator(CompiledAggregator):
    """sum(): LONG for int/long input, DOUBLE for float/double
    (reference: SumAttributeAggregator.java type matrix)."""

    def __init__(self, arg: CompiledExpr, device, group=None):
        super().__init__(device, group)
        self.arg = arg
        self.type = (
            AttrType.LONG if arg.type in (AttrType.INT, AttrType.LONG) else AttrType.DOUBLE
        )
        self.dtype = PHYSICAL_DTYPE[self.type]

    def init(self):
        return self._zeros(self.dtype)

    def apply(self, state, flow: FlowInfo, env: Env):
        x = self.arg(env).to(self.dtype)
        contrib = torch.where(flow.sign != 0, x * flow.sign.to(self.dtype), 0)
        run, carry = self._run_sum(state, contrib, flow)
        return carry, run


class CountAggregator(CompiledAggregator):
    type = AttrType.LONG

    def init(self):
        return self._zeros(torch.int64)

    def apply(self, state, flow: FlowInfo, env: Env):
        run, carry = self._run_sum(state, flow.sign.to(torch.int64), flow)
        return carry, run


class AvgAggregator(CompiledAggregator):
    """DOUBLE average; null (NaN) when count == 0, matching the reference
    (reference: AvgAttributeAggregator.java:164-166 returns null on count 0)."""

    type = AttrType.DOUBLE

    def __init__(self, arg: CompiledExpr, device, group=None):
        super().__init__(device, group)
        self.arg = arg

    def init(self):
        return {"sum": self._zeros(torch.float32), "count": self._zeros(torch.float32)}

    def apply(self, state, flow: FlowInfo, env: Env):
        x = self.arg(env).to(torch.float32)
        sgn = flow.sign.to(torch.float32)
        contrib = torch.where(flow.sign != 0, x * sgn, 0.0)
        s_run, s_carry = self._run_sum(state["sum"], contrib, flow)
        c_run, c_carry = self._run_sum(state["count"], sgn, flow)
        nonzero = c_run != 0
        out = torch.where(nonzero, s_run / torch.where(nonzero, c_run, 1.0), torch.nan)
        return {"sum": s_carry, "count": c_carry}, out


def _null_bits(t: AttrType) -> int:
    """The null sentinel of `t`, as the integer bit pattern the kernel takes."""
    v = np.asarray(null_value(t), dtype=NUMPY_DTYPE[t])
    return int(v.view(np.int32)) if v.dtype == np.float32 else int(v)


def window_extreme_ref(
    vals: torch.Tensor,
    birth_pos: torch.Tensor,
    death_pos: torch.Tensor,
    n_rows: int,
    is_min: bool,
    t: AttrType,
    chunk: int = 1024,
) -> torch.Tensor:
    """Plain version of `window_extreme`: expand the membership matrix
    `birth_pos[e] <= p < death_pos[e]`, `chunk` output rows at a time (so
    memory stays at chunk x K booleans), mask with the identity and reduce."""
    ident = extreme_identity(vals.dtype, is_min)
    null = torch.tensor(null_value(t), dtype=vals.dtype)
    out = []
    for lo in range(0, n_rows, chunk):
        p = torch.arange(lo, min(lo + chunk, n_rows), device=vals.device)[:, None]
        member = (birth_pos[None, :] <= p) & (p < death_pos[None, :])
        masked = torch.where(member, vals[None, :], ident)
        red = masked.amin(dim=-1) if is_min else masked.amax(dim=-1)
        out.append(torch.where(red == ident, null, red))
    return torch.cat(out)


def window_extreme(
    vals: torch.Tensor,
    birth_pos: torch.Tensor,
    death_pos: torch.Tensor,
    n_rows: int,
    is_min: bool,
    t: AttrType,
) -> torch.Tensor:
    """Per output row p < n_rows, the min/max of vals[e] over the window
    elements alive at p (birth_pos[e] <= p < death_pos[e]); the null sentinel
    of logical type `t` where the window is empty.

    vals: [K] float32/int32/int64; birth_pos, death_pos: [K] int32.
    """
    if vals.device.type == "cpu":
        return window_extreme_ref(vals, birth_pos, death_pos, n_rows, is_min, t)
    kernels.require_cuda("window_extreme", vals, birth_pos, death_pos)
    suffix = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64"}.get(vals.dtype)
    k = vals.shape[0]
    if (
        suffix is None
        or vals.dim() != 1
        or PHYSICAL_DTYPE[t] != vals.dtype
        or birth_pos.shape != (k,)
        or death_pos.shape != (k,)
        or birth_pos.dtype != torch.int32
        or death_pos.dtype != torch.int32
    ):
        raise ValueError(
            "window_extreme takes [K] float32/int32/int64 vals of type "
            f"{t!r} and [K] int32 birth/death; got {vals.dtype}{list(vals.shape)}, "
            f"{birth_pos.dtype}{list(birth_pos.shape)}, {death_pos.dtype}"
            f"{list(death_pos.shape)}"
        )
    out = torch.empty(n_rows, dtype=vals.dtype, device=vals.device)
    err = kernels.function(f"window_extreme_{suffix}")(
        vals.data_ptr(), birth_pos.data_ptr(), death_pos.data_ptr(), out.data_ptr(),
        n_rows, k, int(is_min), _null_bits(t), kernels.stream(),
    )
    kernels.check(err, "window_extreme")
    kernels.launches["window_extreme"] += 1
    return out


class ExtremeAggregator(CompiledAggregator):
    """min/max under a window, exact via its membership lanes (the state is
    the unused identity, kept so the state layout matches the JAX package)."""

    def __init__(self, arg: CompiledExpr, is_min: bool, device):
        super().__init__(device)
        self.arg = arg
        self.type = arg.type
        self.dtype = PHYSICAL_DTYPE[arg.type]
        self.is_min = is_min

    def init(self):
        return extreme_identity(self.dtype, self.is_min).to(self.device)

    def apply(self, state, flow: FlowInfo, env: Env):
        vals = self.arg(flow.member_env).to(self.dtype).contiguous()
        n_rows = flow.sign.shape[0]
        return state, window_extreme(
            vals, flow.birth_pos, flow.death_pos, n_rows, self.is_min, self.type
        )


def build_aggregator(
    name: str,
    args: list[CompiledExpr],
    device,
    windowed: bool,
    group: Optional[CompiledGroupBy] = None,
):
    low = name.lower()
    if low == "count":
        return CountAggregator(device, group)
    if low not in ("sum", "avg", "min", "max"):
        raise SiddhiAppCreationError(f"aggregator '{name}' is not ported yet")
    if not args:
        raise TypeError(f"aggregator '{name}' needs an argument")
    arg = args[0]
    if low == "sum":
        return SumAggregator(arg, device, group)
    if low == "avg":
        return AvgAggregator(arg, device, group)
    if group is not None:
        raise SiddhiAppCreationError(f"{name}() with a group by is not ported yet")
    if not windowed:
        raise SiddhiAppCreationError(
            f"{name}() without an upstream window is not ported yet"
        )
    return ExtremeAggregator(arg, is_min=low == "min", device=device)
