"""Attribute aggregators: streaming sum/count/avg/stdDev/min/max/
minForever/maxForever/distinctCount over batches, grouped or not.

Reference: query/selector/attribute/aggregator/*.java — per-event add on CURRENT,
remove on EXPIRED, zero on RESET, type-specialized inner classes. Batched here:
per-event running outputs become reset-aware prefix reductions (ops/prefix.py),
or keyed segment reductions over a `[G]` slot table when a group-by is present
(ops/group.py); min/max and distinctCount under an upstream window reduce over
the window's lazy membership (exact expiry accounting) instead of incremental
remove, restricted to the row's group under a group-by. Without a window (or
for the forever forms) min/max are running extremes.

Inside a partition the group context is the partition (core/groupby.py
`partition_ctx`): slot = partition slot, carries [P]; under a group-by it is
(partition, group), carries [P*G] (`assign_partitioned`, K33). Each
partition's RESET rows end only its own carries: the carried reductions then
run K8/K19 over a doubled carry, each row reading its old carry, the fresh
half, or none (`GroupCtx.carry_slot`). Windowed min/max there reduce over the
row's partition's window elements only (ops/partition.py
`partition_window_extreme`, K30), keyed by (partition, group) under a
group-by (K3's key lane), as distinctCount does (K20's).

`window_extreme` (csrc/window_extreme.cu, with a key lane when grouped) and
`distinct_count` (csrc/distinct_count.cu) are hand-written CUDA kernels on
the card; each `*_ref` is its plain PyTorch version, which the wrapper takes
only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.executor import CompiledExpr, Env
from siddhi_tpu_torch.core.groupby import CompiledGroupBy, GroupCtx
from siddhi_tpu_torch.core.types import (
    NUMPY_DTYPE,
    PHYSICAL_DTYPE,
    AttrType,
    float32_ftz,
    float_arith,
    float_extreme,
    flush_subnormal,
    null_value,
)
from siddhi_tpu_torch.ops.group import keyed_running_extreme, keyed_running_sum
from siddhi_tpu_torch.ops.prefix import (
    add,
    extreme_identity,
    running_extreme,
    running_sum,
    segmented_cum_extreme,
)
from siddhi_tpu_torch.ops.scatter import set_at


@dataclasses.dataclass
class FlowInfo:
    """Per-batch signals handed to aggregators by the selector.

    sign:   [B] +1 valid CURRENT, -1 valid EXPIRED, 0 otherwise
    active: [B] valid CURRENT rows
    reset:  [B] valid RESET rows
    birth_pos / death_pos: optional [K] int32 lazy window membership — row i
        sees element e iff birth_pos[e] <= i < death_pos[e] — and member_env,
        an Env over the K window elements; provided by window stages for
        exact min/max/distinctCount.
    group:  optional GroupCtx when the selector has a group-by.
    """

    sign: torch.Tensor
    active: torch.Tensor
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
            if g.reset_head is not None:
                return _leaky_sum(state, contrib, g)
            if g.carry_slot is not None:
                return _per_partition(state, torch.zeros_like(state), g, lambda r, c, sl: (
                    keyed_running_sum(contrib.contiguous(), g.groups, r, c, sl)))
            return keyed_running_sum(contrib.contiguous(), g.groups, flow.reset, state, g.slot)
        return running_sum(contrib, flow.reset, state)


def _leaky_sum(state, contrib, g: GroupCtx):
    """An ungrouped partition's running sum after a batch window, as the
    JAX package's flat `running_sum` (ops/prefix.py `running_sum_ref`'s
    formula) gives it in each partition under its vmap: the partition's
    running sum in row order (K8 keyed by partition, no RESET rows), less
    that sum at the partition's last RESET row at or before the row, plus
    the carry before the partition's first RESET. So a NaN, an inf or a
    large earlier bucket of the batch leaks past a RESET, as in the
    reference (ROADMAP section 3). The new carry is each partition's run
    at its last row."""
    p = state.shape[0]
    zero = torch.zeros((), dtype=state.dtype, device=state.device)
    no_reset = torch.zeros(contrib.shape[0], dtype=torch.bool, device=contrib.device)
    csum, _ = keyed_running_sum(contrib.contiguous(), g.forever_groups, no_reset,
                                torch.zeros_like(state), g.slot)
    lr = g.reset_head
    at_lr = torch.where(lr >= 0, csum[lr.clamp(min=0).long()], zero)
    if csum.dtype == torch.float32:
        run = float_arith("sub", csum, at_lr, False, False)
    else:
        run = csum - at_lr
    member = g.slot < p
    base = torch.where(member, state[g.slot.clamp(0, p - 1).long()], zero)
    run = add(run, torch.where(lr < 0, base, zero))
    return run, set_at(state, torch.where(g.tail, g.slot, p), run)


def _per_partition(state, fresh, g: GroupCtx, call):
    """A keyed carried reduction whose RESET rows end only their own
    partition's carries: `call(no_reset, carries, slot)` (K8 or K19 with no
    RESET rows) over the carries laid end to end with `fresh` ones ([2S]),
    each row at its `carry_slot`; a slot whose partition held a RESET row
    takes the fresh half's new carry."""
    flat = state.reshape(-1)
    s = flat.shape[0]
    no_reset = torch.zeros(g.carry_slot.shape[0], dtype=torch.bool, device=flat.device)
    run, carry = call(no_reset, torch.cat([flat, fresh.reshape(-1)]), g.carry_slot)
    return run, torch.where(g.had_reset, carry[s:], carry[:s]).view(state.shape)

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
        mean = float_arith("div", s_run, torch.where(nonzero, c_run, 1.0), False, False)
        out = torch.where(nonzero, mean, torch.nan)
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
    elem_key: Optional[torch.Tensor] = None,
    row_key: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Plain version of `window_extreme`: expand the membership matrix
    `birth_pos[e] <= p < death_pos[e]` (and `elem_key[e] == row_key[p]` when
    keyed), `chunk` output rows at a time (so memory stays at chunk x K
    booleans), mask with the identity and reduce; float32 subnormals read
    as zeros of their sign, and of zeros of both signs the minimum is -0.0
    and the maximum 0.0."""
    ident = extreme_identity(vals.dtype, is_min)
    null = torch.tensor(null_value(t), dtype=vals.dtype)
    vals = flush_subnormal(vals)  # a float32 subnormal as a zero (XLA's CPU code)
    out = []
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        p = torch.arange(lo, hi, device=vals.device)[:, None]
        member = (birth_pos[None, :] <= p) & (p < death_pos[None, :])
        if elem_key is not None:
            member = member & (elem_key[None, :] == row_key[lo:hi, None])
        masked = torch.where(member, vals[None, :], ident)
        red = masked.amin(dim=-1) if is_min else masked.amax(dim=-1)
        if vals.dtype == torch.float32:
            # of zeros of both signs the minimum is -0.0, the maximum 0.0
            signed = (masked == 0) & (masked.signbit() == is_min)
            red = torch.where(red == 0, torch.where(signed.any(-1), -0.0 if is_min else 0.0,
                                                    0.0 if is_min else -0.0), red)
        out.append(torch.where(red == ident, null, red))
    return torch.cat(out)


def window_extreme(
    vals: torch.Tensor,
    birth_pos: torch.Tensor,
    death_pos: torch.Tensor,
    n_rows: int,
    is_min: bool,
    t: AttrType,
    elem_key: Optional[torch.Tensor] = None,
    row_key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per output row p < n_rows, the min/max of vals[e] over the window
    elements alive at p (birth_pos[e] <= p < death_pos[e]) and, when keyed,
    in the row's group (elem_key[e] == row_key[p]); the null sentinel of
    logical type `t` where none is.

    vals: [K] float32/int32/int64; birth_pos, death_pos: [K] int32;
    elem_key: [K] int64 and row_key: [n_rows] int64, or both None.
    """
    if vals.device.type == "cpu":
        return window_extreme_ref(vals, birth_pos, death_pos, n_rows, is_min, t,
                                  elem_key, row_key)
    keyed = elem_key is not None
    kernels.require_cuda("window_extreme", vals, birth_pos, death_pos,
                         *((elem_key, row_key) if keyed else ()))
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
        or keyed and (elem_key.shape != (k,) or elem_key.dtype != torch.int64
                      or row_key.shape != (n_rows,) or row_key.dtype != torch.int64)
    ):
        raise ValueError(
            "window_extreme takes [K] float32/int32/int64 vals of type "
            f"{t!r}, [K] int32 birth/death and optional [K] / [n_rows] int64 keys; got "
            f"{vals.dtype}{list(vals.shape)}, {birth_pos.dtype}{list(birth_pos.shape)}, "
            f"{death_pos.dtype}{list(death_pos.shape)}"
        )
    out = torch.empty(n_rows, dtype=vals.dtype, device=vals.device)
    if keyed:
        err = kernels.function(f"window_extreme_keyed_{suffix}")(
            vals.data_ptr(), birth_pos.data_ptr(), death_pos.data_ptr(), elem_key.data_ptr(),
            row_key.data_ptr(), out.data_ptr(), n_rows, k, int(is_min), _null_bits(t),
            kernels.stream(),
        )
    else:
        err = kernels.function(f"window_extreme_{suffix}")(
            vals.data_ptr(), birth_pos.data_ptr(), death_pos.data_ptr(), out.data_ptr(),
            n_rows, k, int(is_min), _null_bits(t), kernels.stream(),
        )
    kernels.check(err, "window_extreme")
    kernels.launches["window_extreme_keyed" if keyed else "window_extreme"] += 1
    return out


class StdDevAggregator(CompiledAggregator):
    """Population standard deviation from running sum, sum of squares and
    count, in float32 with the JAX package's formula: var = max(q/n - mean²,
    0), rounded once as XLA's fused multiply-add rounds it, null (NaN) at
    count 0 (reference: StdDevAttributeAggregator.java)."""

    type = AttrType.DOUBLE

    def __init__(self, arg: CompiledExpr, device, group=None):
        super().__init__(device, group)
        self.arg = arg

    def init(self):
        return {"sum": self._zeros(torch.float32), "sumsq": self._zeros(torch.float32),
                "count": self._zeros(torch.float32)}

    def apply(self, state, flow: FlowInfo, env: Env):
        x = self.arg(env).to(torch.float32)
        sgn = flow.sign.to(torch.float32)
        live = flow.sign != 0
        s_run, s_c = self._run_sum(state["sum"], torch.where(live, x * sgn, 0.0), flow)
        sq = float_arith("mul", x, x)
        q_run, q_c = self._run_sum(state["sumsq"], torch.where(live, sq * sgn, 0.0), flow)
        c_run, c_c = self._run_sum(state["count"], sgn, flow)
        nonzero = c_run != 0
        safe_n = torch.where(nonzero, c_run, 1.0)
        # the sums hold no subnormal; each float32 step as XLA's CPU code
        # takes it, subnormals as zeros (core/types.py float_arith)
        mean = float_arith("div", s_run, safe_n, False, False)
        qn = float_arith("div", q_run, safe_n, False, False)
        # XLA contracts q/n - mean*mean into one fused multiply-add (one
        # rounding); the float32 product is exact in float64, so this rounds
        # as that FMA does (and a one-element bucket keeps JAX's residue)
        # except when q/n and mean^2 lie so far apart in exponent that the
        # float64 difference itself rounds: a double rounding the FMA lacks
        var = float32_ftz(qn.double() - mean.double() * mean.double())
        var = float_extreme(var, torch.zeros((), device=var.device), False, False, False)
        out = torch.where(nonzero, torch.sqrt(var), torch.nan)
        return {"sum": s_c, "sumsq": q_c, "count": c_c}, out


class ExtremeAggregator(CompiledAggregator):
    """min/max. Exact under a window via its membership lanes (restricted to
    the row's group under a group-by); running (no removal) otherwise.
    minForever/maxForever always run, and ignore resets (reference:
    MinForeverAttributeAggregator.java ignores expiry)."""

    def __init__(self, arg: CompiledExpr, is_min: bool, forever: bool, device, group=None):
        super().__init__(device, group)
        self.arg = arg
        self.type = arg.type
        self.dtype = PHYSICAL_DTYPE[arg.type]
        self.is_min = is_min
        self.forever = forever

    def init(self):
        ident = extreme_identity(self.dtype, self.is_min).to(self.device)
        return ident.expand(self.group.capacity).clone() if self.group is not None else ident

    def apply(self, state, flow: FlowInfo, env: Env):
        if not self.forever and flow.birth_pos is not None:
            vals = self.arg(flow.member_env).to(self.dtype).contiguous()
            n_rows = flow.sign.shape[0]
            m = flow.group.members if flow.group is not None else None
            if m is not None:  # a partitioned length window: its slot's elements only
                from siddhi_tpu_torch.ops.partition import partition_window_extreme

                return state, partition_window_extreme(
                    vals, flow.birth_pos, flow.death_pos, m.slot, m.rowlist, m.slot_start,
                    m.w, self.is_min, self.type)
            keys = (None, None)
            if flow.group is not None:
                keys = (flow.group.key_of(flow.member_env).contiguous(), flow.group.key)
            return state, window_extreme(vals, flow.birth_pos, flow.death_pos, n_rows,
                                         self.is_min, self.type, *keys)
        reset = torch.zeros_like(flow.reset) if self.forever else flow.reset
        x = self.arg(env).to(self.dtype).expand(flow.active.shape).contiguous()
        g = flow.group
        if g is not None and g.carry_slot is not None:
            if self.forever:  # every row reads its slot's carry
                groups = g.forever_groups or g.groups
                run, carry = keyed_running_extreme(x, flow.active, groups, reset,
                                                   state.reshape(-1), g.slot, self.is_min)
                carry = carry.view(state.shape)
            else:
                ident = extreme_identity(self.dtype, self.is_min).to(x.device)
                run, carry = _per_partition(
                    state, ident.expand(state.shape), g, lambda r, c, sl: keyed_running_extreme(
                        x, flow.active, g.groups, r, c, sl, self.is_min))
        elif g is not None:
            groups = g.forever_groups if self.forever and g.forever_groups else g.groups
            run, carry = keyed_running_extreme(x, flow.active, groups, reset, state, g.slot,
                                               self.is_min)
        else:
            run, carry = running_extreme(x, flow.active, reset, state, self.is_min)
        ident = extreme_identity(self.dtype, self.is_min).to(run.device)
        null = torch.tensor(null_value(self.type), dtype=self.dtype, device=run.device)
        return carry, torch.where(run == ident, null, run)


def distinct_count_ref(vals, birth_pos, death_pos, n_rows: int,
                       elem_key: Optional[torch.Tensor] = None,
                       row_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `distinct_count`, without the JAX package's
    [rows, K, K] mask: the present elements sorted by (key, value, birth);
    each run of equal (key, value) merges its alive intervals into disjoint
    blocks; each block is +1 at its start and -1 at its end; a row's count
    is the prefix of its key's events up to its position. Equality is
    JAX's `==`: a NaN equals nothing, -0.0 and the subnormals equal 0.0.
    [n_rows] int64."""
    dev = vals.device
    k = vals.shape[0]
    idx = torch.arange(k, device=dev)
    present = birth_pos < death_pos
    if vals.dtype.is_floating_point:
        vals = flush_subnormal(vals)
        nan = torch.isnan(vals)
        bits = torch.where(vals == 0, torch.zeros_like(vals), vals).view(torch.int32)
        vb = torch.where(nan, idx, bits.to(torch.int64))
    else:
        nan = torch.zeros(k, dtype=torch.bool, device=dev)
        vb = vals.to(torch.int64)
    key = elem_key if elem_key is not None else torch.zeros(k, dtype=torch.int64, device=dev)
    sel = torch.nonzero(present).flatten()
    perm = sel
    for lane in (birth_pos, vb, nan.to(torch.int8), key):  # least significant first
        perm = perm[torch.sort(lane[perm], stable=True).indices]
    sk, sn, sv = key[perm], nan[perm], vb[perm]
    sb, sd = birth_pos[perm].to(torch.int64), death_pos[perm].to(torch.int64)
    m = perm.shape[0]
    run_start = torch.ones(m, dtype=torch.bool, device=dev)
    run_start[1:] = (sk[1:] != sk[:-1]) | (sv[1:] != sv[:-1]) | sn[1:] | sn[:-1]
    # a member opens a new block when it is born after every earlier member
    # of its run has died
    reach = segmented_cum_extreme(sd, run_start, is_min=False)
    opens = run_start.clone()
    opens[1:] |= sb[1:] > reach[:-1]
    block = torch.cumsum(opens.to(torch.int64), 0) - 1
    n_blocks = int(opens.sum())
    if n_blocks == 0:
        return torch.zeros(n_rows, dtype=torch.int64, device=dev)
    start = sb[opens]
    end = torch.full((n_blocks,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, block, sd, reduce="amax")
    bkey = sk[opens]
    rkey = row_key if row_key is not None else torch.zeros(n_rows, dtype=torch.int64, device=dev)
    uniq, dense = torch.unique(torch.cat([bkey, rkey]), return_inverse=True)
    dk, dr = dense[:n_blocks], dense[n_blocks:]
    ev = torch.cat([dk * 2**32 + start, dk * 2**32 + end])
    delta = torch.cat([torch.ones(n_blocks, dtype=torch.int64, device=dev),
                       -torch.ones(n_blocks, dtype=torch.int64, device=dev)])
    ev, order = torch.sort(ev, stable=True)
    pref = torch.cumsum(delta[order], 0)
    q = dr * 2**32 + torch.arange(n_rows, device=dev)
    at = torch.searchsorted(ev, q, right=True) - 1
    return torch.where(at >= 0, pref[at.clamp(min=0)], 0)


def distinct_count(vals, birth_pos, death_pos, n_rows: int,
                   elem_key: Optional[torch.Tensor] = None,
                   row_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per output row p < n_rows, the number of distinct vals[e] among the
    window elements alive at p (birth_pos[e] <= p < death_pos[e]) and, when
    keyed, in the row's group (elem_key[e] == row_key[p]). [n_rows] int64.

    vals: [K] float32/int32/int64/bool; birth_pos, death_pos: [K] int32;
    elem_key: [K] int64 and row_key: [n_rows] int64, or both None.
    """
    if vals.device.type == "cpu":
        return distinct_count_ref(vals, birth_pos, death_pos, n_rows, elem_key, row_key)
    keyed = elem_key is not None
    kernels.require_cuda("distinct_count", vals, birth_pos, death_pos,
                         *((elem_key, row_key) if keyed else ()))
    k = vals.shape[0]
    suffix = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64",
              torch.bool: "b8"}.get(vals.dtype)
    if (
        suffix is None or vals.dim() != 1 or k == 0 or k >= 2**29
        or birth_pos.shape != (k,) or death_pos.shape != (k,)
        or birth_pos.dtype != torch.int32 or death_pos.dtype != torch.int32
        or keyed and (elem_key.shape != (k,) or elem_key.dtype != torch.int64
                      or row_key.shape != (n_rows,) or row_key.dtype != torch.int64)
    ):
        raise ValueError(
            "distinct_count takes [K] float32/int32/int64/bool vals, [K] int32 birth/death "
            f"and optional [K] / [n_rows] int64 keys; got {vals.dtype}{list(vals.shape)}, "
            f"{birth_pos.dtype}{list(birth_pos.shape)}, {death_pos.dtype}"
            f"{list(death_pos.shape)}"
        )
    dev = vals.device
    n = 1
    while n < k:
        n *= 2

    def lane(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)

    out = lane(n_rows, torch.int64)
    scratch = (lane(n, torch.int64), lane(n, torch.int64), lane(n, torch.int32),
               lane(n, torch.int32), lane(n, torch.int32), lane(2 * n, torch.int8),
               lane(2 * n, torch.int64), lane(2 * n, torch.int32), lane(2 * n, torch.int32),
               lane(2 * n, torch.int32), lane(2 * n, torch.int32))
    err = kernels.function(f"distinct_count_{suffix}")(
        vals.data_ptr(), birth_pos.data_ptr(), death_pos.data_ptr(),
        elem_key.data_ptr() if keyed else None, row_key.data_ptr() if keyed else None,
        out.data_ptr(), n_rows, k, n, *(x.data_ptr() for x in scratch), kernels.stream(),
    )
    kernels.check(err, "distinct_count")
    kernels.launches["distinct_count"] += 1
    return out


class DistinctCountAggregator(CompiledAggregator):
    """distinctCount under a window: per row, the distinct member values
    (in the row's group under a group-by) from the window's membership lanes
    (reference: DistinctCountAttributeAggregator.java keeps a value->count
    map; the window's lanes make this a reduction here). The state is an
    unused scalar, kept so the layout matches the JAX package."""

    type = AttrType.LONG

    def __init__(self, arg: CompiledExpr, device, group=None):
        super().__init__(device, group)
        self.arg = arg

    def init(self):
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def apply(self, state, flow: FlowInfo, env: Env):
        if flow.birth_pos is None:
            raise NotImplementedError(
                "distinctCount requires an upstream window (unbounded distinct "
                "state is capacity-unbounded; the reference grows a map forever)"
            )
        vals = self.arg(flow.member_env).contiguous()
        keys = (None, None)
        if flow.group is not None:
            keys = (flow.group.key_of(flow.member_env).contiguous(), flow.group.key)
        return state, distinct_count(vals, flow.birth_pos, flow.death_pos, flow.sign.shape[0],
                                     *keys)


def build_aggregator(
    name: str,
    args: list[CompiledExpr],
    device,
    group: Optional[CompiledGroupBy] = None,
):
    """Reference: AttributeAggregatorExecutor extensions by name."""
    low = name.lower()
    if low == "count":
        return CountAggregator(device, group)
    if not args:
        raise TypeError(f"aggregator '{name}' needs an argument")
    arg = args[0]
    if low == "sum":
        return SumAggregator(arg, device, group)
    if low == "avg":
        return AvgAggregator(arg, device, group)
    if low == "stddev":
        return StdDevAggregator(arg, device, group)
    if low in ("min", "max", "minforever", "maxforever"):
        return ExtremeAggregator(arg, is_min=low.startswith("min"),
                                 forever=low.endswith("forever"), device=device, group=group)
    if low == "distinctcount":
        return DistinctCountAggregator(arg, device, group)
    raise TypeError(f"unknown aggregator '{name}'")
