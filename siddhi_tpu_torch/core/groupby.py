"""Compiled group-by: key generation + persistent slot table.

Reference: query/selector/GroupByKeyGenerator.java builds a string key per
event; QuerySelector.java:167-226 keeps per-key aggregator state in maps keyed
by that string. Here the key is an int64 device column, the map is a
fixed-capacity device key table (ops/group.py:assign_slots), and aggregator
state is a [G]-array slice per aggregator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.executor import CompiledExpr, Env, Scope, compile_expression
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.ops.group import Groups, assign_slots, mix_keys, partition_assign_slots
from siddhi_tpu_torch.query_api.expression import Variable

DEFAULT_GROUP_CAPACITY = 1024


def _as_key_col(col: torch.Tensor, t: AttrType) -> torch.Tensor:
    """Integer-encode one key column (floats are bitcast through int32 so
    distinct payloads stay distinct; strings are already interned ids)."""
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        return col.contiguous().view(torch.int32).to(torch.int64)
    return col.to(torch.int64)


@dataclasses.dataclass
class GroupCtx:
    """Per-batch group context handed to aggregators via FlowInfo."""

    slot: torch.Tensor  # [rows] int32; == capacity for rows without a key
    key: torch.Tensor  # [rows] int64
    groups: Groups  # each row's (era, key) segment, for keyed reductions
    capacity: int
    key_of: Callable[[Env], torch.Tensor]  # env -> int64 key column
    overflow: torch.Tensor  # 0-d bool
    # a partition's rows after its window: ops/partition.py
    # PartitionMembers (the window's per-slot element lists), else None
    members: Optional[object] = None
    # inside a partition whose rows may hold RESET rows (a batch window) or
    # under a group-by: the carried reductions run over a doubled carry
    # [2S] (S = P, or P*G under a group-by), the old carries then zeros.
    # carry_slot [rows] int32: a row before its partition's first RESET
    # takes its old carry (slot), a row after its partition's last RESET
    # the fresh half (S + slot), any other row none (2S: dead); had_reset
    # [S] bool: the slots whose new carry is the fresh half's
    carry_slot: Optional[torch.Tensor] = None
    had_reset: Optional[torch.Tensor] = None
    # the segments of the forever extremes, which ignore RESET rows (the
    # rows of each partition, without eras, when ungrouped), else `groups`
    forever_groups: Optional[Groups] = None
    # the group key each row hands a per-group rate limiter, else `key`
    emit_key: Optional[torch.Tensor] = None
    # an ungrouped partition after a batch window, whose sums follow the
    # JAX package's flat running sum a partition (core/aggregators.py
    # `_leaky_sum`): reset_head [rows] int32, each member row's last RESET
    # row of its partition at or before it (-1: none); tail [rows] bool,
    # the last member row of each partition
    reset_head: Optional[torch.Tensor] = None
    tail: Optional[torch.Tensor] = None


# the member env's lane of each window element's partition slot
PARTITION_SLOT_KEY = ("__partition__", None, "slot")
_NO_RESET: dict = {}


def _no_reset(rows: int, device) -> torch.Tensor:
    key = (device, rows)
    bounds = _NO_RESET.get(key)
    if bounds is None:
        bounds = _NO_RESET[key] = torch.tensor([rows, -1], dtype=torch.int32, device=device)
    return bounds


def partition_ctx(slot: torch.Tensor, first: torch.Tensor, capacity: int,
                  overflow: torch.Tensor, members=None) -> GroupCtx:
    """The group context of a partition's rows: the slot lane is the
    partition slot (`capacity` for rows of no partition), `first` each row's
    segment head (the first row of its slot), no reset. Aggregators then run
    keyed by partition, their carries [P] (siddhi_tpu/core/partition.py's
    vmap over [P] states, in the keyed form)."""
    bounds = _no_reset(slot.shape[0], slot.device)
    return GroupCtx(slot=slot, key=slot.to(torch.int64), groups=Groups(first, bounds),
                    capacity=capacity, key_of=lambda env: env.read(PARTITION_SLOT_KEY),
                    overflow=overflow, members=members)


def slot_first(slot: torch.Tensor, p: int) -> torch.Tensor:
    """[rows] int32: each row's first row of its partition slot (the row
    itself for a row of no partition)."""
    return first_of(slot.to(torch.int64), (slot >= 0) & (slot < p))


def first_of(keys: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """[rows] int32: for a member row, the first member row with its key;
    any other row itself (the segment heads of ops/group.py `Groups`)."""
    rows = keys.shape[0]
    idx = torch.arange(rows, device=keys.device)
    uniq, inv = torch.unique(torch.where(member, keys, -1 - idx), return_inverse=True)
    heads = torch.full((uniq.shape[0],), rows, dtype=torch.int64, device=keys.device)
    heads = heads.scatter_reduce(0, inv, idx, reduce="amin")
    return heads[inv].to(torch.int32)


def rank_within(key: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[rows] int64: each row's sum of `weight` over the earlier rows (in row
    order) with its key."""
    rows = key.shape[0]
    order = torch.sort(key, stable=True).indices
    w = weight[order].to(torch.int64)
    cs = torch.cumsum(w, 0) - w
    ks = key[order]
    start = torch.ones(rows, dtype=torch.bool, device=key.device)
    start[1:] = ks[1:] != ks[:-1]
    idx = torch.arange(rows, device=key.device)
    head = torch.cummax(torch.where(start, idx, 0), 0).values
    out = torch.empty_like(cs)
    out[order] = cs - cs[head]
    return out


def partition_eras(pslot: torch.Tensor, reset: torch.Tensor, p: int):
    """Each row's RESET era within its partition (the RESET rows of its
    partition at or before it), whether it comes after its partition's last
    RESET, and which partitions hold one: (era [rows] int64, post [rows]
    bool, had_reset [P] bool). A row of no partition (slot P) is era 0."""
    member = (pslot >= 0) & (pslot < p)
    key = torch.where(member, pslot, p).to(torch.int64)
    r = (reset & member).to(torch.int64)
    era = rank_within(key, r) + r
    n_reset = torch.zeros(p + 1, dtype=torch.int64, device=pslot.device).scatter_add_(0, key, r)
    return era, era == n_reset[key], n_reset[:p] > 0


def partition_era_ctx(pctx: GroupCtx, reset: torch.Tensor) -> GroupCtx:
    """The group context of an ungrouped partition's rows that may hold
    RESET rows (after a batch window): segments by (partition, era), each
    partition's RESET rows ending its carries (core/aggregators.py takes
    `carry_slot` / `had_reset`), as the JAX package's flat running
    reductions do in each partition under its vmap."""
    pslot, p = pctx.slot, pctx.capacity
    rows = pslot.shape[0]
    member = (pslot >= 0) & (pslot < p)
    era, post, had = partition_eras(pslot, reset, p)
    first = first_of(pslot.to(torch.int64) * (rows + 1) + era, member)
    carry_slot = torch.where(member & (era == 0), pslot,
                             torch.where(member & post, p + pslot, 2 * p)).to(torch.int32)
    # a RESET row opens its era, so an era's first row is its RESET row
    reset_head = torch.where(member & (era > 0), first, -1).to(torch.int32)
    key = torch.where(member, pslot, p).to(torch.int64)
    idx = torch.arange(rows, device=pslot.device)
    last = torch.full((p + 1,), -1, dtype=torch.int64, device=pslot.device).scatter_reduce(
        0, key, idx, reduce="amax")
    return dataclasses.replace(pctx, groups=Groups(first, _no_reset(rows, pslot.device)),
                               carry_slot=carry_slot, had_reset=had,
                               forever_groups=pctx.groups, reset_head=reset_head,
                               tail=member & (last[key] == idx))


class CompiledGroupBy:
    def __init__(
        self, group_by: list[Variable], scope: Scope, capacity: int = DEFAULT_GROUP_CAPACITY
    ):
        if not group_by:
            raise SiddhiAppCreationError("empty group by")
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise SiddhiAppCreationError(f"group capacity must be >= 1, got {capacity}")
        self.device = scope.device
        self.keys: list[CompiledExpr] = [compile_expression(v, scope) for v in group_by]
        for v, c in zip(group_by, self.keys):
            if c.type is AttrType.OBJECT:
                raise SiddhiAppCreationError(f"cannot group by OBJECT attribute '{v.attribute}'")

    def key_of(self, env: Env) -> torch.Tensor:
        return mix_keys([_as_key_col(c(env), c.type) for c in self.keys])

    def init_state(self):
        g, dev = self.capacity, self.device
        return {
            "keys": torch.zeros(g, dtype=torch.int64, device=dev),
            "used": torch.zeros(g, dtype=torch.bool, device=dev),
            "n": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def assign(self, state, env: Env, active: torch.Tensor, reset: torch.Tensor):
        bk = self.key_of(env).expand(active.shape).contiguous()
        keys, used, n, slot, groups, overflow = assign_slots(
            state["keys"], state["used"], state["n"], bk, active.contiguous(), reset.contiguous()
        )
        ctx = GroupCtx(slot=slot, key=bk, groups=groups, capacity=self.capacity,
                       key_of=self.key_of, overflow=overflow)
        return {"keys": keys, "used": used, "n": n}, ctx

    def assign_partitioned(self, state, env: Env, active: torch.Tensor, reset: torch.Tensor,
                           pctx: GroupCtx):
        """Inside a partition: each partition's own [G] table (K33,
        ops/group.py `partition_assign_slots`), its own allocation order,
        RESET eras and overflow, as the JAX package's vmap runs `assign`
        once per partition. The carries are [P*G], slot p*G + g; windowed
        reductions key by (partition, group); a per-group rate limiter sees
        the group key."""
        p, g = pctx.capacity, self.capacity
        pslot = pctx.slot
        rows = pslot.shape[0]
        bk = self.key_of(env).expand(active.shape).contiguous()
        keys, used, n, gslot, first, povf = partition_assign_slots(
            state["keys"], state["used"], state["n"], bk, active.contiguous(),
            reset.contiguous(), pslot.contiguous(), p)
        s = p * g
        member = (pslot >= 0) & (pslot < p)
        live = member & (gslot < g)
        flat = torch.where(live, pslot.to(torch.int64) * g + gslot, s)
        era, post, had = partition_eras(pslot, reset, p)
        carry_slot = torch.where(live & (era == 0), flat, torch.where(live & post, s + flat, 2 * s))
        groups = Groups(first, _no_reset(rows, pslot.device))

        def key_of(menv: Env, _k=self.key_of):
            return mix_keys([menv.read(PARTITION_SLOT_KEY), _k(menv)])

        ctx = GroupCtx(slot=flat.to(torch.int32), key=mix_keys([pslot, bk]), groups=groups,
                       capacity=s, key_of=key_of, overflow=povf.any(),
                       carry_slot=carry_slot.to(torch.int32),
                       had_reset=had.repeat_interleave(g), forever_groups=groups, emit_key=bk)
        return {"keys": keys, "used": used, "n": n}, ctx
