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
from siddhi_tpu_torch.ops.group import Groups, assign_slots, mix_keys
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
    # a partition's rows after its length window: ops/partition.py
    # PartitionMembers (the window's per-slot element lists), else None
    members: Optional[object] = None


# the member env's lane of each window element's partition slot
PARTITION_SLOT_KEY = ("__partition__", None, "slot")
_NO_RESET: dict = {}


def partition_ctx(slot: torch.Tensor, first: torch.Tensor, capacity: int,
                  overflow: torch.Tensor, members=None) -> GroupCtx:
    """The group context of a partition's rows: the slot lane is the
    partition slot (`capacity` for rows of no partition), `first` each row's
    segment head (the first row of its slot), no reset. Aggregators then run
    keyed by partition, their carries [P] (siddhi_tpu/core/partition.py's
    vmap over [P] states, in the keyed form)."""
    key = (slot.device, slot.shape[0])
    bounds = _NO_RESET.get(key)
    if bounds is None:
        bounds = _NO_RESET[key] = torch.tensor([slot.shape[0], -1], dtype=torch.int32,
                                               device=slot.device)
    return GroupCtx(slot=slot, key=slot.to(torch.int64), groups=Groups(first, bounds),
                    capacity=capacity, key_of=lambda env: env.read(PARTITION_SLOT_KEY),
                    overflow=overflow, members=members)


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
