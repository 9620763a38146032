"""The Flow — the object threaded through a compiled query chain.

The reference threads `ComplexEventChunk`s through a linked `Processor` chain
(reference: query/processor/Processor.java); here the chain is a composition of
stages, each a function over this Flow that launches device work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from siddhi_tpu_torch.core.event import EventBatch, KIND_CURRENT, KIND_EXPIRED, KIND_RESET
from siddhi_tpu_torch.core.executor import Env, TS_ATTR, VALID_ATTR, VarKey


@dataclasses.dataclass
class Flow:
    """batch: events flowing through (padding/filtered rows have valid=False)
    ref: the stream ref whose attributes the batch columns carry
    birth_pos / death_pos / member_env: lazy window membership (see
        aggregators.FlowInfo), set by a window stage
    aux: device flags for the host (the selector's "groupby_overflow", a
        join's "join_overflow", a time window's "next_timer"), read by the
        query runtime (the flags off the dispatch path)
    extra_cols: further columns keyed (ref, None, attr): a joined batch's
        right-side columns and both refs' timestamps
    partition: inside a partition, each row's partition slot and segment
        (a core/groupby.py GroupCtx from `partition_ctx`), else None
    """

    batch: EventBatch
    ref: str
    now: torch.Tensor  # 0-d int64 wall/playback clock
    birth_pos: Optional[torch.Tensor] = None
    death_pos: Optional[torch.Tensor] = None
    member_env: Optional[Env] = None
    aux: dict = dataclasses.field(default_factory=dict)
    extra_cols: dict = dataclasses.field(default_factory=dict)
    partition: Optional[object] = None

    def env(self) -> Env:
        cols: dict[VarKey, torch.Tensor] = {
            (self.ref, None, name): arr for name, arr in self.batch.cols.items()
        }
        cols[(self.ref, None, TS_ATTR)] = self.batch.ts
        cols[(self.ref, None, VALID_ATTR)] = self.batch.valid
        cols.update(self.extra_cols)
        return Env(cols, now=self.now)

    # ---- kind masks ----
    @property
    def current(self) -> torch.Tensor:
        return self.batch.valid & (self.batch.kind == KIND_CURRENT)

    @property
    def expired(self) -> torch.Tensor:
        return self.batch.valid & (self.batch.kind == KIND_EXPIRED)

    @property
    def reset(self) -> torch.Tensor:
        return self.batch.valid & (self.batch.kind == KIND_RESET)

    @property
    def sign(self) -> torch.Tensor:
        return self.current.to(torch.int8) - self.expired.to(torch.int8)
