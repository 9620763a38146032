"""Sort, frequent, lossyFrequent and cron windows — per-arrival state machines.

Reference: query/processor/stream/window/SortWindowProcessor.java:145-173
(keep N smallest per comparator, evict the greatest as EXPIRED),
FrequentWindowProcessor.java:106-160 (Misra-Gries top-N counting),
LossyFrequentWindowProcessor.java:139-200 (lossy counting with
support/error bounds), CronWindowProcessor.dispatchEvents:173-198 (collect
arrivals, flush at each cron fire).

Each arrival can evict a data-dependent victim, so each step walks the
batch's rows in order into a fixed-capacity emission buffer: one
hand-written CUDA kernel a step on the card (K25-K28, ops/special_window.py,
csrc/special_window.cu). None of these windows sets a lazy membership
(birth/death positions): aggregators downstream take their running forms.
Inside a partition every window's lanes gain a leading [P] axis and one
step runs every partition's window at once by the rows' slots
(ops/partition.py K40-K43), the rows out in (position, slot) order; a
TIMER row reaches every partition's cron window.
"""

from __future__ import annotations

import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import StreamSchema
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.groupby import _as_key_col, partition_ctx
from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE, AttrType
from siddhi_tpu_torch.core.windows import WindowStage
from siddhi_tpu_torch.ops.group import mix_keys
from siddhi_tpu_torch.ops.partition import (
    partition_cron_window_step,
    partition_frequent_window_step,
    partition_lossy_frequent_window_step,
    partition_sort_window_step,
)
from siddhi_tpu_torch.ops.special_window import (
    cron_window_step,
    frequent_window_step,
    lossy_frequent_window_step,
    sort_window_step,
)
from siddhi_tpu_torch.utils.cron import CronSchedule

_I64_MAX = torch.iinfo(torch.int64).max


def _zero_cols(schema: StreamSchema, w: int, dev) -> dict:
    return {n: torch.zeros(w, dtype=PHYSICAL_DTYPE[t], device=dev) for n, t in schema.attrs}


def _out_flow(out, flow: Flow, ovf) -> Flow:
    aux = dict(flow.aux)
    aux["window_overflow"] = ovf
    return Flow(batch=out, ref=flow.ref, now=flow.now, aux=aux)


def _keyed_flow(res, flow: Flow):
    """(state, Flow) of a keyed step's (state, out, slot, first, overflow):
    the rows' partition context is their slot lane."""
    st, out, out_slot, out_first, ovf = res
    ctx = flow.partition
    fl = _out_flow(out, flow, ovf)
    fl.partition = partition_ctx(out_slot, out_first, ctx.capacity, ctx.overflow)
    return st, fl


def _take(lane: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(lane, order, dim=-1)


def _key_col(cols: dict, attrs, key_attrs: list) -> torch.Tensor:
    """int64 key of each row from the chosen attributes (every attribute when
    none is given), like the reference's string-concat key
    (FrequentWindowProcessor.generateKey): float columns by their bits."""
    types = dict(attrs)
    names = key_attrs if key_attrs else [n for n, _ in attrs]
    return mix_keys([_as_key_col(cols[n].contiguous(), types[n]) for n in names])


class SortWindow(WindowStage):
    """#window.sort(N, attr asc|desc, ...) — retains the N least events per the
    comparator; each overflow evicts the greatest (ties: most recent)."""

    def __init__(self, schema: StreamSchema, ref: str, n: int, keys: list, device):
        self.schema = schema
        self.ref = ref
        self.n = int(n)
        self.device = torch.device(device)
        if not keys:
            raise SiddhiAppCreationError("sort window needs at least one sort attribute")
        for name, _desc in keys:
            if name not in schema.attr_types:
                raise KeyError(f"no attribute '{name}' in stream '{schema.stream_id}' "
                               f"(has {schema.attr_names})")
            if schema.attr_types[name] in (AttrType.STRING, AttrType.OBJECT):
                raise SiddhiAppCreationError(
                    "sort window on STRING/OBJECT attributes is not supported "
                    "(interned ids are not lexicographic)")
        self.keys = keys

    def init_state(self):
        w, dev = self.n, self.device
        return {
            "cols": _zero_cols(self.schema, w, dev),
            "ts": torch.zeros(w, dtype=torch.int64, device=dev),
            "occ": torch.zeros(w, dtype=torch.bool, device=dev),
            "seq": torch.zeros(w, dtype=torch.int64, device=dev),
            "next": torch.zeros((), dtype=torch.int64, device=dev),
        }

    def apply(self, state, flow: Flow):
        if flow.partition is not None:  # every partition's window at once (K40)
            ctx = flow.partition
            return _keyed_flow(partition_sort_window_step(
                state, flow.batch, ctx.slot, flow.now, self.keys, self.n, ctx.capacity), flow)
        st, out, ovf = sort_window_step(state, flow.batch, flow.now, self.keys, self.n)
        return st, _out_flow(out, flow, ovf)

    def view(self, state):
        # insertion order, empty slots last (a stable order by seq); inside
        # a partition each slot's row of the [P, N] lanes
        order = torch.argsort(torch.where(state["occ"], state["seq"], _I64_MAX), dim=-1,
                              stable=True)
        return ({k: _take(c, order) for k, c in state["cols"].items()},
                _take(state["ts"], order), _take(state["occ"], order))


class CronWindow(WindowStage):
    """#window.cron('expr') — collect arrivals; at each cron fire emit the
    previous bucket as EXPIRED (ts = now), a RESET, then the collected bucket
    as CURRENT. The fire times are TIMER rows the app runtime schedules from
    the cron expression on the host (`cron_schedule.next_fire_ms`)."""

    is_batch = True
    needs_scheduler = True

    def __init__(self, schema: StreamSchema, ref: str, cron_expr: str, device,
                 capacity: int = 256):
        self.schema = schema
        self.ref = ref
        self.w = int(capacity)
        self.device = torch.device(device)
        try:
            self.cron_schedule = CronSchedule(cron_expr)
        except ValueError as e:
            raise SiddhiAppCreationError(f"cron window: {e}") from None

    def init_state(self):
        w, dev = self.w, self.device
        return {
            "cur_cols": _zero_cols(self.schema, w, dev),
            "cur_ts": torch.zeros(w, dtype=torch.int64, device=dev),
            "cur_n": torch.zeros((), dtype=torch.int32, device=dev),
            "prev_cols": _zero_cols(self.schema, w, dev),
            "prev_ts": torch.zeros(w, dtype=torch.int64, device=dev),
            "prev_n": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def apply(self, state, flow: Flow):
        if flow.partition is not None:  # every partition's window at once (K43)
            ctx = flow.partition
            return _keyed_flow(partition_cron_window_step(
                state, flow.batch, ctx.slot, flow.now, self.w, ctx.capacity), flow)
        st, out, ovf = cron_window_step(state, flow.batch, flow.now, self.w)
        return st, _out_flow(out, flow, ovf)

    def view(self, state):
        mask = torch.arange(self.w, dtype=torch.int32, device=state["cur_ts"].device) < state["cur_n"]
        return dict(state["cur_cols"]), state["cur_ts"], mask


class FrequentWindow(WindowStage):
    """#window.frequent(N [, attrs...]) — retains the latest event per key for
    the N most frequent keys (Misra-Gries)."""

    def __init__(self, schema: StreamSchema, ref: str, n: int, key_attrs: list, device):
        self.schema = schema
        self.ref = ref
        self.n = int(n)
        self.key_attrs = key_attrs
        self.device = torch.device(device)

    def init_state(self):
        w, dev = self.n, self.device
        return {
            "cols": _zero_cols(self.schema, w, dev),
            "ts": torch.zeros(w, dtype=torch.int64, device=dev),
            "occ": torch.zeros(w, dtype=torch.bool, device=dev),
            "key": torch.zeros(w, dtype=torch.int64, device=dev),
            "cnt": torch.zeros(w, dtype=torch.int32, device=dev),
        }

    def apply(self, state, flow: Flow):
        b = flow.batch
        key = _key_col(b.cols, self.schema.attrs, self.key_attrs).expand(b.ts.shape).contiguous()
        if flow.partition is not None:  # every partition's window at once (K41)
            ctx = flow.partition
            return _keyed_flow(partition_frequent_window_step(
                state, b, key, ctx.slot, flow.now, self.n, ctx.capacity), flow)
        st, out, ovf = frequent_window_step(state, b, key, flow.now, self.n)
        return st, _out_flow(out, flow, ovf)

    def view(self, state):
        return dict(state["cols"]), state["ts"], state["occ"]


class LossyFrequentWindow(WindowStage):
    """#window.lossyFrequent(supportThreshold, errorBound [, attrs...])."""

    def __init__(self, schema: StreamSchema, ref: str, support: float, error: float,
                 key_attrs: list, device):
        self.schema = schema
        self.ref = ref
        self.support = float(support)
        self.error = float(error)
        if not (0 < self.error < 1) or not (0 < self.support < 1):
            raise SiddhiAppCreationError("lossyFrequent support/error must be in (0, 1)")
        self.width = max(1, int(1.0 / self.error + 0.9999999))
        # lossy counting keeps O((1/e)·log(eN)) keys; 4/e is ample in practice
        self.cap_keys = max(64, int(4.0 / self.error))
        self.key_attrs = key_attrs
        self.device = torch.device(device)

    def init_state(self):
        c, dev = self.cap_keys, self.device
        return {
            "cols": _zero_cols(self.schema, c, dev),
            "ts": torch.zeros(c, dtype=torch.int64, device=dev),
            "occ": torch.zeros(c, dtype=torch.bool, device=dev),
            "key": torch.zeros(c, dtype=torch.int64, device=dev),
            "cnt": torch.zeros(c, dtype=torch.int64, device=dev),
            "bucket": torch.zeros(c, dtype=torch.int64, device=dev),
            "total": torch.zeros((), dtype=torch.int64, device=dev),
        }

    def apply(self, state, flow: Flow):
        b = flow.batch
        key = _key_col(b.cols, self.schema.attrs, self.key_attrs).expand(b.ts.shape).contiguous()
        if flow.partition is not None:  # every partition's window at once (K42)
            ctx = flow.partition
            return _keyed_flow(partition_lossy_frequent_window_step(
                state, b, key, ctx.slot, flow.now, self.cap_keys, self.width, self.support,
                self.error, ctx.capacity), flow)
        st, out, ovf = lossy_frequent_window_step(state, b, key, flow.now, self.cap_keys,
                                                  self.width, self.support, self.error)
        return st, _out_flow(out, flow, ovf)

    def view(self, state):
        return dict(state["cols"]), state["ts"], state["occ"]
