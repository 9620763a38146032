"""Join runtime: two windowed sides probing each other on the device.

Reference: query/input/stream/join/JoinProcessor.java:34-200 — each arriving
event probes the *other* side's window via FindableProcessor.find and builds
joined StateEvents; JoinInputStreamParser.java wires filter ->
preJoinProcessor -> window -> postJoinProcessor per side, with left/right/full
outer null-filling and unidirectional trigger control.

Here each side's probe is one masked [R, W] condition evaluation (stock torch
broadcasting over [R, 1] probe lanes and [1, W] view lanes); the matched
pairs, and the outer-join misses as an extra "null partner" column, are
compacted into a fixed-capacity joined batch by `join_assemble`, a
hand-written CUDA kernel on the card (csrc/join_probe.cu) whose plain
PyTorch version `join_assemble_ref` the wrapper takes only for tensors on the
CPU. The view a probe reads is the other side's ring in insertion order
(`SlidingWindow.view`, csrc/ring_view.cu), the open bucket of a lengthBatch
window, nothing for a windowless side, or a table's live `(cols, ts, valid)`
lanes for a table side (`TableSide`: a passive side that is probed and never
triggers; reference: TableWindowProcessor), or an aggregation's merged
buckets for the join's `per`, masked by its `within`
(core/aggregation.py `AggFindable`, a find a probe step), or a named
window's live view (core/window_runtime.py `NamedWindow`: an active side,
whose emissions drive the join while probes read its shared buffer;
reference: WindowWindowProcessor). Inside a
partition (`CompiledJoin.step_partitioned`) every state leaf has a leading
[P] axis: each probe row meets its own slot's view (csrc/partition_join.cu
K38 for a sliding ring), and the keyed compaction K39 keeps each slot's
first `join_capacity` matches, placed by (position within the slot, slot).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.aggregators import _null_bits
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import (
    EventBatch,
    KIND_CURRENT,
    KIND_EXPIRED,
    KIND_TIMER,
    StreamSchema,
)
from siddhi_tpu_torch.core.executor import Env, Scope, TS_ATTR, compile_expression
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.query_runtime import BaseQueryRuntime, _FlagWatch
from siddhi_tpu_torch.core.selector import CompiledSelector
from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE, AttrType, null_value
from siddhi_tpu_torch.core.windows import WindowStage, make_window
from siddhi_tpu_torch.observability.lineage import LIN, JoinQueryLineage
from siddhi_tpu_torch.query_api.execution import (
    Filter,
    JoinEventTrigger,
    JoinInputStream,
    JoinType,
    OutputEventsFor,
    Query,
    SingleInputStream,
    StreamFunctionHandler,
    WindowHandler,
)

DEFAULT_JOIN_CAPACITY = 512


# ---------------------------------------------------------------------------
# K12: the probe compaction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JoinRows:
    """The joined batch's lanes: probe lanes gathered by each slot's probe
    row, partner lanes by its view slot (null-filled for a missed partner),
    and whether the matches overflowed the capacity (0-d bool). Inside a
    partition (K39) also each row's partition slot `slot` [rows] int32 (P
    past the rows) and its slot's first row `first` [rows] int32, and
    `overflow` is set when some slot overflowed."""

    ts: torch.Tensor
    kind: torch.Tensor
    valid: torch.Tensor
    probe_cols: dict
    partner_cols: dict
    partner_ts: torch.Tensor
    overflow: torch.Tensor
    slot: Optional[torch.Tensor] = None
    first: Optional[torch.Tensor] = None
    # each slot's probe row (0 for padding) and partner view slot (W: a
    # null partner or padding), kept for join lineage
    pi: Optional[torch.Tensor] = None
    pj: Optional[torch.Tensor] = None


def join_assemble_ref(pair, row_mask, outer: bool, cap: int, row_ts, row_kind, row_cols: dict,
                      vts, vcols: dict, partner_types: dict) -> JoinRows:
    """Plain version of `join_assemble`, in the JAX package's formulation
    (CompiledJoin._assemble): the miss column appended, a cumsum rank over
    the flattened mask, the matched cell indices scattered into `cap` slots
    (the rest into a dump slot), then the gathers."""
    dev = pair.device
    w = pair.shape[1]
    if outer:
        missed = row_mask & ~pair.any(dim=1)
        pair = torch.cat([pair, missed[:, None]], dim=1)
    wj = pair.shape[1]
    flat = pair.reshape(-1)
    fi = flat.to(torch.int64)
    n = fi.sum()
    rank = torch.cumsum(fi, 0) - fi
    pos = torch.where(flat & (rank < cap), rank, cap)
    idx = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    idx[pos] = torch.arange(flat.shape[0], device=dev)
    idx = idx[:cap]
    valid = idx >= 0
    pi = torch.div(idx, wj, rounding_mode="floor").clamp(0, pair.shape[0] - 1)
    pj_raw = torch.where(valid, idx % wj, w)
    null = pj_raw >= w
    pj = pj_raw.clamp(0, w - 1)

    def partner(lane, t):
        fill = torch.tensor(null_value(t), dtype=lane.dtype, device=dev)
        return torch.where(null, fill, lane[pj])

    return JoinRows(
        ts=row_ts[pi], kind=row_kind[pi], valid=valid,
        probe_cols={nm: c[pi] for nm, c in row_cols.items()},
        partner_cols={nm: partner(vcols[nm], t) for nm, t in partner_types.items()},
        partner_ts=torch.where(null, torch.zeros((), dtype=torch.int64, device=dev), vts[pj]),
        overflow=n > cap,
        pi=pi.to(torch.int32), pj=pj_raw.to(torch.int32),
    )


def join_assemble(pair, row_mask, outer: bool, cap: int, row_ts, row_kind, row_cols: dict,
                  vts, vcols: dict, partner_types: dict) -> JoinRows:
    """Compact a join step's matched (probe row, view slot) pairs into `cap`
    output slots in row-major order — the reference's per-arrival,
    window-order emission — with, for an outer join, one null-partner row for
    each probe row in `row_mask` that matched nothing.

    pair: [R, W] bool; row_mask: [R] bool probe rows; row_ts/row_kind and
    row_cols: [R] probe lanes; vts/vcols: [W] view lanes; partner_types:
    {name: AttrType} of the view's columns (for the null fill). Slots past
    the match count are padding: valid False, probe row 0, null partner.
    """
    if pair.device.type == "cpu":
        return join_assemble_ref(pair, row_mask, outer, cap, row_ts, row_kind, row_cols, vts,
                                 vcols, partner_types)
    pair = pair.contiguous()
    kernels.require_cuda("join_assemble", pair, row_mask, row_ts, row_kind,
                         *row_cols.values(), vts, *vcols.values())
    r, w = pair.shape
    if pair.dtype != torch.bool or row_mask.shape != (r,) or vts.shape != (w,) or any(
            c.shape != (r,) for c in (row_ts, row_kind, *row_cols.values())) or any(
            c.shape != (w,) for c in vcols.values()):
        raise ValueError(f"join_assemble: a [{r}, {w}] bool mask, [{r}] probe and [{w}] view "
                         "lanes expected")
    if cap < 1 or r * (w + 1) >= 2**31:
        raise ValueError(f"join_assemble: capacity {cap} / mask [{r}, {w}] out of range")
    dev = pair.device

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    row_cnt, row_off, n_total = i32(r), i32(r), i32(())
    pi, pj = i32(cap), i32(cap)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    stream = kernels.stream()
    kernels.check(kernels.function("jp_compact")(
        pair.data_ptr(), row_mask.data_ptr(), r, w, int(outer), cap, row_cnt.data_ptr(),
        row_off.data_ptr(), n_total.data_ptr(), overflow.data_ptr(), pi.data_ptr(),
        pj.data_ptr(), valid.data_ptr(), stream), "join_assemble")

    def rows(lane):
        out = torch.empty(cap, dtype=lane.dtype, device=dev)
        kernels.check(kernels.function(f"rv_gather_{lane.element_size()}")(
            lane.data_ptr(), pi.data_ptr(), out.data_ptr(), cap, stream), "join_assemble")
        return out

    def partner(lane, bits):
        out = torch.empty(cap, dtype=lane.dtype, device=dev)
        kernels.check(kernels.function(f"jp_partner_{lane.element_size()}")(
            lane.data_ptr(), pj.data_ptr(), bits, out.data_ptr(), cap, w, stream),
            "join_assemble")
        return out

    out = JoinRows(
        ts=rows(row_ts), kind=rows(row_kind), valid=valid,
        probe_cols={nm: rows(c) for nm, c in row_cols.items()},
        partner_cols={nm: partner(vcols[nm], _null_bits(t)) for nm, t in partner_types.items()},
        partner_ts=partner(vts, 0),
        overflow=overflow,
        pi=pi, pj=pj,
    )
    kernels.launches["join_assemble"] += 1
    return out


def join_partner_seq(res: JoinRows, vseq: Optional[torch.Tensor], w: int) -> torch.Tensor:
    """Join lineage's partner lane (JAX CompiledJoin._assemble's
    `j_pseq`): each valid row's partner admission seq, -1 for a null
    partner and for padding, -2 for a matched partner whose window keeps no
    admission order (vseq None). On the card the seq lane is gathered by
    pj with K12's partner gather, whose null fill is the -1."""
    real = res.valid & (res.pj < w)
    if vseq is None:
        return -1 - real.to(torch.int64)
    if vseq.device.type == "cpu":
        return torch.where(real, vseq[res.pj.clamp(max=w - 1).long()], -1)
    kernels.require_cuda("join_partner_seq", vseq, res.pj)
    cap = res.pj.shape[0]
    out = torch.empty(cap, dtype=torch.int64, device=vseq.device)
    kernels.check(kernels.function("jp_partner_8")(
        vseq.data_ptr(), res.pj.data_ptr(), -1, out.data_ptr(), cap, w, kernels.stream()),
        "join_partner_seq")
    return out


# ---------------------------------------------------------------------------
# join sides
# ---------------------------------------------------------------------------


class _SlotViewCols(dict):
    """Env columns of a keyed probe: a view lane [P, W] is gathered to
    [R, W] by each probe row's slot when the condition first reads it."""

    def __init__(self, view: dict, at: torch.Tensor):
        super().__init__()
        self._view = view
        self._at = at

    def __missing__(self, key):
        lane = self._view[key]
        self[key] = v = lane[self._at]
        return v


class NoWindow(WindowStage):
    """A join side with no #window: arrivals probe but are never retained
    (reference: JoinInputStreamParser wraps windowless sides in a zero-length
    LengthWindowProcessor, JoinInputStreamParser.java:128-146)."""

    def __init__(self, schema: StreamSchema, ref: str, device):
        self.schema = schema
        self.ref = ref
        self.device = torch.device(device)

    def init_state(self):
        return {}

    def apply(self, state, flow: Flow):
        b = flow.batch
        empty = EventBatch(b.ts, b.kind, torch.zeros_like(b.valid), b.cols)
        return state, dataclasses.replace(flow, batch=empty)

    def view(self, state):
        dev = self.device
        cols = {n: torch.zeros(1, dtype=PHYSICAL_DTYPE[t], device=dev)
                for n, t in self.schema.attrs}
        return (cols, torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.bool, device=dev))

    def view_seq(self, state):
        return torch.full((1,), -1, dtype=torch.int64, device=self.device)


class _TableView(WindowStage):
    """A table side's stand-in window: arrivals never re-buffer, and the
    view is the table's live state."""

    def __init__(self, table):
        self.table = table

    def init_state(self):
        return {}

    def apply(self, state, flow: Flow):
        return state, flow

    def view(self, state):
        return self.table.view(self.table.state)


class TableSide:
    """A join side backed by a shared findable: a table (reference:
    TableWindowProcessor — probe-only, it never triggers) or a named window
    (reference: WindowWindowProcessor — its emission stream drives the join
    while probes read the shared buffer; its arrivals never re-buffer)."""

    is_table = True

    def __init__(self, stream: SingleInputStream, table):
        if stream.handlers:
            raise SiddhiAppCreationError(
                f"'{stream.stream_id}' cannot carry filters/windows on a join side")
        self.stream_id = stream.stream_id
        self.ref = stream.ref
        self.schema = table.schema
        self.table = table
        self.window = _TableView(table)
        # tables are passive probe targets; named windows also trigger
        self.passive = not getattr(table, "is_named_window", False)

    def filter_batch(self, batch: EventBatch, now) -> EventBatch:
        return batch


class JoinSide:
    """One side of the join: pre-window filters and at most one window."""

    is_table = False
    passive = False

    def __init__(self, stream: SingleInputStream, schema: StreamSchema, scope: Scope):
        self.stream_id = stream.stream_id
        self.ref = stream.ref
        self.schema = schema
        side_scope = scope.child()
        side_scope.default_ref = self.ref
        self.pre_filters = []
        self.window: Optional[WindowStage] = None
        for h in stream.handlers:
            if isinstance(h, Filter):
                if self.window is not None:
                    raise SiddhiAppCreationError(
                        "filters after the window are not supported on join sides")
                cond = compile_expression(h.expression, side_scope)
                if cond.type is not AttrType.BOOL:
                    raise SiddhiAppCreationError("filter must be a boolean expression")
                self.pre_filters.append(cond)
            elif isinstance(h, WindowHandler):
                if self.window is not None:
                    raise SiddhiAppCreationError("only one window per join side")
                self.window = make_window(h.window, schema, self.ref, side_scope)
            elif isinstance(h, StreamFunctionHandler):
                raise SiddhiAppCreationError(
                    f"stream function '{h.name}' not supported on join sides yet")
        if self.window is None:
            self.window = NoWindow(schema, self.ref, scope.device)

    def filter_batch(self, batch: EventBatch, now) -> EventBatch:
        if not self.pre_filters:
            return batch
        cols = {(self.ref, None, n): c for n, c in batch.cols.items()}
        cols[(self.ref, None, TS_ATTR)] = batch.ts
        env = Env(cols, now=now)
        mask = None
        for c in self.pre_filters:
            m = c(env)
            mask = m if mask is None else (mask & m)
        is_timer = batch.kind == KIND_TIMER  # timers bypass filters
        return EventBatch(batch.ts, batch.kind, batch.valid & (is_timer | mask), batch.cols)


class CompiledJoin:
    """The join's device step per arriving side, producing a joined batch
    whose columns carry both refs (left primary, right in extra columns)."""

    def __init__(self, join: JoinInputStream, left_schema: StreamSchema,
                 right_schema: StreamSchema, scope: Scope,
                 out_capacity: int = DEFAULT_JOIN_CAPACITY, output_expired: bool = False,
                 tables: Optional[dict] = None):
        tables = tables or {}

        def make_side(stream, schema):
            # a table or an aggregation's merged buckets (core/aggregation.py
            # AggFindable): probed, never driven
            t = tables.get(stream.stream_id)
            return TableSide(stream, t) if t is not None else JoinSide(stream, schema, scope)

        self.left = make_side(join.left, left_schema)
        self.right = make_side(join.right, right_schema)
        if self.left.passive and self.right.passive:
            raise SiddhiAppCreationError("cannot join two tables; use a store query")
        if self.left.ref == self.right.ref:
            raise SiddhiAppCreationError(
                f"join sides must have distinct references; alias one: "
                f"'from {self.left.stream_id} as a join ...'")
        self.join_type = join.join_type
        self.out_capacity = int(out_capacity)
        if self.out_capacity < 1:
            raise SiddhiAppCreationError("@app:joinCapacity must be >= 1")
        self.output_expired = output_expired
        # unidirectional narrows the trigger side
        # (reference: JoinInputStreamParser.java:214-231)
        trigger = join.trigger
        for side, js in (("left", self.left), ("right", self.right)):
            if join.unidirectional == side and js.passive:
                raise SiddhiAppCreationError(
                    "unidirectional cannot be set on the table side of a join")
        if join.unidirectional == "left":
            trigger = JoinEventTrigger.LEFT
        elif join.unidirectional == "right":
            trigger = JoinEventTrigger.RIGHT
        self.emit_left = (trigger in (JoinEventTrigger.ALL, JoinEventTrigger.LEFT)
                          and not self.left.passive)
        self.emit_right = (trigger in (JoinEventTrigger.ALL, JoinEventTrigger.RIGHT)
                           and not self.right.passive)
        self.on = None
        if join.on is not None:
            cond = compile_expression(join.on, scope)
            if cond.type is not AttrType.BOOL:
                raise SiddhiAppCreationError("join 'on' must be a boolean expression")
            self.on = cond
        self.device = scope.device
        # lineage (observability/lineage.py): when set, each step also adds
        # `__lin.*` lanes to its aux — the arriving side's admissions and,
        # per joined row, its probe row and its partner's window seq
        self.lineage = False

    def init_state(self):
        return {"l": self.left.window.init_state(), "r": self.right.window.init_state()}

    def step(self, state, batch: EventBatch, now, side: str):
        """side: 'l' | 'r'. Returns (state', joined Flow, aux)."""
        arr = self.left if side == "l" else self.right
        other = self.right if side == "l" else self.left
        other_key = "r" if side == "l" else "l"
        emits = self.emit_left if side == "l" else self.emit_right
        batch = arr.filter_batch(batch, now)
        aux: dict = {}
        vseq = None
        if self.lineage:
            # the arriving side's window admissions: its filter-passing
            # CURRENT rows (a table or named-window side never re-buffers)
            aux[LIN + "admit"] = (batch.valid & (batch.kind == KIND_CURRENT) if not arr.is_table
                                  else torch.zeros_like(batch.valid))
            vcols, vts, vmask, vseq = other.window.view_with_seq(state[other_key])
        else:
            vcols, vts, vmask = other.window.view(state[other_key])

        # probe 1: arriving CURRENT rows against the other window (reference:
        # preJoinProcessor — the probe happens BEFORE the own-window insert)
        cur_rows = batch.valid & (batch.kind == KIND_CURRENT)
        wstate, wflow = arr.window.apply(state[side], Flow(batch=batch, ref=arr.ref, now=now))
        if "next_timer" in wflow.aux:
            aux["next_timer"] = wflow.aux["next_timer"]
        probes = []
        if emits:
            probes.append((batch, cur_rows, KIND_CURRENT))
            if self.output_expired:
                exp = wflow.batch
                probes.append((exp, exp.valid & (exp.kind == KIND_EXPIRED), KIND_EXPIRED))
        joined = self._assemble(probes, arr, other, vcols, vts, vmask, now, side, aux, vseq)
        new_state = dict(state)
        new_state[side] = wstate
        return new_state, joined, aux

    def step_partitioned(self, state, batch: EventBatch, now, side: str, ctx):
        """The step inside a partition (siddhi_tpu/core/partition.py
        `_pstep_impl`'s vmap of `step` over P partitions, keyed): state
        leaves carry a leading [P] axis, `ctx` (a `partition_ctx`) gives
        each row's slot. The other side's view is read before the arriving
        side's own insert, as in `step`; the arriving window steps every
        slot at once (K29/K31/K32/K40/K41); a slot's probe set is its
        CURRENT rows in batch order, then its window's EXPIRED rows in the
        slot's output order, each against its own slot's view. Returns
        (state', joined Flow with the rows' partition context, aux)."""
        arr = self.left if side == "l" else self.right
        other = self.right if side == "l" else self.left
        other_key = "r" if side == "l" else "l"
        emits = self.emit_left if side == "l" else self.emit_right
        batch = arr.filter_batch(batch, now)
        aux: dict = {}
        vcols, vts, vmask = self._keyed_view(other, state[other_key], ctx.capacity)
        cur_rows = batch.valid & (batch.kind == KIND_CURRENT)
        wstate, wflow = arr.window.apply(state[side], Flow(batch=batch, ref=arr.ref, now=now,
                                                           partition=ctx))
        probes = []
        if emits:
            probes.append((batch, cur_rows, KIND_CURRENT, ctx.slot))
            if self.output_expired:
                exp = wflow.batch
                probes.append((exp, exp.valid & (exp.kind == KIND_EXPIRED), KIND_EXPIRED,
                               wflow.partition.slot))
        joined = self._assemble_partitioned(probes, arr, other, vcols, vts, vmask, now, side,
                                            aux, ctx)
        new_state = dict(state)
        new_state[side] = wstate
        return new_state, joined, aux

    def _keyed_view(self, js, state, p: int):
        """Every partition's view of a side: [P, W] lanes by slot."""
        if isinstance(js.window, NoWindow):
            dev = self.device
            cols = {n: torch.zeros((p, 1), dtype=PHYSICAL_DTYPE[t], device=dev)
                    for n, t in js.schema.attrs}
            return (cols, torch.zeros((p, 1), dtype=torch.int64, device=dev),
                    torch.zeros((p, 1), dtype=torch.bool, device=dev))
        return js.window.view(state)

    def _outer(self, side: str) -> bool:
        return (self.join_type is JoinType.FULL_OUTER
                or (side == "l" and self.join_type is JoinType.LEFT_OUTER)
                or (side == "r" and self.join_type is JoinType.RIGHT_OUTER))

    def _probe_lanes(self, probes, arr, p: Optional[int] = None):
        """The probe sets' lanes end to end: (ts, mask, kind, cols, slot).
        A probe is (batch, row mask, kind) or, keyed (`p` given), (batch,
        row mask, kind, each row's slot); slot is None unkeyed. A side that
        does not trigger has an empty probe set: one masked row (slot P)."""
        dev = self.device
        if probes:
            row_ts = torch.cat([pr[0].ts for pr in probes])
            row_mask = torch.cat([pr[1] for pr in probes])
            row_kind = torch.cat([torch.full(pr[1].shape, pr[2], dtype=torch.int8, device=dev)
                                  for pr in probes])
            row_cols = {n: torch.cat([pr[0].cols[n] for pr in probes]) for n in probes[0][0].cols}
            row_slot = None if p is None else torch.cat([pr[3].to(torch.int32) for pr in probes])
        else:
            row_ts = torch.zeros(1, dtype=torch.int64, device=dev)
            row_mask = torch.zeros(1, dtype=torch.bool, device=dev)
            row_kind = torch.zeros(1, dtype=torch.int8, device=dev)
            row_cols = {n: torch.zeros(1, dtype=PHYSICAL_DTYPE[t], device=dev)
                        for n, t in arr.schema.attrs}
            row_slot = None if p is None else torch.full((1,), p, dtype=torch.int32, device=dev)
        return row_ts, row_mask, row_kind, row_cols, row_slot

    def _assemble_partitioned(self, probes, arr, other, vcols, vts, vmask, now, side, aux,
                              ctx) -> Flow:
        """`_assemble` keyed by slot: each probe row's on-condition over its
        own slot's view lanes ([R, W] gathered by slot), then the keyed
        compaction (K39), the rows by (position, slot)."""
        from siddhi_tpu_torch.core.groupby import partition_ctx
        from siddhi_tpu_torch.ops.partition import partition_join_assemble

        p = ctx.capacity
        row_ts, row_mask, row_kind, row_cols, row_slot = self._probe_lanes(probes, arr, p)
        at = row_slot.to(torch.int64).clamp(0, p - 1)
        view = {(other.ref, None, n): c for n, c in vcols.items()}
        view[(other.ref, None, TS_ATTR)] = vts
        env_cols = _SlotViewCols(view, at)
        env_cols.update({(arr.ref, None, n): c[:, None] for n, c in row_cols.items()})
        env_cols[(arr.ref, None, TS_ATTR)] = row_ts[:, None]
        pair = row_mask[:, None] & vmask[at]
        if self.on is not None:
            pair = pair & self.on(Env(env_cols, now=now))
        res = partition_join_assemble(pair, row_mask, row_slot, self._outer(side),
                                      self.out_capacity, p, row_ts, row_kind, row_cols, vts,
                                      vcols, other.schema.attr_types)
        aux["join_overflow"] = res.overflow
        flow = self._joined_flow(res, side, now, aux)
        flow.partition = partition_ctx(res.slot, res.first, p, ctx.overflow)
        return flow

    def _joined_flow(self, res, side: str, now, aux) -> Flow:
        # the primary batch always carries the LEFT side's columns, so the
        # selector's layout is stable; only the per-ref timestamps depend on
        # the arriving side
        if side == "l":
            left_cols, right_cols = res.probe_cols, res.partner_cols
            left_ts, right_ts = res.ts, res.partner_ts
        else:
            left_cols, right_cols = res.partner_cols, res.probe_cols
            left_ts, right_ts = res.partner_ts, res.ts
        batch = EventBatch(res.ts, res.kind, res.valid, left_cols)
        extra = {(self.right.ref, None, n): c for n, c in right_cols.items()}
        extra[(self.right.ref, None, TS_ATTR)] = right_ts
        extra[(self.left.ref, None, TS_ATTR)] = left_ts
        return Flow(batch=batch, ref=self.left.ref, now=now, extra_cols=extra, aux=aux)

    def _assemble(self, probes, arr, other, vcols, vts, vmask, now, side, aux,
                  vseq=None) -> Flow:
        """Evaluate the on-condition for every probe set and compact the
        matched pairs (plus outer misses) into one fixed-capacity Flow."""
        outer = self._outer(side)
        row_ts, row_mask, row_kind, row_cols, _ = self._probe_lanes(probes, arr)
        env_cols = {(arr.ref, None, n): c[:, None] for n, c in row_cols.items()}
        env_cols[(arr.ref, None, TS_ATTR)] = row_ts[:, None]
        env_cols.update({(other.ref, None, n): c[None, :] for n, c in vcols.items()})
        env_cols[(other.ref, None, TS_ATTR)] = vts[None, :]
        pair = row_mask[:, None] & vmask[None, :]
        if self.on is not None:
            pair = pair & self.on(Env(env_cols, now=now))
        res = join_assemble(pair, row_mask, outer, self.out_capacity, row_ts, row_kind, row_cols,
                            vts, vcols, other.schema.attr_types)
        aux["join_overflow"] = res.overflow
        if self.lineage:
            # per joined row: the probe row (-1 for padding) and the
            # partner's window seq — the recorder's (left seq, right seq)
            aux[LIN + "j_pi"] = torch.where(res.valid, res.pi, -1).to(torch.int32)
            aux[LIN + "j_pseq"] = join_partner_seq(res, vseq, vmask.shape[0])
        return self._joined_flow(res, side, now, aux)


class JoinQueryRuntime(BaseQueryRuntime):
    """A compiled join query, its device state and the host routing
    (reference: JoinStreamRuntime + QueryRuntime)."""

    def __init__(self, query: Query, query_id: str, left_schema: StreamSchema,
                 right_schema: StreamSchema, interner, device,
                 group_capacity: Optional[int] = None,
                 join_capacity: int = DEFAULT_JOIN_CAPACITY, tables: Optional[dict] = None,
                 findables: Optional[dict] = None):
        join = query.input_stream
        assert isinstance(join, JoinInputStream)
        self.query = query
        self.query_id = query_id
        self.device = torch.device(device)
        scope = Scope(interner, self.device)
        lref, rref = join.left.ref, join.right.ref
        scope.add_stream(lref, left_schema.attr_types)
        scope.add_stream(rref, right_schema.attr_types)
        scope.default_ref = lref
        for t in (tables or {}).values():
            scope.add_table(t)
        self._scope = scope
        output_expired = query.output_stream.output_events is not OutputEventsFor.CURRENT
        self.join = CompiledJoin(join, left_schema, right_schema, scope,
                                 out_capacity=join_capacity, output_expired=output_expired,
                                 tables=tables if findables is None else findables)
        combined_attrs = list(left_schema.attrs) + list(right_schema.attrs)
        self.selector = CompiledSelector(query.selector, scope, combined_attrs,
                                         group_capacity=group_capacity)
        self._setup_output(query, query_id)
        self._attach_tables(tables, interner)
        self._join_overflow = _FlagWatch(self.device, self._log_join_overflow)
        # the sides whose window needs timers; a findable side has no junction
        self.scheduled_sides = tuple(
            side for side, js in (("l", self.join.left), ("r", self.join.right))
            if not js.passive and js.window.needs_scheduler)
        # findable sides have no junction of their own; a named-window side
        # is driven by the window's emission junction instead
        self.table_sides = {"l": self.join.left.is_table, "r": self.join.right.is_table}
        self.window_sides = {
            side: js.table if js.is_table and not js.passive else None
            for side, js in (("l", self.join.left), ("r", self.join.right))}
        self.uses_scheduler = bool(self.scheduled_sides)
        self.side_schemas = {"l": left_schema, "r": right_schema}

    def init_state(self):
        return {"join": self.join.init_state(), "sel": self.selector.init_state()}

    def arm_lineage(self, cfg) -> None:
        """Record provenance (@app:lineage): each step's lanes — (probe
        row, partner window seq) per joined row — feed a JoinQueryLineage.
        Emissions are untouched."""
        self.join.lineage = True
        self.lineage = JoinQueryLineage(
            cfg, self.query_id, self._published_kinds(),
            left_stream=self.join.left.stream_id, right_stream=self.join.right.stream_id)

    def _step_impl(self, state, batch: EventBatch, now: torch.Tensor, side: str):
        jstate, flow, aux = self.join.step(state["join"], batch, now, side)
        if self.lineage is not None:
            # the join's lanes leave the aux (the joined flow's) before the
            # selector and the flag reads see it
            lanes = {k: aux.pop(k) for k in list(aux) if k.startswith(LIN)}
        sel_state, out = self.selector.apply(state["sel"], flow)
        self._apply_table_op(out, now, aux)
        self._note_aux(aux)
        self._join_overflow.note(aux["join_overflow"])
        self._join_overflow.poll()
        if self.lineage is not None:
            lanes[LIN + "in"] = batch.valid & (batch.kind == KIND_CURRENT)
            lanes[LIN + "in_ts"] = batch.ts
            lanes[LIN + "out_valid"] = out.valid
            lanes[LIN + "out_kind"] = out.kind
            lanes[LIN + "out_ts"] = out.ts
            self._lin_sink.append((side, lanes))
        return {"join": jstate, "sel": sel_state}, out

    def receive(self, batch: EventBatch, now: int, side: str) -> EventBatch:
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state()
            now_t = torch.full((), now, dtype=torch.int64, device=self.device)
            self.state, out = self._step_impl(self.state, batch, now_t, side)
            if self.lineage is not None:
                self._lin_flush(now)  # under the receive lock: dispatch order
        return out

    def _log_join_overflow(self) -> None:
        logging.getLogger(__name__).warning(
            "query '%s': join output overflowed its capacity; matches were "
            "dropped — raise it with @app:joinCapacity(size='N')", self.query_id)

    def flush_aux_warnings(self) -> None:
        super().flush_aux_warnings()
        self._join_overflow.flush()
