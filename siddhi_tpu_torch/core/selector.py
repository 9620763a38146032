"""Selector compilation: projection + aggregation + group-by + having +
order-by/limit/offset.

Reference: query/selector/QuerySelector.java:44-430 — attribute processors over
each event, aggregator state mutation, group-by key via GroupByKeyGenerator,
having filter, order-by/limit (OrderByEventComparator), then output. Here the
whole selector is one vectorized transform over the Flow; aggregator calls
inside selection expressions are lifted out, computed as running columns, and
re-injected as synthetic attributes of a pseudo-stream "__agg__". After a
batch window, the output collapses to one row per flush (and key): the
keep-last kernel (ops/group.py, csrc/keep_last.cu). Inside a partition the
flow's partition context keys the aggregators (one carry a partition, or one
a (partition, group) with a table a partition), and the collapse, the
order-by and the limit run within each partition, as the JAX package's vmap
runs the selector once per partition.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from siddhi_tpu_torch.core.aggregators import CompiledAggregator, FlowInfo, build_aggregator
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import EventBatch, KIND_CURRENT, KIND_EXPIRED
from siddhi_tpu_torch.core.executor import (
    CompiledExpr,
    Env,
    Scope,
    compile_expression,
    is_aggregator,
)
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.groupby import (
    DEFAULT_GROUP_CAPACITY,
    CompiledGroupBy,
    first_of,
    partition_ctx,
    partition_era_ctx,
    partition_eras,
    rank_within,
    slot_first,
)
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.ops.group import keep_last_in_sorted, keep_last_per_group
from siddhi_tpu_torch.query_api.execution import OutputAttribute, OutputEventsFor, Selector
from siddhi_tpu_torch.query_api.expression import AttributeFunction, Expression, Variable

_AGG_REF = "__agg__"
_OUT_REF = "__out__"
_BIG = torch.iinfo(torch.int32).max


def _lift_aggregators(expr: Expression, found: list[AttributeFunction]) -> Expression:
    """Replace aggregator calls with Variables into the __agg__ pseudo-stream."""
    if is_aggregator(expr):
        found.append(expr)
        return Variable(f"a{len(found) - 1}", stream_id=_AGG_REF)
    if dataclasses.is_dataclass(expr):
        kwargs = {}
        changed = False
        for f in dataclasses.fields(expr):
            v = getattr(expr, f.name)
            if isinstance(v, Expression):
                nv = _lift_aggregators(v, found)
                changed |= nv is not v
                kwargs[f.name] = nv
            elif isinstance(v, list) and v and isinstance(v[0], Expression):
                nv = [_lift_aggregators(x, found) for x in v]
                changed |= any(a is not b for a, b in zip(nv, v))
                kwargs[f.name] = nv
            else:
                kwargs[f.name] = v
        if changed:
            return type(expr)(**kwargs)
    return expr


class CompiledSelector:
    """Stateful selector stage: (state, Flow) -> (state, output EventBatch).

    batch_mode: the input is a batch window's flow; `output_events_for_batch`
    (set by the query runtime) gates the ungrouped collapse by kind."""

    def __init__(
        self,
        selector: Selector,
        scope: Scope,
        input_attrs: list[tuple[str, AttrType]],
        batch_mode: bool = False,
        group_capacity: Optional[int] = None,
    ):
        self.batch_mode = batch_mode
        self.output_events_for_batch = OutputEventsFor.CURRENT
        # per-group rate limiters read each output row's group key from an
        # extra "__group_key__" column (not part of the output schema)
        self.emit_group_key = False
        sel_list = list(selector.selection_list)
        if selector.select_all:
            sel_list = [OutputAttribute(None, Variable(n)) for n, _ in input_attrs]

        # group-by (reference: GroupByKeyGenerator over the input meta)
        self.group: Optional[CompiledGroupBy] = None
        if selector.group_by:
            self.group = CompiledGroupBy(
                selector.group_by, scope,
                capacity=DEFAULT_GROUP_CAPACITY if group_capacity is None else group_capacity,
            )

        # lift aggregator calls out of the selection expressions
        agg_calls: list[AttributeFunction] = []
        lifted = [(oa.name, _lift_aggregators(oa.expression, agg_calls)) for oa in sel_list]
        self.aggregators: list[CompiledAggregator] = []
        agg_types: dict[str, AttrType] = {}

        def add_aggregators():
            for i in range(len(self.aggregators), len(agg_calls)):
                call = agg_calls[i]
                args = [compile_expression(p, scope) for p in call.parameters]
                agg = build_aggregator(call.name, args, scope.device, self.group)
                self.aggregators.append(agg)
                agg_types[f"a{i}"] = agg.type

        add_aggregators()
        inner = scope.child()
        inner.add_stream(_AGG_REF, agg_types)
        if inner.default_ref == _AGG_REF:
            inner.default_ref = scope.default_ref

        self.projections: list[tuple[str, CompiledExpr]] = []
        names = set()
        for name, expr in lifted:
            if name in names:
                raise SiddhiAppCreationError(f"duplicate output attribute '{name}'")
            names.add(name)
            self.projections.append((name, compile_expression(expr, inner)))

        self.out_attrs: list[tuple[str, AttrType]] = [
            (n, c.type) for n, c in self.projections
        ]

        # having can reference output attrs (by name) or input attrs
        # (reference: QuerySelector having executor compiled over output meta)
        self.having: Optional[CompiledExpr] = None
        if selector.having is not None:
            hav_scope = inner.child()
            hav_scope.add_stream(_OUT_REF, dict(self.out_attrs))
            hav_scope.default_ref = scope.default_ref
            lifted_h = _lift_aggregators(selector.having, agg_calls)
            if len(agg_calls) > len(self.aggregators):
                add_aggregators()
                inner.add_stream(_AGG_REF, agg_types)  # refresh
            self.having = compile_expression(lifted_h, hav_scope)
            if self.having.type is not AttrType.BOOL:
                raise SiddhiAppCreationError("having must be a boolean expression")

        # order-by: keys resolve against output attrs first, then input streams
        # (reference: OrderByEventComparator over output stream attributes)
        self.order_by: list[tuple[CompiledExpr, bool]] = []
        out_names = dict(self.out_attrs)
        for ob in selector.order_by:
            var = ob.variable
            if var.stream_id is None and var.attribute in out_names:
                out_scope = inner.child()
                out_scope.add_stream(_OUT_REF, out_names)
                cexpr = compile_expression(Variable(var.attribute, stream_id=_OUT_REF), out_scope)
            else:
                cexpr = compile_expression(var, scope)
            if cexpr.type in (AttrType.STRING, AttrType.OBJECT):
                raise SiddhiAppCreationError(
                    "order by on STRING/OBJECT attributes is not supported yet "
                    "(interned ids are not lexicographic)"
                )
            self.order_by.append((cexpr, ob.order.name == "DESC"))
        self.limit = selector.limit
        self.offset = selector.offset

    def init_state(self):
        st = {"aggs": [a.init() for a in self.aggregators]}
        if self.group is not None:
            st["group"] = self.group.init_state()
        return st

    def apply(self, state, flow: Flow):
        env = flow.env()
        reset = flow.reset
        group_state = state.get("group")
        ctx = None
        pctx = flow.partition
        if self.group is not None:
            if pctx is not None:  # one table a partition (K33)
                group_state, ctx = self.group.assign_partitioned(group_state, env,
                                                                 flow.sign != 0, reset, pctx)
            else:
                group_state, ctx = self.group.assign(group_state, env, flow.sign != 0, reset)
            # read off the dispatch path by the query runtime, which logs
            # slot-table exhaustion once
            flow.aux["groupby_overflow"] = ctx.overflow
        elif pctx is not None:
            # aggregators keyed by the partition slot; a batch window's
            # RESET rows end their own partition's carries
            ctx = partition_era_ctx(pctx, reset) if self.batch_mode else pctx
        info = FlowInfo(
            sign=flow.sign,
            active=flow.current,
            reset=reset,
            birth_pos=flow.birth_pos,
            death_pos=flow.death_pos,
            member_env=flow.member_env,
            group=ctx,
        )
        new_aggs = []
        agg_cols: dict = {}
        for i, agg in enumerate(self.aggregators):
            s, col = agg.apply(state["aggs"][i], info, env)
            new_aggs.append(s)
            agg_cols[(_AGG_REF, None, f"a{i}")] = col
        env2 = Env({**env.columns, **agg_cols}, now=flow.now)

        shape = flow.batch.valid.shape
        out_cols = {
            name: cexpr(env2).expand(shape).contiguous() for name, cexpr in self.projections
        }
        kind = flow.batch.kind
        valid = flow.batch.valid & ((kind == KIND_CURRENT) | (kind == KIND_EXPIRED))
        env3 = Env({**env2.columns, **{(_OUT_REF, None, n): c for n, c in out_cols.items()}},
                   now=flow.now)
        if self.having is not None:
            valid = valid & self.having(env3)

        # batch-mode collapse: the last having-passing event of each
        # (kind, bucket, key) survives (reference:
        # QuerySelector.processInBatchGroupBy checks having before
        # groupedEvents.put); ungrouped, only the last allowed-kind event of
        # each flush chunk (processInBatchNoGroupBy)
        if self.batch_mode and self.group is not None:
            valid = keep_last_in_sorted(ctx.groups, kind, valid)
        elif self.batch_mode and self.aggregators:
            # a flush chunk is [prev-bucket EXPIREDs, RESET, bucket
            # CURRENTs]: expireds precede their reset, so they shift one
            # segment forward to land with their flush's currents
            if pctx is None:
                seg = torch.cumsum(reset.to(torch.int32), 0, dtype=torch.int32) + (
                    kind == KIND_EXPIRED).to(torch.int32)
            else:  # the same chunks within each partition
                era = partition_eras(pctx.slot, reset, pctx.capacity)[0]
                rows = kind.shape[0]
                seg = first_of(pctx.slot.to(torch.int64) * (rows + 2) + era
                               + (kind == KIND_EXPIRED).to(torch.int64),
                               pctx.slot < pctx.capacity)
            want = self.output_events_for_batch
            if want is OutputEventsFor.EXPIRED:
                allowed = valid & (kind == KIND_EXPIRED)
            elif want is OutputEventsFor.ALL:
                allowed = valid
            else:  # CURRENT (the reference default)
                allowed = valid & (kind == KIND_CURRENT)
            valid = keep_last_per_group(seg, allowed)

        if self.emit_group_key and ctx is not None:
            # (reference: GroupByKeyGenerator key threading into rate limiters)
            key = ctx.key if ctx.emit_key is None else ctx.emit_key
            out_cols["__group_key__"] = key.expand(shape).contiguous()
        out = EventBatch(ts=flow.batch.ts, kind=kind, valid=valid, cols=out_cols)
        if pctx is None:
            out = self._order_limit(out, env3)
        else:
            out, pslot = self._order_limit_partitioned(out, env3, pctx.slot, pctx.capacity)
            if pslot is not pctx.slot:  # the rows moved: their slot lane with them
                flow.partition = partition_ctx(pslot, slot_first(pslot, pctx.capacity),
                                               pctx.capacity, pctx.overflow)
        new_state = {"aggs": new_aggs}
        if self.group is not None:
            new_state["group"] = group_state
        return new_state, out

    def _order_keys(self, env: Env, shape) -> list:
        keys = []
        for cexpr, desc in self.order_by:
            col = cexpr(env).expand(shape)
            if desc:
                col = -col.to(torch.float32) if col.dtype == torch.bool else -col
            keys.append(col)
        return keys

    def _order_limit_partitioned(self, out: EventBatch, env: Env, pslot: torch.Tensor, p: int):
        """Order-by and offset/limit within each partition, as the JAX
        package's vmap runs `_order_limit` once per partition: each
        partition's valid rows first, then its keys in order, stable by row;
        the limit counts each partition's rows; the ordered rows are placed
        by (rank within the partition, slot), `_flatten`'s order. Returns
        (out, slot lane of its rows)."""
        if not self.order_by and self.limit is None and self.offset is None:
            return out, pslot
        part = torch.where(pslot < p, pslot, p).to(torch.int64)
        if self.order_by:
            perm = torch.arange(part.shape[0], device=part.device)
            for k in reversed([part, (~out.valid).to(torch.uint8)]
                              + self._order_keys(env, out.valid.shape)):
                perm = perm[torch.sort(k[perm], stable=True).indices]
            ps = part[perm]
            rank = rank_within(ps, torch.ones_like(ps))
            place = perm[torch.sort(rank * (p + 1) + ps, stable=True).indices]
            out = EventBatch(ts=out.ts[place], kind=out.kind[place], valid=out.valid[place],
                             cols={n: c[place] for n, c in out.cols.items()})
            pslot = pslot[place]
            part = part[place]
        if self.limit is not None or self.offset is not None:
            rank = rank_within(part, out.valid)  # among its partition's valid rows
            lo = 0 if self.offset is None else int(self.offset)
            hi = _BIG if self.limit is None else lo + int(self.limit)
            out = EventBatch(ts=out.ts, kind=out.kind,
                             valid=out.valid & (rank >= lo) & (rank < hi), cols=out.cols)
        return out, pslot

    def _order_limit(self, out: EventBatch, env: Env) -> EventBatch:
        """Per-chunk order-by + offset/limit (reference: QuerySelector
        orderEventChunk/limitEventChunk): valid rows first, then the keys in
        order, stable by row — the JAX package's lexsort, as stable sorts
        from the least significant key up."""
        if not self.order_by and self.limit is None and self.offset is None:
            return out
        if self.order_by:
            keys = self._order_keys(env, out.valid.shape)
            perm = torch.arange(out.valid.shape[0], device=out.valid.device)
            for k in reversed([(~out.valid).to(torch.uint8)] + keys):
                perm = perm[torch.sort(k[perm], stable=True).indices]
            out = EventBatch(
                ts=out.ts[perm], kind=out.kind[perm], valid=out.valid[perm],
                cols={n: c[perm] for n, c in out.cols.items()},
            )
        if self.limit is not None or self.offset is not None:
            v = out.valid.to(torch.int32)
            rank = torch.cumsum(v, 0, dtype=torch.int32) - v
            lo = 0 if self.offset is None else int(self.offset)
            hi = _BIG if self.limit is None else lo + int(self.limit)
            out = EventBatch(ts=out.ts, kind=out.kind,
                             valid=out.valid & (rank >= lo) & (rank < hi), cols=out.cols)
        return out
