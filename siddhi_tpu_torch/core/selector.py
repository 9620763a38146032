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

Order-by and offset/limit run as `order_limit` (flat) and
`order_limit_partitioned` (within each partition, placed by (rank, slot)):
K46, a hand-written CUDA kernel on the card (csrc/order_limit.cu) whose
plain PyTorch versions `order_limit_ref` / `order_limit_partitioned_ref` the
wrappers take only for tensors on the CPU; the lanes follow the order by
K11's gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from siddhi_tpu_torch import kernels
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


# ---------------------------------------------------------------------------
# K46: order-by and offset/limit
# ---------------------------------------------------------------------------

# csrc/order_limit.cu's key type codes, and its most keys
_ORDER_CODE = {torch.int32: 0, torch.int64: 1, torch.bool: 2, torch.float32: 3}
_MAX_ORDER_KEYS = 8


_FLT_MIN = torch.finfo(torch.float32).tiny


def _order_cols(valid: torch.Tensor, keys: list, desc: list) -> list:
    """The JAX package's sort keys: a `desc` key negated (a bool one as
    -float32), wrapping; a float key's subnormals as 0.0, since XLA's
    comparisons flush them. An invalid row's keys are 0: the invalid rows,
    never delivered, follow the valid ones in row order."""
    out = []
    for k, d in zip(keys, desc):
        if d:
            k = -k.to(torch.float32) if k.dtype == torch.bool else -k
        if k.dtype == torch.float32:
            k = torch.where(k.abs() < _FLT_MIN, torch.zeros_like(k), k)
        out.append(torch.where(valid, k, torch.zeros_like(k)))
    return out


def _stable_perm(keys: list) -> torch.Tensor:
    """The permutation ordering rows by keys[0], then keys[1], ..., stable
    by row (jnp.lexsort, as stable sorts from the least significant key)."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def order_limit_ref(valid: torch.Tensor, keys: list, desc: list, lo: int, hi: int):
    """Plain version of `order_limit`, the JAX package's `_order_limit`:
    the rows' stable order by (invalid last, key 1, ..., key n, row), then
    the valid rows ranked [lo, hi) kept (the invalid rows in row order).
    Returns (perm [R] int64, or None with no key; the kept mask [R] bool in
    the output order)."""
    perm = None
    if keys:
        perm = _stable_perm([(~valid).to(torch.uint8)] + _order_cols(valid, keys, desc))
        valid = valid[perm]
    v = valid.to(torch.int32)
    rank = torch.cumsum(v, 0, dtype=torch.int32) - v
    return perm, valid & (rank >= lo) & (rank < hi)


def order_limit_partitioned_ref(valid: torch.Tensor, keys: list, desc: list,
                                part: torch.Tensor, p: int, lo: int, hi: int):
    """Plain version of `order_limit_partitioned`: each partition's rows
    (part [R] int64 in [0, p], p for a row of no partition) in
    `order_limit_ref`'s order, placed by (rank within the partition,
    partition) as the JAX package's `_flatten` places a vmapped output; the
    valid rows ranked [lo, hi) within their partition kept."""
    perm = None
    if keys:
        srt = _stable_perm([part, (~valid).to(torch.uint8)] + _order_cols(valid, keys, desc))
        ps = part[srt]
        rank = rank_within(ps, torch.ones_like(ps))
        perm = srt[torch.sort(rank * (p + 1) + ps, stable=True).indices]
        valid, part = valid[perm], part[perm]
    rank = rank_within(part, valid)  # among its partition's valid rows
    return perm, valid & (rank >= lo) & (rank < hi)


def order_limit(valid: torch.Tensor, keys: list, desc: list, lo: int, hi: int):
    """Order a chunk's rows by `keys` (each [R]; `desc` flags) with the
    valid rows first, stable, and keep the valid rows ranked [lo, hi)
    (reference: QuerySelector orderEventChunk/limitEventChunk). Returns
    (perm [R] int, or None with no key; the kept mask in the output order)."""
    if valid.device.type == "cpu":
        return order_limit_ref(valid, keys, desc, lo, hi)
    return _order_launch("order_limit", valid, keys, desc, None, 0, lo, hi)


def order_limit_partitioned(valid: torch.Tensor, keys: list, desc: list, part: torch.Tensor,
                            p: int, lo: int, hi: int):
    """`order_limit` within each partition (part [R] int64 in [0, p]), the
    rows placed by (rank within the partition, partition)."""
    if valid.device.type == "cpu":
        return order_limit_partitioned_ref(valid, keys, desc, part, p, lo, hi)
    return _order_launch("order_limit_partitioned", valid, keys, desc, part.contiguous(), p,
                         lo, hi)


def _order_codes(keys: list, desc: list) -> int:
    """csrc/order_limit.cu's packed key types: key j's type code in bits
    3j..3j+1 and its `desc` flag in bit 3j+2."""
    codes = 0
    for j, (k, d) in enumerate(zip(keys, desc)):
        codes |= (_ORDER_CODE[k.dtype] | (4 if d else 0)) << (3 * j)
    return codes


def _order_launch(name: str, valid, keys, desc, part, p: int, lo: int, hi: int):
    keys = [k.contiguous() for k in keys]
    kernels.require_cuda(name, valid, *keys, *([] if part is None else [part]))
    r = valid.shape[0]
    if valid.dtype != torch.bool or valid.dim() != 1 or any(k.shape != (r,) for k in keys) or (
            part is not None and (part.shape != (r,) or part.dtype != torch.int64)):
        raise ValueError(f"{name}: [{r}] bool rows, [{r}] keys and int64 partitions expected")
    if len(keys) > _MAX_ORDER_KEYS or any(k.dtype not in _ORDER_CODE for k in keys):
        raise ValueError(f"{name}: at most {_MAX_ORDER_KEYS} int32/int64/bool/float32 keys, "
                         f"got {[k.dtype for k in keys]}")
    if r >= 2**30:
        raise ValueError(f"{name}: R={r} out of range")
    if len(desc) < len(keys):
        raise ValueError(f"{name}: {len(keys)} keys but {len(desc)} desc flags")
    dev, nk = valid.device, len(keys)
    hi = min(int(hi), _BIG)
    perm = torch.empty(r, dtype=torch.int32, device=dev)
    kept = torch.empty(r, dtype=torch.bool, device=dev)
    # one workspace, carved by the kernel's own layout (ol_workspace)
    work = torch.empty(kernels.function("ol_workspace")(r, nk, p, int(part is not None)),
                       dtype=torch.uint8, device=dev)
    ptrs = [k.data_ptr() for k in keys] + [None] * (_MAX_ORDER_KEYS - nk)
    kernels.check(kernels.function("ol_order")(
        r, nk, p, int(lo), hi, _order_codes(keys, desc), valid.data_ptr(),
        None if part is None else part.data_ptr(), *ptrs, perm.data_ptr(), kept.data_ptr(),
        work.data_ptr(), kernels.stream()), name)
    kernels.launches[name] += 1
    return (perm if nk else None), kept


def take_lane(lane: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """lane[perm] (K11's gather on the card)."""
    if lane.device.type == "cpu":
        return lane[perm]
    lane = lane.contiguous()
    out = torch.empty(perm.shape[0], dtype=lane.dtype, device=lane.device)
    kernels.check(kernels.function(f"rv_gather_{lane.element_size()}")(
        lane.data_ptr(), perm.data_ptr(), out.data_ptr(), perm.shape[0], kernels.stream()),
        "order_limit gather")
    return out


def _take(batch: EventBatch, perm: torch.Tensor, valid: torch.Tensor) -> EventBatch:
    """The batch's lanes in `perm`'s order, with the kept mask `valid`
    (already in that order)."""
    return EventBatch(ts=take_lane(batch.ts, perm), kind=take_lane(batch.kind, perm),
                      valid=valid, cols={n: take_lane(c, perm) for n, c in batch.cols.items()})


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

    def _order_args(self, env: Env, shape):
        """The order keys [R] with their `desc` flags, and the offset/limit
        as the rank range [lo, hi)."""
        keys = [cexpr(env).expand(shape) for cexpr, _desc in self.order_by]
        desc = [d for _c, d in self.order_by]
        lo = 0 if self.offset is None else int(self.offset)
        hi = _BIG if self.limit is None else lo + int(self.limit)
        return keys, desc, lo, hi

    def _order_limit_partitioned(self, out: EventBatch, env: Env, pslot: torch.Tensor, p: int):
        """Order-by and offset/limit within each partition, as the JAX
        package's vmap runs `_order_limit` once per partition: each
        partition's valid rows first, then its keys in order, stable by row;
        the limit counts each partition's rows; the ordered rows are placed
        by (rank within the partition, slot), `_flatten`'s order (K46).
        Returns (out, slot lane of its rows)."""
        if not self.order_by and self.limit is None and self.offset is None:
            return out, pslot
        part = torch.where(pslot < p, pslot, p).to(torch.int64)
        keys, desc, lo, hi = self._order_args(env, out.valid.shape)
        perm, kept = order_limit_partitioned(out.valid, keys, desc, part, p, lo, hi)
        if perm is None:
            return EventBatch(out.ts, out.kind, kept, out.cols), pslot
        return _take(out, perm, kept), take_lane(pslot, perm)

    def _order_limit(self, out: EventBatch, env: Env) -> EventBatch:
        """Per-chunk order-by + offset/limit (reference: QuerySelector
        orderEventChunk/limitEventChunk): valid rows first, then the keys in
        order, stable by row — the JAX package's lexsort (K46)."""
        if not self.order_by and self.limit is None and self.offset is None:
            return out
        keys, desc, lo, hi = self._order_args(env, out.valid.shape)
        perm, kept = order_limit(out.valid, keys, desc, lo, hi)
        if perm is None:
            return EventBatch(out.ts, out.kind, kept, out.cols)
        return _take(out, perm, kept)
