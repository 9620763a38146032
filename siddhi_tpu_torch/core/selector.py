"""Selector compilation: projection + aggregation.

Reference: query/selector/QuerySelector.java:44-430 — attribute processors over
each event, aggregator state mutation, then output. Here the whole selector is
one vectorized transform over the Flow; aggregator calls inside selection
expressions are lifted out, computed as running columns, and re-injected as
synthetic attributes of a pseudo-stream "__agg__".

Group-by, having, order-by and limit/offset are not ported yet.
"""

from __future__ import annotations

import dataclasses

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
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.query_api.execution import OutputAttribute, Selector
from siddhi_tpu_torch.query_api.expression import AttributeFunction, Expression, Variable

_AGG_REF = "__agg__"


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
    """Stateful selector stage: (state, Flow) -> (state, output EventBatch)."""

    def __init__(
        self,
        selector: Selector,
        scope: Scope,
        input_attrs: list[tuple[str, AttrType]],
        windowed: bool,
    ):
        for clause, present in (
            ("group by", selector.group_by),
            ("having", selector.having is not None),
            ("order by", selector.order_by),
            ("limit", selector.limit is not None),
            ("offset", selector.offset is not None),
        ):
            if present:
                raise SiddhiAppCreationError(f"'{clause}' is not ported yet")
        sel_list = list(selector.selection_list)
        if selector.select_all:
            sel_list = [OutputAttribute(None, Variable(n)) for n, _ in input_attrs]

        # lift aggregator calls out of the selection expressions
        agg_calls: list[AttributeFunction] = []
        lifted = [(oa.name, _lift_aggregators(oa.expression, agg_calls)) for oa in sel_list]
        self.aggregators: list[CompiledAggregator] = []
        agg_types: dict[str, AttrType] = {}
        for i, call in enumerate(agg_calls):
            args = [compile_expression(p, scope) for p in call.parameters]
            agg = build_aggregator(call.name, args, scope.device, windowed)
            self.aggregators.append(agg)
            agg_types[f"a{i}"] = agg.type

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

    def init_state(self):
        return {"aggs": [a.init() for a in self.aggregators]}

    def apply(self, state, flow: Flow):
        env = flow.env()
        info = FlowInfo(
            sign=flow.sign,
            reset=flow.reset,
            birth_pos=flow.birth_pos,
            death_pos=flow.death_pos,
            member_env=flow.member_env,
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
        valid = flow.batch.valid & (
            (flow.batch.kind == KIND_CURRENT) | (flow.batch.kind == KIND_EXPIRED)
        )
        out = EventBatch(ts=flow.batch.ts, kind=flow.batch.kind, valid=valid, cols=out_cols)
        return {"aggs": new_aggs}, out
