"""Per-query compilation and runtime container.

Reference: query/QueryRuntime.java:45-200 wires receiver -> processor chain ->
selector -> rate limiter -> callback as runtime objects. Here the chain is
compiled once into a step `(state, in_batch, now) -> (state', out_batch)` that
launches device work; the runtime object owns the device state and the
host-side output routing.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import (
    EventBatch,
    KIND_CURRENT,
    KIND_EXPIRED,
    KIND_TIMER,
    StreamSchema,
)
from siddhi_tpu_torch.core.executor import Scope, compile_expression
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.selector import CompiledSelector
from siddhi_tpu_torch.core.types import AttrType, InternTable
from siddhi_tpu_torch.core.windows import make_window
from siddhi_tpu_torch.query_api.execution import (
    Filter,
    InsertIntoStream,
    OutputEventsFor,
    Query,
    SingleInputStream,
    WindowHandler,
)


class CompiledSingleChain:
    """Ordered filter / window stages over one input stream
    (reference: SingleInputStreamParser.generateProcessor chain assembly)."""

    def __init__(self, stream: SingleInputStream, schema: StreamSchema, scope: Scope):
        self.schema = schema
        self.ref = stream.alias or stream.stream_id
        self.window = None
        self.stages: list[tuple[str, object]] = []
        for h in stream.handlers:
            if isinstance(h, Filter):
                cond = compile_expression(h.expression, scope)
                if cond.type is not AttrType.BOOL:
                    raise SiddhiAppCreationError("filter must be a boolean expression")
                self.stages.append(("filter", cond))
            elif isinstance(h, WindowHandler):
                if self.window is not None:
                    raise SiddhiAppCreationError("only one window per stream")
                self.window = make_window(h.window, schema, self.ref, scope.device)
                self.stages.append(("window", self.window))
            else:
                raise SiddhiAppCreationError(
                    f"stream handler {type(h).__name__} is not ported yet"
                )
        self.out_attrs: list[tuple[str, AttrType]] = list(schema.attrs)

    def init_state(self):
        return self.window.init_state() if self.window is not None else ()

    def apply(self, state, flow: Flow):
        for kind, stage in self.stages:
            if kind == "filter":
                flow = self._filter(flow, stage)
            else:  # window
                state, flow = stage.apply(state, flow)
        return state, flow

    @staticmethod
    def _filter(flow: Flow, cond) -> Flow:
        mask = cond(flow.env())
        is_timer = flow.batch.kind == KIND_TIMER  # timers bypass filters
        valid = flow.batch.valid & (is_timer | mask)
        batch = dataclasses.replace(flow.batch, valid=valid)
        return dataclasses.replace(flow, batch=batch)


class QueryRuntime:
    """Compiled query + device state + host output routing."""

    def __init__(
        self,
        query: Query,
        query_id: str,
        in_schema: StreamSchema,
        interner: InternTable,
        device,
    ):
        self.query = query
        self.query_id = query_id
        self.in_schema = in_schema
        self.device = torch.device(device)
        stream = query.input_stream
        self.ref = stream.alias or stream.stream_id

        scope = Scope(interner, self.device)
        scope.add_stream(self.ref, in_schema.attr_types)
        if self.ref != in_schema.stream_id:
            scope.add_stream(in_schema.stream_id, in_schema.attr_types)
        scope.default_ref = self.ref
        self._scope = scope

        self.chain = CompiledSingleChain(stream, in_schema, scope)
        self.selector = CompiledSelector(
            query.selector,
            scope,
            self.chain.out_attrs,
            windowed=self.chain.window is not None,
        )
        if query.output_rate is not None:
            raise SiddhiAppCreationError("output rate limiting is not ported yet")
        out = query.output_stream
        target = out.target if isinstance(out, InsertIntoStream) else f"__ret_{query_id}"
        self.out_schema = StreamSchema(target, self.selector.out_attrs)
        self.output_events = out.output_events
        self.query_callbacks: list[Callable] = []
        # the user callbacks behind query_callbacks, one to one: the fused
        # drain builds Event lists once and calls them directly
        self.raw_query_callbacks: list[Callable] = []
        self.publish_fn: Optional[Callable] = None
        self.insert_target_junction = None
        self._receive_lock = threading.RLock()
        self.state = None

    def init_state(self):
        return {"chain": self.chain.init_state(), "sel": self.selector.init_state()}

    @property
    def used_attrs(self):
        """Input attribute names this query can ever read (from the compile
        scope's resolved keys), or None for everything (select *). Fused
        ingest drops the other columns from the wire."""
        if self.query.selector.select_all:
            return None
        return {k[2] for k in self._scope.used_keys}

    # ---- device program --------------------------------------------------

    def _step_impl(self, state, batch: EventBatch, now: torch.Tensor):
        flow = Flow(batch=batch, ref=self.ref, now=now)
        chain_state, flow = self.chain.apply(state["chain"], flow)
        sel_state, out = self.selector.apply(state["sel"], flow)
        return {"chain": chain_state, "sel": sel_state}, out

    # ---- host side -------------------------------------------------------

    def receive(self, batch: EventBatch, now: int) -> EventBatch:
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state()
            now_t = torch.full((), now, dtype=torch.int64, device=self.device)
            self.state, out = self._step_impl(self.state, batch, now_t)
        return out

    def route_output(self, out: EventBatch, now: int, decode) -> None:
        """Dispatch a step's output to query callbacks / downstream junction.

        `decode` = app-runtime host decoder (batch -> event triples).
        """
        if self.query_callbacks:
            events = decode(self.out_schema, out)
            if events:
                want = self.output_events
                ins = [] if want is OutputEventsFor.EXPIRED else [
                    e for e in events if e[1] == KIND_CURRENT
                ]
                removed = [] if want is OutputEventsFor.CURRENT else [
                    e for e in events if e[1] == KIND_EXPIRED
                ]
                if ins or removed:
                    ts = events[-1][0]
                    for cb in self.query_callbacks:
                        cb(ts, ins or None, removed or None)
        if self.publish_fn is not None:
            self.publish_fn(out, now)
