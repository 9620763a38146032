"""Store queries: one-shot pull queries over tables.

Reference: util/parser/StoreQueryParser.java:79-491 compiling Find/Select/
Update/Delete store-query runtimes, cached per query string by
SiddhiAppRuntime.java:272-299. As in the JAX package (siddhi_tpu/core/
store_query.py), a pull orders the table's rows by insertion, applies the
on-condition, runs the selector in batch mode (one row per group key) and
applies any table write-back (core/table.py), all on the app's device. A
store query over an aggregation (`from A within .. per '<duration>'`)
reads its find (core/aggregation.py: the duration table's closed buckets,
then the in-flight ones merged by K45), masked by `within`. One over a
named window reads its live `view()` (insertion order). A table backed by
a lazy record store (core/record_table.py) is staged per pull from the
store's pushdown of the `on` condition.
"""

from __future__ import annotations

import dataclasses

import torch

from siddhi_tpu_torch.core.errors import (
    DefinitionNotExistError,
    SiddhiAppCreationError,
    SiddhiAppRuntimeError,
)
from siddhi_tpu_torch.core.event import Event, EventBatch, StreamSchema
from siddhi_tpu_torch.core.executor import Scope, compile_expression
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.selector import CompiledSelector
from siddhi_tpu_torch.core.table import compile_table_output
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.query_api.execution import StoreQuery

_MAX64 = torch.iinfo(torch.int64).max


class StoreQueryRuntime:
    """Compiled pull query over one table source (or none: a constant row
    inserted into a table)."""

    def __init__(self, sq: StoreQuery, tables: dict, interner, device, group_capacity=None,
                 windows: dict | None = None, aggregations: dict | None = None):
        store = sq.input_store
        self._sq = sq
        windows = windows or {}
        self.device = torch.device(device)
        self.no_from = store is None
        if self.no_from and sq.output_stream is None:
            raise SiddhiAppCreationError(
                "a store query needs a 'from <store>' clause or an insert/update/delete output")
        aggregations = aggregations or {}
        self.aggregation = aggregations.get(store.store_id) if store is not None else None
        self.per = self.within = None
        if self.aggregation is not None:
            from siddhi_tpu_torch.core.aggregation import parse_per, parse_within_value
            from siddhi_tpu_torch.query_api.expression import Constant

            if store.per is None:
                raise SiddhiAppCreationError(
                    "aggregation store queries need a per '<duration>' clause")
            if not isinstance(store.per, Constant):
                raise SiddhiAppCreationError("'per' must be a constant duration")
            self.per = parse_per(store.per.value)
            if store.within is not None:
                w1, w2 = store.within
                if not isinstance(w1, Constant) or (w2 is not None
                                                    and not isinstance(w2, Constant)):
                    raise SiddhiAppCreationError("'within' operands must be constants")
                if w2 is None:
                    self.within = parse_within_value(w1.value)
                else:
                    self.within = (parse_within_value(w1.value)[0],
                                   parse_within_value(w2.value)[0])
                if self.within[0] >= self.within[1]:
                    # reference: StoreQueryCreationException for an empty or
                    # inverted range
                    raise SiddhiAppCreationError(
                        "'within' start time must be before the end time")
            table = self.aggregation
            source_schema = self.aggregation.out_schema
        elif self.no_from:
            # `select <constants> insert into T;` — one synthetic row
            # (reference: InsertStoreQueryRuntime)
            table = None
            source_schema = StreamSchema("__const__", [])
        else:
            table = tables.get(store.store_id) or windows.get(store.store_id)
            if table is None:
                raise DefinitionNotExistError(
                    f"'{store.store_id}' is not a defined table, window, or aggregation")
            if store.within is not None or store.per is not None:
                raise SiddhiAppCreationError("'within'/'per' apply to aggregation store queries")
            source_schema = table.schema
        self.table = table  # the findable source: a table, window or aggregation
        self.is_window = store is not None and store.store_id in windows
        self.tables = dict(tables)
        self.ref = (store.alias or store.store_id) if store is not None else "__const__"

        scope = Scope(interner, self.device)
        scope.add_stream(self.ref, source_schema.attr_types)
        scope.default_ref = self.ref
        for t in self.tables.values():
            scope.add_table(t)
        self.on = None
        if store is not None and store.on is not None:
            self.on = compile_expression(store.on, scope)
            if self.on.type is not AttrType.BOOL:
                raise SiddhiAppCreationError("'on' must be a boolean expression")
        self.selector = CompiledSelector(sq.selector, scope, source_schema.attrs,
                                         batch_mode=True, group_capacity=group_capacity)
        # a plain aggregation (no group by) collapses to the final running
        # row (reference: SelectStoreQueryRuntime with an aggregating selector)
        self.agg_single = bool(self.selector.aggregators) and self.selector.group is None
        self.out_schema = StreamSchema(f"__sq_{self.ref}", self.selector.out_attrs)
        self.interner = interner
        target = getattr(sq.output_stream, "target", None)
        if sq.output_stream is not None and target not in self.tables:
            # a store query has no junctions: its target must be a table
            raise DefinitionNotExistError(f"store query target '{target}' is not a defined table")
        self.table_op = (compile_table_output(sq.output_stream, self.out_schema, self.tables,
                                              interner, self.device)
                         if sq.output_stream is not None else None)

    def _source_batch(self, now: torch.Tensor) -> EventBatch:
        dev = self.device
        if self.no_from:
            return EventBatch(ts=now.reshape(1).clone(), kind=torch.zeros(1, dtype=torch.int8,
                                                                          device=dev),
                              valid=torch.ones(1, dtype=torch.bool, device=dev), cols={})
        if self.aggregation is not None:
            return self.aggregation.find(self.per, self.within)
        if self.is_window:
            # a named window: view() already yields insertion order
            cols, ts, mask = self.table.view(self.table.state)
            return EventBatch(ts=ts, kind=torch.zeros_like(ts, dtype=torch.int8), valid=mask,
                              cols=cols)
        st = self.table.state
        # iterate in insertion order (reference: holder iteration order)
        order = torch.argsort(torch.where(st["valid"], st["seq"], _MAX64), stable=True)
        return EventBatch(ts=st["ts"][order], kind=torch.zeros_like(st["ts"], dtype=torch.int8),
                          valid=st["valid"][order],
                          cols={n: c[order] for n, c in st["cols"].items()})

    def _stage_lazy_tables(self) -> dict:
        """Each lazy record-store table's rows for this pull: the store's
        pushdown of the `on` condition (the condition is applied again on
        the device), staged in a fresh table state. Returns {table id: the
        live state to put back}."""
        live = {}
        for tid, t in self.tables.items():
            if not t.lazy:
                continue
            store = self._sq.input_store
            on = store.on if store is not None and store.store_id == tid else None
            rows = t.record_store.query(on, self.interner)
            if rows is None:
                raise SiddhiAppRuntimeError(
                    f"table '{tid}': lazy record store did not push the condition down "
                    "(query() returned None)")
            if len(rows) > t.capacity:
                raise SiddhiAppRuntimeError(
                    f"table '{tid}': pushdown returned {len(rows)} rows but capacity is "
                    f"{t.capacity}; narrow the condition or raise @capacity(size='N')")
            live[tid] = t.state
            t.state = t.load_rows(t.init_state(), rows)
        return live

    def execute(self, now: int) -> list[Event]:
        live = self._stage_lazy_tables()
        try:
            out = self._execute(now)
        finally:
            for tid, st in live.items():  # staged subsets never become live state
                self.tables[tid].state = st
        rows = self.out_schema.from_batch(out, self.interner)
        return [Event(ts, data) for ts, _kind, data in rows]

    def _execute(self, now: int) -> EventBatch:
        now_t = torch.full((), now, dtype=torch.int64, device=self.device)
        batch = self._source_batch(now_t)
        flow = Flow(batch=batch, ref=self.ref, now=now_t)
        if self.on is not None:
            mask = self.on(flow.env())
            batch = EventBatch(batch.ts, batch.kind, batch.valid & mask, batch.cols)
            flow = dataclasses.replace(flow, batch=batch)
        _state, out = self.selector.apply(self.selector.init_state(), flow)
        if self.agg_single:
            idx = torch.arange(out.valid.shape[0], device=self.device)
            last = torch.where(out.valid, idx, -1).max()
            out = EventBatch(out.ts, out.kind, out.valid & (idx == last), out.cols)
        if self.table_op is not None:
            self.table_op(out, now_t, dict(flow.aux))
        return out
