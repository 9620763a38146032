"""SiddhiAppRuntime: app assembly and lifecycle.

Reference: core/SiddhiAppRuntime.java:88-696 + util/parser/SiddhiAppParser.java —
holds junction/query maps, wires receivers into junctions, start/shutdown
ordering, callback registration. Here "parse" is compile: each query becomes a
step that launches device work on the app's device; junctions are host fan-out
points between steps.

Ported so far: stream definitions, `@app:name`, `@app:batch`, `@app:playback`,
`@app:groupCapacity`, `@app:joinCapacity`, single-stream queries (filter;
stream functions `#log`, `#pol2Cart` and extensions; length, time,
timeLength, externalTime, lengthBatch, timeBatch, externalTimeBatch, sort,
frequent, lossyFrequent and cron windows; projection with sum/count/avg/
stdDev/min/max/minForever/maxForever/distinctCount and `define function`
script functions, group-by, having, order-by, limit/offset; output rate
limiting by events, time or snapshot, whose query delivers per batch) and
join queries (inner, left/right/full outer, unidirectional, self-joins,
windowless sides), pattern and sequence queries (core/pattern.py; the two
batch routes and the per-event scan; `@app:patternCapacity`,
`@app:countCapacity`, `@app:patternChunk`), inserting into streams or
delivering to callbacks; the timers of time windows and of absent pattern
states and of timeBatch buckets and the externalTimeBatch idle timeout, a
cron window's fires and a time rate limiter's flushes, fired by the
event-time clock under @app:playback and by the wall clock otherwise; fused
columnar ingest (core/ingest.py) with `@app:ingestChunk`, `@app:wire` and the per-stream `@pipeline`, which
queries that need the scheduler stay off; in-memory tables (core/table.py,
`@app:tableCapacity`) written inside the query steps by insert, update,
delete and update-or-insert outputs, read by `in` conditions and table join
sides, and store queries (`query`, core/store_query.py); partitions
(core/partition.py, `@app:partitionCapacity`) of single-stream queries with
no window or any window (the special windows too), group-by, order-by,
limit and rate limiting, of patterns and sequences and of joins, per batch,
their timers reaching every partition; incremental aggregations
(core/aggregation.py, `define aggregation`, `@app:aggGroupCapacity`),
their duration tables, store queries over them (`within`/`per`) and
aggregation join sides, each aggregation's input stream per batch;
named windows (core/window_runtime.py, `define window`: `from W` readers,
`insert into W`, named-window join sides, store queries) and triggers
(core/trigger.py, `define trigger`, started last); `@store` record tables
(core/record_table.py); `@flightRecorder` rings and event lineage
(`@app:lineage`, observability/; partitioned queries run unrecorded, as in
JAX); sharded execution (`@app:shard`, parallel/: the partition mesh, the
batch router, key-sharded group-by and join placement, resolved at creation
and applied at `start()`).
Everything else raises `SiddhiAppCreationError("... not ported yet")`.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import operator
import threading
from typing import Callable

import numpy as np
import torch

from siddhi_tpu_torch.core.errors import DefinitionNotExistError, SiddhiAppCreationError
from siddhi_tpu_torch.core.event import (
    Event,
    EventBatch,
    KIND_CURRENT,
    KIND_EXPIRED,
    KIND_TIMER,
    StreamSchema,
)
from siddhi_tpu_torch.core.extension import extension
from siddhi_tpu_torch.core.ingest import FuseEndpoint, FusedJunctionIngest
from siddhi_tpu_torch.core.join import DEFAULT_JOIN_CAPACITY, JoinQueryRuntime
from siddhi_tpu_torch.core.pipeline import resolve_pipeline_annotation
from siddhi_tpu_torch.core.query_runtime import QueryRuntime
from siddhi_tpu_torch.core.stream_function import make_script_function
from siddhi_tpu_torch.core.stream_junction import (
    InputHandler,
    StreamJunction,
    system_clock_ms,
)
from siddhi_tpu_torch.core.wire import build_wire_spec, resolve_wire_annotation
from siddhi_tpu_torch.observability.flight import flight_env_size, resolve_flight_annotation
from siddhi_tpu_torch.observability.lineage import (
    LineageLedger,
    publisher_context,
    resolve_lineage_annotation,
)
from siddhi_tpu_torch.parallel.shard import resolve_shard_annotation
from siddhi_tpu_torch.query_api.annotation import find_annotation
from siddhi_tpu_torch.query_api.execution import (
    InsertIntoStream,
    JoinInputStream,
    OutputEventsFor,
    Query,
    ReturnStream,
    SingleInputStream,
    StateInputStream,
    assign_execution_ids,
    iter_state_streams,
)
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp

DEFAULT_BATCH = 64

_PORTED_APP_ANNOTATIONS = {"app:name", "app", "name", "app:description", "app:batch",
                           "app:playback", "app:ingestchunk", "app:wire",
                           "app:groupcapacity", "app:joincapacity", "app:patterncapacity",
                           "app:countcapacity", "app:patternchunk", "app:tablecapacity",
                           "app:partitioncapacity", "app:agggroupcapacity", "app:lineage",
                           "app:shard"}
_UNPORTED_STREAM_ANNOTATIONS = {"onerror", "source", "sink", "async"}


def _not_ported(what: str) -> SiddhiAppCreationError:
    return SiddhiAppCreationError(f"{what} is not ported yet")


class SiddhiAppRuntime:
    def __init__(self, app: SiddhiApp, manager) -> None:
        self.app = app
        self.manager = manager
        self.device = manager.device
        self.interner = manager.interner
        self.name = app.name
        self.clock = system_clock_ms

        for a in app.annotations:
            if a.name.lower() not in _PORTED_APP_ANNOTATIONS:
                raise _not_ported(f"@{a.name}")
        # `define function f[python] ...` scripts register into the function
        # registry (reference: script executors via @Extension SPI; the
        # registry is process-wide, so same-name redefinitions win last)
        for fid, fdef in app.function_definitions.items():
            extension("function", fid)(make_script_function(fdef))

        self._exception_handler = None
        self._running = False
        # failures of timer-driven steps not yet raised to a sender (with no
        # exception handler set); the next send or shutdown() raises them
        self._timer_errors: list[Exception] = []

        # @app:playback(idle.time, increment): event-time clock
        # (reference: SiddhiAppParser.java:166-212)
        self._playback_clock = None
        pb = find_annotation(app.annotations, "app:playback")
        if pb is not None:
            from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler
            from siddhi_tpu_torch.core.timestamp import EventTimeClock

            idle = pb.element("idle.time")
            inc = pb.element("increment")
            self._playback_clock = EventTimeClock(
                idle_ms=SiddhiCompiler.parse_time_constant(idle) if idle else None,
                increment_ms=SiddhiCompiler.parse_time_constant(inc) if inc else None,
            )
            self.clock = self._playback_clock.now
            from siddhi_tpu_torch.core.timestamp import EventTimeScheduler

            self._scheduler = EventTimeScheduler(self._playback_clock, self._on_timer_error)
        else:
            from siddhi_tpu_torch.core.scheduler import SystemTimeScheduler

            self._scheduler = SystemTimeScheduler(self._on_timer_error)

        self.stream_schemas: dict[str, StreamSchema] = {}
        self.junctions: dict[str, StreamJunction] = {}
        self.queries: dict[str, QueryRuntime] = {}
        # event lineage: @app:lineage(capacity='N', mode='full|sample',
        # sample.every='K') (observability/lineage.py; malformed options raise
        # here), resolved before any junction or query: _junction() arms an
        # arena on every junction, the _add_* methods a recorder on every
        # query and aggregation
        self._lineage_cfg = resolve_lineage_annotation(find_annotation(app.annotations,
                                                                       "app:lineage"))
        self.lineage_ledger = (LineageLedger(self, self._lineage_cfg)
                               if self._lineage_cfg is not None else None)
        # sharded execution: @app:shard(devices='N', axis=...) /
        # SIDDHI_TPU_SHARD (parallel/shard.py; malformed options raise here),
        # resolved now, applied at start() once the fused engines exist
        self._shard_conf = resolve_shard_annotation(find_annotation(app.annotations,
                                                                    "app:shard"))
        self._shard = None  # ShardRuntime, built at start()
        # @app:statistics is not ported: no statistics manager, as a JAX app
        # without the annotation
        self.statistics_manager = None
        batch_ann = find_annotation(app.annotations, "app:batch")
        self.batch_size = (
            int(batch_ann.element("size", str(DEFAULT_BATCH))) if batch_ann else DEFAULT_BATCH
        )
        # one app-level processing lock: receive+route for every query runs
        # under it, so timer/input threads deliver outputs in state-step order
        self._process_lock = threading.RLock()

        # fused ingest (core/ingest.py): micro-batches per chunk, the compact
        # wire's @app:wire(disable=, range/dict/delta.<stream>.<col>=) with
        # the SIDDHI_TPU_WIRE override, and each stream's @pipeline(depth=,
        # disable=) with SIDDHI_TPU_PIPELINE; malformed options raise here
        self._ingest_chunk = self._capacity_annotation("app:ingestChunk", 32)
        # group-by slot-table capacity (None: the selector's default)
        self.group_capacity = self._capacity_annotation("app:groupCapacity", None)
        # joined rows a join step can emit (matches past it are dropped and
        # logged once)
        self.join_capacity = self._capacity_annotation("app:joinCapacity", DEFAULT_JOIN_CAPACITY)
        self._wire_enabled, self._wire_hints = resolve_wire_annotation(
            find_annotation(app.annotations, "app:wire")
        )
        self._pipeline_conf: dict[str, tuple[bool, int]] = {}

        # tables (core/table.py); @store record tables raise in InMemoryTable
        from siddhi_tpu_torch.core.table import DEFAULT_TABLE_CAPACITY, InMemoryTable

        for tid, td in app.table_definitions.items():
            if find_annotation(td.annotations, "OnError") is not None:
                raise _not_ported(f"@OnError on table '{tid}'")
        table_capacity = self._capacity_annotation("app:tableCapacity", DEFAULT_TABLE_CAPACITY)
        self.tables = {tid: InMemoryTable(d, self.interner, self.device, capacity=table_capacity)
                       for tid, d in app.table_definitions.items()}
        self._store_query_cache: dict[str, object] = {}
        self._add_named_windows()

        for sid, d in app.stream_definitions.items():
            for a in d.annotations:
                if a.name.lower() in _UNPORTED_STREAM_ANNOTATIONS:
                    raise _not_ported(f"@{a.name} on stream '{sid}'")
            self.stream_schemas[sid] = StreamSchema(
                sid, [(a.name, a.type) for a in d.attributes]
            )
            self._pipeline_conf[sid] = resolve_pipeline_annotation(
                find_annotation(d.annotations, "pipeline")
            )
            # @flightRecorder(size='N'): the last N events through this
            # stream's junction (observability/flight.py; _junction() arms
            # SIDDHI_TPU_FLIGHT=N on every junction)
            try:
                flight_size = resolve_flight_annotation(
                    find_annotation(d.annotations, "flightRecorder"))
            except SiddhiAppCreationError as e:
                raise SiddhiAppCreationError(f"stream '{sid}': {e}") from e
            if flight_size:
                self._junction(sid).enable_flight(flight_size)
        self._add_aggregations()
        self._add_triggers()
        # query and partition ids come from the one shared assignment, in
        # source order (core/partition.py builds each block)
        from siddhi_tpu_torch.core.partition import PartitionRuntime

        self.partitions: list[PartitionRuntime] = []
        for ent in assign_execution_ids(app):
            if ent[0] == "query":
                _kind, qid, q = ent
                self._add_query(qid, q)
            else:
                _kind, pid, elem, inner_ids = ent
                self.partitions.append(PartitionRuntime(elem, self, pid, inner_ids))

    # ---- assembly --------------------------------------------------------

    def _capacity_annotation(self, name: str, default):
        ann = find_annotation(self.app.annotations, name)
        if ann is None:
            return default
        v = ann.element("size") or ann.element(None)
        if v is None:
            raise SiddhiAppCreationError(f"@{name} needs a size, e.g. @{name}(size='4096')")
        try:
            return int(v)
        except ValueError:
            raise SiddhiAppCreationError(f"@{name} size '{v}' must be an integer") from None

    def _add_aggregations(self) -> None:
        """Incremental aggregations (core/aggregation.py): each one's
        duration tables join the app's tables (reference:
        AggregationParser.java:701-708), and its input stream drives it per
        batch (no fused endpoint), under the processing lock, with a TIMER
        step at each finest bucket's end when it buckets by the events'
        own timestamps."""
        from siddhi_tpu_torch.core.aggregation import AggregationRuntime

        groups = self._capacity_annotation("app:aggGroupCapacity", 64)
        self.aggregations: dict[str, AggregationRuntime] = {}
        for aid, ad in self.app.aggregation_definitions.items():
            in_sid = ad.basic_single_input_stream.stream_id
            in_schema = self.stream_schemas.get(in_sid)
            if in_schema is None:
                raise DefinitionNotExistError(
                    f"aggregation '{aid}': stream '{in_sid}' is not defined")
            ar = AggregationRuntime(ad, in_schema, self.interner, self.device,
                                    group_capacity=groups)
            if self._lineage_cfg is not None:
                ar.arm_lineage(self._lineage_cfg)
            self.aggregations[aid] = ar
            for t in ar.tables.values():
                self.tables[t.table_id] = t

            def agg_receive(batch: EventBatch, now: int, _ar=ar) -> None:
                with self._process_lock:
                    aux = _ar.receive(batch, now)
                self._schedule_at(aux.get("next_timer"), _ar.timer_target)

            self._junction(in_sid).subscribe(agg_receive)

            def agg_fire(t_ms: int, _schema=in_schema, _recv=agg_receive) -> None:
                _recv(self._timer_batch(_schema, t_ms), t_ms)

            ar.timer_target = agg_fire

    def _add_named_windows(self) -> None:
        """Named windows (core/window_runtime.py): an input junction under
        the window's id, the shared window step behind it under the
        processing lock, and an output junction feeding `from W` queries
        and join sides; a window with timers re-arms after each step (its
        next expiry, or a cron window's next fire)."""
        from siddhi_tpu_torch.core.window_runtime import NamedWindow

        self.named_windows: dict[str, NamedWindow] = {}
        for wid, wd in self.app.window_definitions.items():
            if find_annotation(wd.annotations, "OnError") is not None:
                raise _not_ported(f"@OnError on window '{wid}'")
            nw = NamedWindow(wd, self.interner, self.device)
            self.named_windows[wid] = nw
            in_j = StreamJunction(nw.schema, self.interner, self.batch_size, self.device)
            self.junctions[wid] = in_j
            nw.out_junction = StreamJunction(nw.schema, self.interner, self.batch_size,
                                             self.device)

            def receive(batch: EventBatch, now: int, _nw=nw) -> None:
                with self._process_lock:
                    out, aux = _nw.receive(batch, now)
                    _nw.out_junction.publish_batch(out, now)
                if _nw.host_next_timer is not None:
                    self._notify(_nw.host_next_timer(self.clock()), _nw.timer_target)
                else:
                    self._schedule_at(aux.get("next_timer"), _nw.timer_target)

            in_j.subscribe(receive)
            if nw.needs_scheduler:
                def fire(t_ms: int, _nw=nw, _recv=receive) -> None:
                    _recv(self._timer_batch(_nw.schema, t_ms), t_ms)

                nw.timer_target = fire

    def _add_triggers(self) -> None:
        """Triggers (core/trigger.py): each defines a stream
        `<id>(triggered_time long)`, fed by the app's scheduler once
        `start()` has started it."""
        from siddhi_tpu_torch.core.trigger import TriggerRuntime
        from siddhi_tpu_torch.core.types import AttrType

        self.triggers = {}
        for tid, td in self.app.trigger_definitions.items():
            self.stream_schemas[tid] = StreamSchema(tid, [("triggered_time", AttrType.LONG)])
            self.triggers[tid] = TriggerRuntime(td, self._junction(tid), self._scheduler,
                                                lambda: self.clock())

    def _junction(self, stream_id: str) -> StreamJunction:
        j = self.junctions.get(stream_id)
        if j is None:
            schema = self.stream_schemas.get(stream_id)
            if schema is None:
                raise DefinitionNotExistError(f"stream '{stream_id}' is not defined")
            j = StreamJunction(schema, self.interner, self.batch_size, self.device)
            j.exception_handler = self._exception_handler
            # SIDDHI_TPU_FLIGHT=N and @app:lineage arm every junction, internal
            # insert-into targets included, so a chain can be walked back
            env_n = flight_env_size()
            if env_n:
                j.enable_flight(env_n)
            if self._lineage_cfg is not None:
                j.enable_lineage(self._lineage_cfg.capacity)
            self.junctions[stream_id] = j
        return j

    def _wire_insert(self, qr: QueryRuntime) -> None:
        """Route a query's output batches into its insert-into junction
        (reference: SiddhiAppRuntimeBuilder.addQuery:170-231 output wiring)."""
        out = qr.query.output_stream
        if isinstance(out, ReturnStream) or qr.table_op is not None:
            return  # table writes run inside the query step
        if not isinstance(out, InsertIntoStream) or out.is_fault:
            raise _not_ported(f"output '{type(out).__name__}'")
        target = out.target
        existing = self.stream_schemas.get(target)
        if existing is None and target in self.named_windows:
            existing = self.named_windows[target].schema
        inferred = qr.out_schema
        if existing is None:
            self.stream_schemas[target] = inferred
            existing = inferred
        elif [t for _, t in existing.attrs] != [t for _, t in inferred.attrs]:
            raise SiddhiAppCreationError(
                f"insert into '{target}': selector output {inferred.attrs} "
                f"does not match defined stream {existing.attrs}"
            )
        target_junction = self._junction(target)
        qr.insert_target_junction = target_junction
        transform = _make_insert_transform(out.output_events)
        dst_names = existing.attr_names

        def publish(out_batch: EventBatch, now: int, _t=target_junction, _qr=qr) -> None:
            if (not _t.subscribers and not _t.stream_callbacks and _t.flight is None
                    and _t.lineage is None):
                return  # nobody downstream: skip the transform
            b = transform(out_batch)
            # positional rename onto the target stream's attribute names
            b = dataclasses.replace(b, cols=dict(zip(dst_names, b.cols.values())))
            lin = getattr(_qr, "lineage", None)
            if lin is not None and _t.lineage is not None:
                # the arena notes which recorded query stamped the range, so
                # a multi-producer stream resolves each seq to its producer
                with publisher_context(_qr.query_id, lin):
                    _t.publish_batch(b, now)
                return
            _t.publish_batch(b, now)

        qr.publish_fn = publish

    def _add_query(self, qid: str, query: Query) -> None:
        if qid in self.queries:
            raise SiddhiAppCreationError(f"duplicate query name '{qid}'")
        stream = query.input_stream
        if isinstance(stream, JoinInputStream):
            self._add_join_query(qid, query)
            return
        if isinstance(stream, StateInputStream):
            self._add_pattern_query(qid, query)
            return
        if not isinstance(stream, SingleInputStream):
            raise _not_ported(f"{type(stream).__name__} query")
        in_schema = self.stream_schemas.get(stream.stream_id)
        src_junction = None
        if in_schema is None and stream.stream_id in self.named_windows:
            # `from W`: the named window's emission stream
            nw = self.named_windows[stream.stream_id]
            in_schema, src_junction = nw.schema, nw.out_junction
        if in_schema is None:
            raise DefinitionNotExistError(
                f"query '{qid}': stream '{stream.stream_id}' is not defined"
            )
        qr = QueryRuntime(query, qid, in_schema, self.interner, self.device,
                          group_capacity=self.group_capacity, tables=self.tables)
        self._wire_query_lineage(qr)
        self.queries[qid] = qr
        self._wire_insert(qr)

        def receive(batch: EventBatch, now: int, _qr=qr) -> None:
            with self._process_lock:
                out_batch = _qr.receive(batch, now)
                _qr.route_output(out_batch, now, self._decode)
                next_timer = _qr.next_timer
            target = _qr.timer_targets.get("in")
            if _qr.host_next_timer is not None:
                # a cron window: its next fire comes from the expression
                self._notify(_qr.host_next_timer(self.clock()), target)
            else:
                self._schedule_at(next_timer, target)

        if qr.uses_scheduler:
            def fire(t_ms: int, _schema=in_schema) -> None:
                receive(self._timer_batch(_schema, t_ms), t_ms)

            qr.timer_targets["in"] = fire

        if src_junction is not None:
            src_junction.subscribe(receive)  # never sent to: no fused endpoint
            return
        j = self._junction(stream.stream_id)
        j.subscribe(receive)
        self._fuse_candidate(j, FuseEndpoint(qr))

    def _add_join_query(self, qid: str, query: Query) -> None:
        join = query.input_stream
        # an aggregation side is its merged buckets for the join's per,
        # masked by its within (reference: AggregationRuntime joins)
        agg_findables = {}
        for s in (join.left, join.right):
            if s.stream_id in self.aggregations:
                from siddhi_tpu_torch.core.aggregation import (
                    AggFindable,
                    parse_per,
                    parse_within,
                )
                from siddhi_tpu_torch.query_api.expression import Constant

                if join.per is None or not isinstance(join.per, Constant):
                    raise SiddhiAppCreationError("joining an aggregation needs per '<duration>'")
                within = parse_within(join.within)
                agg_findables[s.stream_id] = AggFindable(
                    self.aggregations[s.stream_id], parse_per(join.per.value), within)
        schemas = []
        for s in (join.left, join.right):
            sch = self.stream_schemas.get(s.stream_id)
            if sch is None and s.stream_id in self.tables:
                sch = self.tables[s.stream_id].schema
            if sch is None and s.stream_id in self.named_windows:
                sch = self.named_windows[s.stream_id].schema
            if sch is None and s.stream_id in agg_findables:
                sch = agg_findables[s.stream_id].schema
            if sch is None:
                raise DefinitionNotExistError(
                    f"query '{qid}': join stream '{s.stream_id}' is not defined")
            schemas.append(sch)
        qr = JoinQueryRuntime(query, qid, schemas[0], schemas[1], self.interner, self.device,
                              group_capacity=self.group_capacity,
                              join_capacity=self.join_capacity, tables=self.tables,
                              findables={**self.tables, **self.named_windows,
                                         **agg_findables})
        self._wire_query_lineage(qr)
        self.queries[qid] = qr
        self._wire_insert(qr)

        def receive_side(batch: EventBatch, now: int, side: str, _qr=qr) -> None:
            with self._process_lock:
                out_batch = _qr.receive(batch, now, side)
                _qr.route_output(out_batch, now, self._decode)
                next_timer = _qr.next_timer
            self._schedule_at(next_timer, _qr.timer_targets.get(side))

        def step_side(side: str, _qr=qr):
            def step(st, b, now):
                st, out = _qr._step_impl(st, b, now, side)
                return st, [out]

            return step

        if join.left.stream_id == join.right.stream_id:
            # a self-join: one subscription drives the left side then the
            # right, each output delivered in that order (reference:
            # JoinInputStreamParser self-join double dispatch); the fused
            # endpoint runs and delivers both halves the same way
            def step_both(st, b, now, _qr=qr):
                st, out_l = _qr._step_impl(st, b, now, "l")
                st, out_r = _qr._step_impl(st, b, now, "r")
                return st, [out_l, out_r]

            j = self._junction(join.left.stream_id)
            j.subscribe(lambda b, now: (receive_side(b, now, "l"), receive_side(b, now, "r")))
            self._fuse_candidate(j, FuseEndpoint(qr, step=step_both, outputs=2))
        else:
            for side, stream in (("l", join.left), ("r", join.right)):
                nw = qr.window_sides[side]
                if nw is not None:
                    # a named-window side: driven by the window's emissions
                    # (that junction never sees send_columns)
                    nw.out_junction.subscribe(lambda b, now, _s=side: receive_side(b, now, _s))
                    continue
                if qr.table_sides[side]:
                    continue  # a table side is probed, never driven
                sj = self._junction(stream.stream_id)
                sj.subscribe(lambda b, now, _s=side: receive_side(b, now, _s))
                self._fuse_candidate(sj, FuseEndpoint(qr, step=step_side(side)))

        for side in qr.scheduled_sides:
            def fire(t_ms: int, _side=side, _schema=qr.side_schemas[side]) -> None:
                receive_side(self._timer_batch(_schema, t_ms), t_ms, _side)

            qr.timer_targets[side] = fire

    def _add_pattern_query(self, qid: str, query: Query) -> None:
        from siddhi_tpu_torch.core.pattern_runtime import PatternQueryRuntime
        from siddhi_tpu_torch.core.table import collect_used_tables

        if collect_used_tables(query, self.tables):
            raise _not_ported("a pattern query reading or writing a table")

        for s in iter_state_streams(query.input_stream.state):
            if s.stream_id not in self.stream_schemas:
                raise DefinitionNotExistError(
                    f"query '{qid}': pattern stream '{s.stream_id}' is not defined "
                    "(patterns consume streams, not tables or windows)")
        qr = PatternQueryRuntime(
            query, qid, self.stream_schemas, self.interner, self.device,
            group_capacity=self.group_capacity,
            token_capacity=self._capacity_annotation("app:patternCapacity", 128),
            count_capacity=self._capacity_annotation("app:countCapacity", 8),
            batch_size=self.batch_size,
            pattern_chunk=self._capacity_annotation("app:patternChunk", 0) or None,
        )
        self._wire_query_lineage(qr)
        self.queries[qid] = qr
        self._wire_insert(qr)

        def receive(batch: EventBatch, now: int, sid: str, _qr=qr) -> None:
            with self._process_lock:
                out_batch = _qr.receive(batch, now, sid)
                _qr.route_output(out_batch, now, self._decode)
                next_timer = _qr.next_timer
            self._schedule_at(next_timer, _qr.timer_targets.get("timer"))

        # one subscription and one fused endpoint per input stream, over the
        # one token table
        for sid in qr.prog.stream_ids:
            j = self._junction(sid)
            j.subscribe(lambda b, now, _sid=sid: receive(b, now, _sid))
            self._fuse_candidate(j, FuseEndpoint(qr, step=qr.step_for(sid),
                                                 init_state=qr.init_state))

        if qr.uses_scheduler:
            # absent deadlines: a one-row TIMER step at each (JAX
            # app_runtime.py _add_pattern_query's timer target)
            def fire(t_ms: int, _qr=qr) -> None:
                with self._process_lock:
                    out_batch = _qr.receive_timer(t_ms)
                    _qr.route_output(out_batch, t_ms, self._decode)
                    next_timer = _qr.next_timer
                self._schedule_at(next_timer, _qr.timer_targets.get("timer"))

            qr.timer_targets["timer"] = fire

    def _wire_query_lineage(self, qr) -> None:
        """Arm the query's provenance recorder when @app:lineage is on (a
        query that cannot be armed runs unrecorded, as in JAX)."""
        if self._lineage_cfg is None:
            return
        try:
            qr.arm_lineage(self._lineage_cfg)
        except Exception:
            logging.getLogger(__name__).warning(
                "lineage could not be armed for query '%s'", qr.query_id, exc_info=True)

    def _fuse_candidate(self, j: StreamJunction, ep: FuseEndpoint) -> None:
        """Offer a query's endpoint to its junction's fused ingest. A
        rate-limited query delivers through its limiter on the host, so it
        offers none and keeps its junction on the per-batch path. Under
        `@app:shard(axis='keys')` a key-shardable query offers none either:
        its sharded step would be bypassed by a fused chunk (JAX
        app_runtime.py:807-817 `_wire_fuse_candidate`)."""
        if ep.qr.rate_limiter is not None:
            return
        devices, axis = self._shard_conf
        if devices >= 2 and axis == "keys":
            from siddhi_tpu_torch.parallel.keyshard import keyed_shardable

            if keyed_shardable(ep.qr)[0]:
                return
        j.fuse_candidates.append(ep)

    def _timer_batch(self, schema: StreamSchema, t_ms: int) -> EventBatch:
        """A batch of one TIMER row at t_ms (null payload). The JAX package
        pads it to the app's batch size, one jit shape for every step; the
        port runs eagerly, so the step takes one row: the same rows come
        out, for a fraction of the work."""
        nulls = tuple(None for _ in schema.attrs)
        return schema.to_batch([t_ms], [nulls], self.interner, self.device, capacity=1,
                               kinds=[KIND_TIMER])

    def _schedule_at(self, next_timer, target) -> None:
        """Ask the scheduler to fire `target` at a step's next expiry (one
        host read of the 0-d device tensor)."""
        if target is None or next_timer is None:
            return
        from siddhi_tpu_torch.core.windows import NO_TIMER

        t = int(next_timer)
        if t < NO_TIMER:
            self._notify(t, target)

    def _notify(self, t_ms: int, target) -> None:
        if target is not None:
            self._scheduler.start()
            self._scheduler.notify_at(t_ms, target)

    def _arm_rate_limiter(self, qr) -> None:
        """Recurring flush timer of a time or snapshot rate limiter
        (reference: time-based OutputRateLimiter scheduler wiring)."""
        rl = qr.rate_limiter
        if rl is None or rl.period_ms is None:
            return
        period = rl.period_ms

        def fire(t_ms: int, _qr=qr, _rl=rl) -> None:
            if not self._running:
                return  # stopped: stop re-arming
            with self._process_lock:
                _qr._deliver(_rl.on_timer(t_ms), t_ms)
            self._notify(t_ms + period, fire)

        self._notify(self.clock() + period, fire)

    def _on_timer_error(self, exc: Exception) -> None:
        """A timer-driven step failed (on the sender's thread under
        playback, on the scheduler's thread otherwise): hand it to the
        exception handler, or keep it for the next send or shutdown() to
        raise, so a failed step never goes unseen."""
        handler = self._exception_handler
        if handler is None:
            self._timer_errors.append(exc)
            return
        logging.getLogger(__name__).error("timer step failed: %s", exc)
        try:
            handler(exc)
        except Exception:
            logging.getLogger(__name__).exception("exception handler raised")

    def _raise_timer_error(self) -> None:
        if self._timer_errors:
            exc = self._timer_errors[0]
            self._timer_errors.clear()
            raise exc

    def _decode(self, schema: StreamSchema, batch: EventBatch):
        return schema.from_batch(batch, self.interner)

    # ---- public API (reference: SiddhiAppRuntime callbacks/handlers) -----

    def get_input_handler(self, stream_id: str):
        return _AppInputHandler(InputHandler(self._junction(stream_id), lambda: self.clock()),
                                self._playback_clock, self._raise_timer_error)

    input_handler = get_input_handler

    def add_callback(self, name: str, callback: Callable) -> None:
        """Stream callback `cb(events: list[Event])` or query callback
        `cb(timestamp, in_events, removed_events)` — dispatched by target:
        stream name vs @info query name (reference: addCallback overloads).
        """
        if name in self.queries:
            # all-C construction: namedtuple's own __new__ is Python code and
            # costs several times more per event than tuple.__new__
            mk = functools.partial(tuple.__new__, Event)
            ts_data = operator.itemgetter(0, 2)

            def qcb(ts, ins, removed, _cb=callback):
                _cb(
                    ts,
                    list(map(mk, map(ts_data, ins))) if ins else None,
                    list(map(mk, map(ts_data, removed))) if removed else None,
                )

            qr = self.queries[name]
            qr.query_callbacks.append(qcb)
            # the fused drain builds Event lists once and calls the user
            # callbacks directly while the two lists stay one to one
            qr.raw_query_callbacks.append(callback)
            return
        if name in self.stream_schemas:
            self._junction(name).add_stream_callback(
                lambda rows, _cb=callback: _cb([Event(t, d) for t, d in rows])
            )
            return
        raise DefinitionNotExistError(f"no stream or query named '{name}'")

    def query(self, store_query) -> list:
        """One-shot pull query over tables (reference:
        SiddhiAppRuntime.query:264-299), compiled once per query string."""
        from siddhi_tpu_torch.core.store_query import StoreQueryRuntime

        if isinstance(store_query, str):
            sqr = self._store_query_cache.get(store_query)
            if sqr is None:
                from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler

                sqr = StoreQueryRuntime(SiddhiCompiler.parse_store_query(store_query),
                                        self.tables, self.interner, self.device,
                                        group_capacity=self.group_capacity,
                                        windows=self.named_windows,
                                        aggregations=self.aggregations)
                self._store_query_cache[store_query] = sqr
        else:
            sqr = StoreQueryRuntime(store_query, self.tables, self.interner, self.device,
                                    group_capacity=self.group_capacity,
                                    windows=self.named_windows,
                                    aggregations=self.aggregations)
        with self._process_lock:
            return sqr.execute(self.clock())

    def describe_state(self) -> dict:
        """Live per-component state: each junction (its fused engine, flight
        ring and lineage arena), each table's row count, capacity and
        indexes (one host read a table), each recorded query's lineage."""
        d = {
            "streams": {sid: j.describe_state() for sid, j in self.junctions.items()},
            "tables": {tid: t.describe_state() for tid, t in self.tables.items()},
        }
        lin = {qid: qr.lineage.describe() for qid, qr in self.queries.items()
               if getattr(qr, "lineage", None) is not None}
        if lin:
            d["lineage"] = lin
        if self._shard is not None:
            d["shard"] = self._shard.describe_state()
        return d

    def snapshot_status(self) -> dict:
        """The app's live status: `describe_state()` (the port keeps no
        statistics, SLO or persistence sections yet); "shard" is the sharded
        execution's placement and counters when `@app:shard` is on."""
        return self.describe_state()

    # ---- flight recorder (observability/flight.py) ------------------------

    def flight_record(self, stream_id: str) -> list[tuple[int, tuple]]:
        """The last events through `stream_id`'s junction, oldest first, as
        (timestamp, data tuple); the stream needs a recorder
        (@flightRecorder(size='N') or SIDDHI_TPU_FLIGHT=N)."""
        j = self.junctions.get(stream_id)
        if j is None:
            raise DefinitionNotExistError(f"no stream '{stream_id}' in app '{self.name}'")
        if j.flight is None:
            raise SiddhiAppCreationError(
                f"stream '{stream_id}' has no flight recorder — enable it "
                "with @flightRecorder(size='N') or SIDDHI_TPU_FLIGHT=N")
        return j.flight.events()

    def flight_records(self) -> dict[str, list[tuple[int, tuple]]]:
        """Every recorded junction's ring: stream -> [(ts, data tuple)]."""
        return {sid: j.flight.events() for sid, j in self.junctions.items()
                if j.flight is not None}

    # ---- lineage (observability/lineage.py) -------------------------------

    def lineage(self, target: str, index: int | None = None, depth: int = 6) -> dict:
        """Explain an output back to its input events (@app:lineage needed):
        `target` is a query id (index = its output index) or a stream id
        (index = the junction's seq id, its k-th valid CURRENT event); None
        is the newest."""
        if self.lineage_ledger is None:
            raise SiddhiAppCreationError(
                f"app '{self.name}' has no lineage — enable it with @app:lineage(capacity='N')")
        return self.lineage_ledger.resolve(target, index, depth)

    def lineage_report(self, resolve_recent: int = 1) -> dict:
        """Per-stream arenas, per-query fan-in and the newest resolved
        chains ({} when @app:lineage is off)."""
        if self.lineage_ledger is None:
            return {}
        return self.lineage_ledger.report(resolve_recent=resolve_recent)

    def set_exception_handler(self, handler) -> None:
        """Route subscriber, fused-drain and timer-step failures to `handler(exc)`
        instead of propagating to the sender (reference:
        SiddhiAppRuntime.handleExceptionWith)."""
        for j in self.junctions.values():
            j.exception_handler = handler
        self._exception_handler = handler

    def start(self) -> None:
        self._running = True
        if self._playback_clock is not None:
            self._playback_clock.start_heartbeat()
        self._build_fused_ingest()
        # sharded execution (parallel/shard.py): the partition mesh, key
        # sharding and the batch routers, from the creation-time resolution
        shard_devices, shard_axis = self._shard_conf
        if shard_devices >= 2:
            from siddhi_tpu_torch.parallel.shard import ShardRuntime

            self._shard = ShardRuntime(self, shard_devices, shard_axis)
            self._shard.apply()
        # absent-at-start patterns arm their timers before any event
        # (reference: SiddhiAppRuntime.start -> eternalReferencedHolders.start),
        # a cron window its first fire, a time or snapshot rate limiter its
        # first flush
        for qr in self.queries.values():
            target = qr.timer_targets.get("timer")
            if target is not None:
                self._schedule_at(qr.prime(self.clock())["next_timer"], target)
            hnt = getattr(qr, "host_next_timer", None)
            if hnt is not None:
                self._notify(hnt(self.clock()), qr.timer_targets.get("in"))
            self._arm_rate_limiter(qr)
        # triggers begin last, into fully wired queries (reference:
        # SiddhiAppRuntime.start:353-394)
        for tr in self.triggers.values():
            tr.start()

    def _build_fused_ingest(self) -> None:
        """Build a fused ingest engine on each junction whose subscribers
        all registered a FuseEndpoint (every query of the port does), with
        the stream's static wire spec and pipeline configuration."""
        for j in list(self.junctions.values()):
            if not j.fuse_candidates or len(j.fuse_candidates) != len(j.subscribers):
                continue
            sid = j.schema.stream_id
            pipe_on, pipe_depth = self._pipeline_conf.get(
                sid, resolve_pipeline_annotation(None)
            )
            spec = (
                build_wire_spec(sid, j.schema.attrs, self._wire_hints, capacity=j.batch_size)
                if self._wire_enabled
                else None
            )
            if j.fused_ingest is not None:  # a second start(): replace the engine
                j.fused_ingest.close()
            j.fused_ingest = FusedJunctionIngest(
                self, j, j.fuse_candidates, chunk_batches=self._ingest_chunk,
                pipeline_enabled=pipe_on, pipeline_depth=pipe_depth,
                wire_spec=spec, wire_enabled=self._wire_enabled,
            )

    def shutdown(self) -> None:
        self._running = False
        for tr in self.triggers.values():
            tr.stop()
        if self._playback_clock is not None:
            self._playback_clock.stop()
        self._scheduler.shutdown()
        for j in self.junctions.values():
            if j.fused_ingest is not None:
                j.fused_ingest.close()  # stops the pipeline drain worker
        for qr in self.queries.values():
            qr.flush_aux_warnings()  # overflow flags not yet read back
        # flush after the scheduler stops, so no timer re-dirties a table
        for t in self.tables.values():
            t.close_record_store()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._raise_timer_error()


class _AppInputHandler:
    """Under @app:playback, advances the playback clock to each event's
    timestamp before dispatch (reference:
    EventTimeBasedMillisTimestampGenerator wiring); raises a failed timer
    step's error, whichever thread ran it, before and after the dispatch."""

    def __init__(self, inner: InputHandler, clock, raise_timer_error):
        self._inner = inner
        self._pb = clock
        self._raise = raise_timer_error

    def _advance(self, t_ms):
        if self._pb is not None and t_ms is not None:
            self._pb.advance(t_ms)
        self._raise()

    def send(self, data, timestamp=None):
        self._advance(timestamp)
        self._inner.send(data, timestamp)
        self._raise()

    def send_many(self, rows, timestamps=None):
        self._advance(max(timestamps) if timestamps else None)
        self._inner.send_many(rows, timestamps)
        self._raise()

    def send_columns(self, timestamps, cols, now=None):
        self._advance(int(np.max(timestamps)) if len(timestamps) else None)
        self._inner.send_columns(timestamps, cols, now)
        self._raise()


def _make_insert_transform(output_events: OutputEventsFor):
    def t(batch: EventBatch) -> EventBatch:
        if output_events is OutputEventsFor.CURRENT:
            keep = batch.kind == KIND_CURRENT
        elif output_events is OutputEventsFor.EXPIRED:
            keep = batch.kind == KIND_EXPIRED
        else:
            keep = torch.ones_like(batch.valid)
        return EventBatch(
            ts=batch.ts,
            kind=torch.zeros_like(batch.kind),  # inserted events become CURRENT
            valid=batch.valid & keep,
            cols=batch.cols,
        )

    return t
