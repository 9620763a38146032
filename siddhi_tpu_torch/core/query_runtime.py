"""Per-query compilation and runtime container.

Reference: query/QueryRuntime.java:45-200 wires receiver -> processor chain ->
selector -> rate limiter -> callback as runtime objects. Here the chain is
compiled once into a step `(state, in_batch, now) -> (state', out_batch)` that
launches device work; the runtime object owns the device state and the
host-side output routing.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Optional

import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.aggregators import DistinctCountAggregator, ExtremeAggregator
from siddhi_tpu_torch.core.event import (
    EventBatch,
    KIND_CURRENT,
    KIND_EXPIRED,
    KIND_TIMER,
    StreamSchema,
)
from siddhi_tpu_torch.core.executor import Scope, compile_expression
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.ratelimit import EventAllLimiter, TimeAllLimiter, build_rate_limiter
from siddhi_tpu_torch.core.selector import CompiledSelector
from siddhi_tpu_torch.core.stream_function import make_stream_function
from siddhi_tpu_torch.core.types import AttrType, InternTable
from siddhi_tpu_torch.core.windows import make_window
from siddhi_tpu_torch.observability.lineage import (
    LIN,
    SingleQueryLineage,
    observe_steps,
)
from siddhi_tpu_torch.query_api.execution import (
    Filter,
    InsertIntoStream,
    OutputEventsFor,
    Query,
    SingleInputStream,
    StreamFunctionHandler,
    WindowHandler,
)


class CompiledSingleChain:
    """Ordered filter / stream-function / window stages over one input stream
    (reference: SingleInputStreamParser.generateProcessor chain assembly).
    Stream functions append attribute columns; the chain's effective output
    schema is `out_attrs`."""

    def __init__(self, stream: SingleInputStream, schema: StreamSchema, scope: Scope):
        self.schema = schema
        self.ref = stream.alias or stream.stream_id
        self.window = None
        # lineage probe (observability/lineage.py): called on the flow after
        # the filters and stream functions, before the window (or on the
        # final flow of a windowless chain); returns the admit, key and
        # window-time lanes, kept in `probe_lanes`. None when @app:lineage
        # is off.
        self.lineage_probe: Optional[Callable] = None
        self.probe_lanes: dict = {}
        self.stages: list[tuple[str, object]] = []
        attrs = dict(schema.attr_types)
        for h in stream.handlers:
            if isinstance(h, Filter):
                cond = compile_expression(h.expression, scope)
                if cond.type is not AttrType.BOOL:
                    raise SiddhiAppCreationError("filter must be a boolean expression")
                self.stages.append(("filter", cond))
            elif isinstance(h, WindowHandler):
                if self.window is not None:
                    raise SiddhiAppCreationError("only one window per stream")
                win_schema = StreamSchema(schema.stream_id, list(attrs.items()))
                self.window = make_window(h.window, win_schema, self.ref, scope)
                self.stages.append(("window", self.window))
            elif isinstance(h, StreamFunctionHandler):
                stage = make_stream_function(h, attrs, self.ref, scope, schema.stream_id)
                for name, t in stage.new_attrs:
                    if name in attrs:
                        raise SiddhiAppCreationError(
                            f"stream function '#{h.name}' output '{name}' "
                            "collides with an existing attribute")
                    attrs[name] = t
                    # later filters/selectors resolve the appended attrs
                    scope.add_stream(self.ref, attrs)
                self.stages.append(("fn", stage))
            else:
                raise SiddhiAppCreationError(
                    f"stream handler {type(h).__name__} is not ported yet"
                )
        self.out_attrs: list[tuple[str, AttrType]] = list(attrs.items())

    def init_state(self):
        return self.window.init_state() if self.window is not None else ()

    def apply(self, state, flow: Flow):
        probe = self.lineage_probe
        for kind, stage in self.stages:
            if kind == "filter":
                flow = self._filter(flow, stage)
            elif kind == "fn":
                flow = stage.apply(flow)
            else:  # window
                if probe is not None:
                    self.probe_lanes = probe(flow)  # admitted: post-filter, pre-window
                    probe = None
                state, flow = stage.apply(state, flow)
        if probe is not None:
            self.probe_lanes = probe(flow)  # a windowless chain: the final flow
        return state, flow

    @staticmethod
    def _filter(flow: Flow, cond) -> Flow:
        mask = cond(flow.env())
        is_timer = flow.batch.kind == KIND_TIMER  # timers bypass filters
        valid = flow.batch.valid & (is_timer | mask)
        batch = dataclasses.replace(flow.batch, valid=valid)
        return dataclasses.replace(flow, batch=batch)


class _FlagWatch:
    """A device flag ORed across steps and read without stalling dispatch:
    each `poll` enqueues a non-blocking copy of the running OR into pinned
    host memory behind an event and reads the previous copy only once its
    event has completed; `flush` synchronises. On the CPU the flag is read
    directly."""

    def __init__(self, device: torch.device, on_set: Callable[[], None]):
        self.device = device
        self.on_set = on_set
        self.fired = False
        self._acc: Optional[torch.Tensor] = None
        self._host: Optional[torch.Tensor] = None
        self._event = None

    def note(self, flag: torch.Tensor) -> None:
        if not self.fired:
            self._acc = flag if self._acc is None else self._acc | flag

    def poll(self) -> None:
        if self.fired or self._acc is None:
            return
        if self.device.type != "cuda":
            self._read(bool(self._acc))
            return
        if self._event is not None:
            if not self._event.query():
                return
            self._read(bool(self._host))
            if self.fired:
                return
        if self._host is None:
            self._host = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self._event = torch.cuda.Event()
        self._host.copy_(self._acc, non_blocking=True)
        self._event.record()

    def flush(self) -> None:
        if self._acc is not None and not self.fired:
            self._read(bool(self._acc))

    def _read(self, value: bool) -> None:
        if value:
            self.fired = True
            self._acc = None
            self.on_set()


# the one-time logs of the table and window flags (the JAX package's
# query_runtime.py _check_aux_flags)
_FLAG_LOGS = {
    "table_overflow": (
        logging.ERROR,
        "query '%s': table ran out of capacity; inserts were dropped — raise it with "
        "@capacity(size='N') on the table definition"),
    "table_pk_duplicate_dropped": (
        logging.ERROR,
        "query '%s': dropping inserted event(s) — an event with the same primary key is "
        "already stored (use `update or insert into` to overwrite)"),
    "table_pk_conflict": (
        logging.ERROR,
        "query '%s': update failed — rekeying matched rows would collide with an existing "
        "primary key; the update event was skipped"),
    # the key table of a partition (core/partition.py)
    "partition_overflow": (
        logging.ERROR,
        "query '%s': partition key table overflowed; events of overflowed keys were dropped "
        "— raise it with @app:partitionCapacity(size='N')"),
    # a special window's emission buffer or key table (core/windows_special.py)
    "window_overflow": (
        logging.WARNING,
        "query '%s': window emission/key buffer overflowed; events were dropped — reduce "
        "batch size or raise window capacity"),
}


class BaseQueryRuntime:
    """Output setup and host routing shared by single-stream and join
    queries. A subclass sets `query`, `query_id`, `device`, `_scope` and
    `selector`, then calls `_setup_output`."""

    def _setup_output(self, query: Query, query_id: str) -> None:
        grouped = bool(query.selector.group_by)
        self.rate_limiter = build_rate_limiter(query.output_rate, grouped)
        if self.rate_limiter is not None and grouped and not isinstance(
                self.rate_limiter, (EventAllLimiter, TimeAllLimiter)):
            # per-group limiters need the group key beside each output row
            self.selector.emit_group_key = True
        out = query.output_stream
        target = out.target if isinstance(out, InsertIntoStream) else f"__ret_{query_id}"
        self.out_schema = StreamSchema(target, self.selector.out_attrs)
        self.output_events = out.output_events
        self._overflow = _FlagWatch(self.device, self._log_group_overflow)
        # the last step's earliest expiry (0-d int64 device tensor) when its
        # window needs the scheduler, else None; read by the app runtime
        self.next_timer: Optional[torch.Tensor] = None
        # the scheduler's target for each input whose window needs timers
        # ("in" for a single stream, "l"/"r" for join sides); set by the
        # app runtime when `uses_scheduler`
        self.timer_targets: dict[str, Callable[[int], None]] = {}
        self.query_callbacks: list[Callable] = []
        # the user callbacks behind query_callbacks, one to one: the fused
        # drain builds Event lists once and calls them directly
        self.raw_query_callbacks: list[Callable] = []
        self.publish_fn: Optional[Callable] = None
        self.insert_target_junction = None
        self._receive_lock = threading.RLock()
        self.state = None
        # the table op of a table output, compiled by _attach_tables
        self.table_op: Optional[Callable] = None
        self.tables: dict = {}
        self._flags = {
            key: _FlagWatch(self.device, lambda _k=key: self._log_flag(_k))
            for key in _FLAG_LOGS
        }
        # lineage recorder (observability/lineage.py), set by arm_lineage()
        # when @app:lineage is on; each step then appends (tag, its __lin.*
        # device lanes) to _lin_sink, which the per-batch receive and the
        # fused chunk loop read back and replay in order
        self.lineage = None
        self._lin_sink: list = []

    def _published_kinds(self) -> frozenset:
        """The kinds this query's insert-into publishes (all re-kinded
        CURRENT on the target): maps the target's seq k to the k-th
        published record."""
        if self.output_events is OutputEventsFor.CURRENT:
            return frozenset((KIND_CURRENT,))
        if self.output_events is OutputEventsFor.EXPIRED:
            return frozenset((KIND_EXPIRED,))
        return frozenset((KIND_CURRENT, KIND_EXPIRED))

    def _lin_flush(self, now: int) -> None:
        """Read back and replay the steps' lineage lanes (one copy)."""
        steps, self._lin_sink = self._lin_sink, []
        observe_steps([(self.lineage, steps)], now)

    def _attach_tables(self, tables: dict, interner) -> None:
        """Compile this query's table-output op and keep the tables the
        query reads (in-conditions, join sides) or writes (reference:
        OutputParser constructing Insert/Update/Delete/
        UpdateOrInsertIntoTableCallback)."""
        from siddhi_tpu_torch.core.table import collect_used_tables, compile_table_output

        tables = dict(tables or {})
        self.table_op = compile_table_output(self.query.output_stream, self.out_schema, tables,
                                             interner, self.device)
        if self.table_op is not None and self.rate_limiter is not None:
            raise SiddhiAppCreationError("output rate limiting into a table is not supported yet")
        self.tables = {tid: tables[tid] for tid in sorted(collect_used_tables(self.query, tables))}

    def _apply_table_op(self, out: EventBatch, now, aux: dict) -> None:
        if self.table_op is not None:
            self.table_op(out, now, aux)

    def _log_flag(self, key: str) -> None:
        level, msg = _FLAG_LOGS[key]
        logging.getLogger(__name__).log(level, msg, self.query_id)

    @property
    def used_attrs(self):
        """Input attribute names this query can ever read (from the compile
        scope's resolved keys), or None for everything (select *). Fused
        ingest drops the other columns from the wire."""
        if self.query.selector.select_all:
            return None
        return {k[2] for k in self._scope.used_keys}

    def _note_aux(self, aux: dict) -> None:
        """Take a step's device flags: the group-by overflow is ORed and read
        off the dispatch path; the next expiry is kept for the scheduler."""
        if "groupby_overflow" in aux:
            self._overflow.note(aux["groupby_overflow"])
            self._overflow.poll()
        for key, watch in self._flags.items():
            if key in aux:
                watch.note(aux[key])
                watch.poll()
        self.next_timer = aux.get("next_timer")

    def _log_group_overflow(self) -> None:
        logging.getLogger(__name__).error(
            "query '%s': group-by slot table overflowed (capacity %d); overflowed "
            "keys lose their cross-batch carry — raise it with "
            "@app:groupCapacity(size='N')",
            self.query_id, self.selector.group.capacity,
        )

    def flush_aux_warnings(self) -> None:
        """Read the pending overflow flags now (one device sync) and log."""
        self._overflow.flush()
        for watch in self._flags.values():
            watch.flush()

    def route_output(self, out: EventBatch, now: int, decode) -> None:
        """Dispatch a step's output to query callbacks / downstream junction.

        `decode` = app-runtime host decoder (batch -> event triples).
        """
        if self.rate_limiter is not None:
            rows = decode(self.out_schema, out)
            keys = None
            if "__group_key__" in out.cols:
                keys = out.cols["__group_key__"][out.valid].tolist()
            rows4 = [(ts, kind, data, keys[i] if keys is not None else None)
                     for i, (ts, kind, data) in enumerate(rows)]
            # only the kinds this query OUTPUTS enter the limiter — an
            # un-requested EXPIRED row must not consume a chunk slot or
            # shadow a group's held row (reference: the selector's
            # currentOn/expiredOn gate sits before OutputRateLimiter)
            want = self.output_events
            kinds = ((KIND_CURRENT,) if want is OutputEventsFor.CURRENT else
                     (KIND_EXPIRED,) if want is OutputEventsFor.EXPIRED else
                     (KIND_CURRENT, KIND_EXPIRED))
            self._deliver(self.rate_limiter.process([r for r in rows4 if r[1] in kinds], now), now)
            return
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

    def _deliver(self, rows4: list, now: int) -> None:
        """Route rate-limiter-released `(ts, kind, data, key)` rows to the
        callbacks and the downstream junction (re-encoded into batches of
        64 rows, as the JAX package pads them)."""
        if not rows4:
            return
        if self.query_callbacks:
            want = self.output_events
            ins = [] if want is OutputEventsFor.EXPIRED else [
                r[:3] for r in rows4 if r[1] == KIND_CURRENT]
            removed = [] if want is OutputEventsFor.CURRENT else [
                r[:3] for r in rows4 if r[1] == KIND_EXPIRED]
            if ins or removed:
                ts = rows4[-1][0]
                for cb in self.query_callbacks:
                    cb(ts, ins or None, removed or None)
        if self.publish_fn is not None:
            cap = 64
            for ofs in range(0, len(rows4), cap):
                chunk = rows4[ofs:ofs + cap]
                batch = self.out_schema.to_batch(
                    [r[0] for r in chunk], [r[2] for r in chunk], self._scope.interner, self.device,
                    capacity=cap, kinds=[r[1] for r in chunk])
                self.publish_fn(batch, now)


class QueryRuntime(BaseQueryRuntime):
    """Compiled single-stream query + device state + host output routing."""

    def __init__(
        self,
        query: Query,
        query_id: str,
        in_schema: StreamSchema,
        interner: InternTable,
        device,
        group_capacity: Optional[int] = None,
        tables: Optional[dict] = None,
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
        for t in (tables or {}).values():
            scope.add_table(t)
        self._scope = scope

        self.chain = CompiledSingleChain(stream, in_schema, scope)
        win = self.chain.window
        is_batch = win is not None and win.is_batch
        self.uses_scheduler = win is not None and win.needs_scheduler
        self.selector = CompiledSelector(
            query.selector,
            scope,
            self.chain.out_attrs,
            batch_mode=is_batch,
            group_capacity=group_capacity,
        )
        self._setup_output(query, query_id)
        self._attach_tables(tables, interner)
        # the ungrouped batch collapse gates its last event by kind
        # (reference: QuerySelector currentOn/expiredOn gate lastEvent)
        self.selector.output_events_for_batch = self.output_events
        # a batch window skips its EXPIRED lanes when nothing can observe
        # them: `insert [current] into` output and no membership-reading
        # aggregator (windowed min/max, distinctCount); the flow is then
        # w + B + F rows, not 3w + 2B + F
        needs_member = any(
            isinstance(a, DistinctCountAggregator)
            or (isinstance(a, ExtremeAggregator) and not a.forever)
            for a in self.selector.aggregators
        )
        if (is_batch and self.output_events is OutputEventsFor.CURRENT
                and self.rate_limiter is None and not needs_member):
            win.emit_expired = False
        # cron-driven windows compute their next fire on the host
        cron = getattr(win, "cron_schedule", None)
        self.host_next_timer = cron.next_fire_ms if cron is not None else None
        # armed by parallel/keyshard.py (@app:shard axis='keys'): the
        # KeyShardedGroupExec whose step and [D] state layout `receive` takes
        self._keyshard = None

    @property
    def stateless_chain(self) -> bool:
        """True when this query carries no cross-batch state (no window,
        aggregator, group-by, table or rate limiter): its rows for a
        micro-batch depend on that micro-batch alone, so the batch shard
        router (parallel/shard.py) may step micro-batches of one send on
        different devices (JAX query_runtime.py:803)."""
        sel = self.selector
        return (self.chain.window is None and not sel.aggregators and sel.group is None
                and self.rate_limiter is None and self.table_op is None and not self.tables)

    def init_state(self):
        return {"chain": self.chain.init_state(), "sel": self.selector.init_state()}

    def arm_lineage(self, cfg) -> None:
        """Record provenance (@app:lineage): the chain's probe and the
        step's lanes feed a SingleQueryLineage. Emissions are untouched; a
        grouped query's out rows carry their group key beside them (the
        rate limiter's `__group_key__` column, not part of the out
        schema)."""
        sel = self.selector
        grouped = sel.group is not None
        if grouped:
            sel.emit_group_key = True
        win = self.chain.window
        time_attr = getattr(win, "time_attr", None)

        def probe(flow: Flow) -> dict:
            b = flow.batch
            lanes = {LIN + "admit": b.valid & (b.kind == KIND_CURRENT)}
            if grouped:
                lanes[LIN + "key"] = sel.group.key_of(flow.env()).expand(b.valid.shape)
            if time_attr is not None:
                lanes[LIN + "wts"] = b.cols[time_attr].to(torch.int64)
            return lanes

        self.chain.lineage_probe = probe
        self.lineage = SingleQueryLineage(
            cfg, self.query_id, self._published_kinds(),
            input_stream=self.in_schema.stream_id, window=win, grouped=grouped,
            aggregated=bool(sel.aggregators),
            order_limited=bool(sel.order_by or sel.limit is not None or sel.offset is not None),
        )

    # ---- device program --------------------------------------------------

    def _step_impl(self, state, batch: EventBatch, now: torch.Tensor):
        flow = Flow(batch=batch, ref=self.ref, now=now)
        chain_state, flow = self.chain.apply(state["chain"], flow)
        sel_state, out = self.selector.apply(state["sel"], flow)
        self._apply_table_op(out, now, flow.aux)
        self._note_aux(flow.aux)
        if self.lineage is not None:
            lanes = dict(self.chain.probe_lanes)
            lanes[LIN + "in"] = batch.valid & (batch.kind == KIND_CURRENT)
            lanes[LIN + "in_ts"] = batch.ts
            lanes[LIN + "w_valid"] = flow.batch.valid
            lanes[LIN + "w_kind"] = flow.batch.kind
            lanes[LIN + "w_ts"] = flow.batch.ts
            lanes[LIN + "out_valid"] = out.valid
            lanes[LIN + "out_kind"] = out.kind
            if "__group_key__" in out.cols:
                lanes[LIN + "gkey"] = out.cols["__group_key__"]
            self._lin_sink.append((None, lanes))
        return {"chain": chain_state, "sel": sel_state}, out

    # ---- host side -------------------------------------------------------

    def receive(self, batch: EventBatch, now: int) -> EventBatch:
        ks = self._keyshard
        with self._receive_lock:
            if self.state is None:
                self.state = ks.init_state() if ks is not None else self.init_state()
            now_t = torch.full((), now, dtype=torch.int64, device=self.device)
            step = ks._step_impl if ks is not None else self._step_impl
            self.state, out = step(self.state, batch, now_t)
            if self.lineage is not None:
                self._lin_flush(now)  # under the receive lock: dispatch order
        return out
