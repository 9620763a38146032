"""Partitions: per-key isolated query state.

Reference: core/partition/PartitionRuntime.java:68-370 — `partition with (expr
of Stream) begin ... end` clones the inner query graph per key value and
routes events into per-key junctions; range partitions pick the first
matching condition (executor/RangePartitionExecutor).

The JAX package (siddhi_tpu/core/partition.py) gives each inner query's state
a leading [P] partition axis and runs its step under `jax.vmap`: every
partition sees the whole batch under a mask, and `_flatten` orders the
[P, K] output by output position first and partition slot second. The port
keeps the [P]-tiled state but runs the step in a keyed form: each row
carries its partition slot (from K7 `assign_slots` on the block's shared key
table), state is indexed by slot, and the step's rows come out already in
(position, slot) order — the arrival order for a windowless step, the
partitioned length window's own order after one (ops/partition.py, K29).
`#inner` streams carry the rows with their slot lane between the block's
queries. The work is O(B + P*W) a step, not the vmap's O(P*B).

Ported: value and range partitions over one or more streams sharing one key
table (`@app:partitionCapacity`, default 32; rows of keys past capacity are
dropped and logged once), and inside them single-stream queries with
filters, stream functions, projection, no window or a length, time,
timeLength, externalTime, lengthBatch, timeBatch or externalTimeBatch
window (K29, K31, K32), every aggregator, group-by (one table a partition,
K33), having, order-by and limit/offset within each partition, output rate
limiting over the flattened rows, output to a stream, a callback, an
`#inner` stream or a table (`insert into` only, as the JAX package, which
compiles an inner query with no table in scope). TIMER rows reach every
partition; a time-driven window's next timer is the earliest of all its
partitions'. Patterns and sequences run one NFA per key
(`PartitionedPatternQueryRuntime`): every route, state kind and stream
count of the unpartitioned query, each stream of the pattern keyed, the
token table [P]-tiled, a slot first allocated to a key refreshed to a
fresh table stamped with the step's clock, TIMER steps over every slot
holding a key (core/pattern_runtime.py `_keyed_step_impl`, K34-K37).
Joins run per key (`PartitionedJoinQueryRuntime`): two plain streams with
a key, or one stream joined with itself, each side's window [P]-tiled (no
window, length, externalTime, lengthBatch, sort, frequent or
lossyFrequent; time-driven sides refused as in JAX), a row probing only
its own slot's view of the other side (K38), the matches compacted per
slot and placed by (position, slot) (K39), the selector run per
partition. The sort, frequent, lossyFrequent and cron windows run keyed
by slot (K40-K43); a cron window's next fire comes from its expression
once for every partition, and its TIMER rows reach every slot.
`in <table>` conditions inside a partition raise JAX's KeyError (JAX
compiles an inner query with no table in scope); an `#inner` output of a
join or a pattern is refused as in JAX. Partitioned streams run per batch
(no fused endpoint). Under @app:lineage a partitioned query runs
unrecorded, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from siddhi_tpu_torch.core.errors import DefinitionNotExistError, SiddhiAppCreationError
from siddhi_tpu_torch.core.event import EventBatch, KIND_CURRENT, KIND_TIMER, StreamSchema
from siddhi_tpu_torch.core.executor import Env, Scope, TS_ATTR, compile_expression
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.groupby import GroupCtx, _as_key_col, partition_ctx
from siddhi_tpu_torch.core.join import DEFAULT_JOIN_CAPACITY, JoinQueryRuntime, NoWindow
from siddhi_tpu_torch.core.pattern import keyed_tok
from siddhi_tpu_torch.core.pattern_runtime import PatternPartition, PatternQueryRuntime
from siddhi_tpu_torch.core.query_runtime import QueryRuntime
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.core.windows import BatchWindow, SlidingWindow
from siddhi_tpu_torch.core.windows_special import (
    CronWindow,
    FrequentWindow,
    LossyFrequentWindow,
    SortWindow,
)
from siddhi_tpu_torch.ops.group import assign_slots
from siddhi_tpu_torch.query_api.execution import (
    DeleteStream,
    InsertIntoStream,
    JoinInputStream,
    Partition,
    Query,
    RangePartitionType,
    SingleInputStream,
    StateInputStream,
    UpdateOrInsertStream,
    UpdateStream,
    ValuePartitionType,
)

DEFAULT_PARTITIONS = 32
# the windows with a keyed step (K29, K31, K32, K40-K43)
_KEYED_WINDOWS = (SlidingWindow, BatchWindow, SortWindow, FrequentWindow, LossyFrequentWindow,
                  CronWindow)


def _refuse_in_tables(query, tables: dict) -> None:
    """An `in <table>` condition inside a partition: JAX compiles the inner
    query with no table in scope, so the first `in` it meets raises its
    KeyError (siddhi_tpu/core/executor.py:370). Only the output may name a
    table."""
    from siddhi_tpu_torch.core.table import collect_used_tables
    from siddhi_tpu_torch.query_api.expression import In

    if not collect_used_tables(dataclasses.replace(query, output_stream=None), tables):
        return

    def first_in(obj):
        if isinstance(obj, In):
            return obj
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
        elif isinstance(obj, (list, tuple)):
            items = obj
        elif isinstance(obj, dict):
            items = obj.values()
        else:
            return None
        for x in items:
            hit = first_in(x)
            if hit is not None:
                return hit
        return None

    hit = first_in(dataclasses.replace(query, output_stream=None))
    raise KeyError(f"'in {hit.source_id}': no such table in scope")


def _not_ported(what: str) -> SiddhiAppCreationError:
    return SiddhiAppCreationError(f"{what} inside a partition is not ported yet")


def _tile(tree, p: int):
    """Every leaf of a state tree with a leading [P] axis (a copy each)."""
    if isinstance(tree, dict):
        return {k: _tile(v, p) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tile(v, p) for v in tree)
    return tree.unsqueeze(0).repeat((p,) + (1,) * tree.dim())


def _reduce_paux(aux: dict, povf: Optional[torch.Tensor] = None) -> dict:
    """Fold the key table's overflow into a step's aux flags. The JAX
    package also min-reduces timers and ORs flags across its [P] vmapped
    lanes (`_reduce_paux`); the keyed steps' flags and next timer are
    already one value for all partitions."""
    if povf is not None:
        prev = aux.get("partition_overflow")
        aux["partition_overflow"] = povf if prev is None else prev | povf
    return aux


def _assign(ptable: dict, key_of: Callable, stream_id: str, batch: EventBatch,
            now: torch.Tensor):
    """Each row of a stream's batch to its slot on the shared key table (K7):
    (ptable', active [B], slot [B] int32 (P past capacity or for rows not
    taking part), the segment heads, the table's overflow flag). A row takes
    part when valid, CURRENT and matched by its key function."""
    cols = {(stream_id, None, n): c for n, c in batch.cols.items()}
    cols[(stream_id, None, TS_ATTR)] = batch.ts
    keys, matched = key_of(Env(cols, now=now))
    shape = batch.valid.shape
    active = batch.valid & (batch.kind == KIND_CURRENT) & matched.expand(shape)
    pk, pu, pn, slot, grp, povf = assign_slots(
        ptable["keys"], ptable["used"], ptable["n"], keys.expand(shape).contiguous(),
        active.contiguous(), torch.zeros_like(active))
    return {"keys": pk, "used": pu, "n": pn}, active, slot, grp, povf


class PartitionedQueryRuntime(QueryRuntime):
    """One single-stream query inside a partition, its state [P]-tiled.

    `key_of(env) -> (keys [B] int64, matched [B] bool)` routes an outer
    stream's batches; None means the input is an `#inner` stream whose rows
    arrive with their slot lane."""

    def __init__(self, query: Query, query_id: str, in_schema: StreamSchema, interner,
                 device, p_capacity: int, key_of: Optional[Callable], tables: dict,
                 group_capacity: Optional[int] = None):
        out = query.output_stream
        if isinstance(out, (UpdateStream, DeleteStream, UpdateOrInsertStream)):
            # the JAX package compiles an inner query's output with no table
            # in scope (siddhi_tpu/core/partition.py passes tables={}), so
            # only `insert into` reaches a table from a partition
            raise DefinitionNotExistError(f"'{out.target}' is not a defined table")
        super().__init__(query, query_id, in_schema, interner, device,
                         group_capacity=group_capacity, tables=tables)
        for kind, stage in self.chain.stages:
            if kind == "window" and not isinstance(stage, _KEYED_WINDOWS):
                raise _not_ported(f"window {type(stage).__name__}")
        self.p = int(p_capacity)
        # the key table's capacity: `p` grows past it when the partition
        # mesh pads the [P] axis with dead slots (parallel/shard.py)
        self.p_logical = self.p
        self.key_of = key_of
        self.stream_id = in_schema.stream_id
        # set when the query inserts into an #inner stream
        self.inner_publish: Optional[Callable] = None
        # the partition mesh's devices (`@app:shard`, parallel/shard.py
        # apply_partition_mesh), else None
        self.mesh_devices: Optional[list] = None

    def init_state(self):
        return _tile(super().init_state(), self.p)

    # ---- device ----------------------------------------------------------

    def _pstep_rows(self, state, batch: EventBatch, now: torch.Tensor, ctx: GroupCtx,
                    aux: dict):
        """The chain and the selector over every slot of `state`: (state',
        out, out_ctx, aux)."""
        flow = Flow(batch=batch, ref=self.ref, now=now, aux=aux, partition=ctx)
        chain_state, flow = self.chain.apply(state["chain"], flow)
        # (the selector hands on the slot lane of its rows in flow.partition)
        sel_state, out = self.selector.apply(state["sel"], flow)
        return {"chain": chain_state, "sel": sel_state}, out, flow.partition, flow.aux

    def _pstep(self, state, batch: EventBatch, now: torch.Tensor, ctx: GroupCtx, aux: dict):
        state, out, out_ctx, aux = self._pstep_rows(state, batch, now, ctx, aux)
        self._apply_table_op(out, now, aux)
        self._note_aux(aux)
        return state, out, out_ctx

    def _pstep_outer(self, ptable: dict, state, batch: EventBatch, now: torch.Tensor):
        """Outer-stream rows: key -> slot on the shared table; a row takes
        part when valid, CURRENT, matched and within capacity (TIMER rows
        pass to every partition, as the vmap's masks). On the partition mesh
        each shard steps its block of slots (parallel/mesh.py)."""
        if self.mesh_devices is not None:
            from siddhi_tpu_torch.parallel.mesh import replicated_step

            return replicated_step(self, self.mesh_devices, ptable, state, batch, now)
        ptable, active, slot, grp, povf = _assign(ptable, self.key_of, self.stream_id, batch,
                                                  now)
        is_timer = batch.valid & (batch.kind == KIND_TIMER)
        b2 = dataclasses.replace(batch, valid=(active & (slot < self.p)) | is_timer)
        ctx = partition_ctx(slot, grp.first, self.p, povf)
        state, out, out_ctx = self._pstep(state, b2, now, ctx, _reduce_paux({}, povf))
        return ptable, state, out, out_ctx

    # ---- host ------------------------------------------------------------

    def _now(self, now: int) -> torch.Tensor:
        return torch.full((), now, dtype=torch.int64, device=self.device)

    def receive_partitioned(self, ptable: dict, batch: EventBatch, now: int):
        """Outer-stream arrival. Returns (ptable', out, out_ctx)."""
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state()
            ptable, self.state, out, ctx = self._pstep_outer(ptable, self.state, batch,
                                                             self._now(now))
        return ptable, out, ctx

    def receive_inner(self, batch: EventBatch, ctx: GroupCtx, now: int):
        """`#inner` arrival: rows with their slot lane. Returns (out, out_ctx)."""
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state()
            self.state, out, ctx = self._pstep(self.state, batch, self._now(now), ctx, {})
        return out, ctx


class PartitionedJoinQueryRuntime(JoinQueryRuntime):
    """A join inside a partition: both sides' rows go to their key's slot
    on the block's key table and probe only that slot's window of the other
    side (reference: per-key cloned JoinStreamRuntimes; siddhi_tpu/core/
    partition.py PartitionedJoinQueryRuntime, a vmap over P lanes). Each
    side's window state and the selector's state are [P]-tiled; the keyed
    step (`CompiledJoin.step_partitioned`) emits the rows by (position,
    slot) with their slot lane, so the selector runs per partition.
    `key_of_by_side`: side ('l' / 'r') -> key function."""

    def __init__(self, query: Query, query_id: str, left_schema: StreamSchema,
                 right_schema: StreamSchema, interner, device, p_capacity: int,
                 key_of_by_side: dict, tables: dict, group_capacity: Optional[int] = None,
                 join_capacity: int = DEFAULT_JOIN_CAPACITY):
        out = query.output_stream
        if isinstance(out, (UpdateStream, DeleteStream, UpdateOrInsertStream)):
            # compiled with no table in scope, as the JAX package does
            raise DefinitionNotExistError(f"'{out.target}' is not a defined table")
        super().__init__(query, query_id, left_schema, right_schema, interner, device,
                         group_capacity=group_capacity, join_capacity=join_capacity, tables={})
        if self.scheduled_sides:
            raise SiddhiAppCreationError(
                "time windows on join sides inside partitions are not supported yet")
        for js in (self.join.left, self.join.right):
            if not isinstance(js.window, _KEYED_WINDOWS + (NoWindow,)):
                raise _not_ported(f"window {type(js.window).__name__} on a join side")
        self.p = int(p_capacity)
        self.key_of_by_side = key_of_by_side
        # `insert into` a table: applied to the flattened rows
        self._attach_tables(tables, interner)

    def init_state(self):
        return _tile(super().init_state(), self.p)

    def _pstep(self, ptable: dict, state, batch: EventBatch, now: torch.Tensor, side: str):
        """One side's batch: each row's key to its slot on the shared table
        (a row past capacity joins nothing and enters no window), then the
        keyed join step and the selector per partition."""
        js = self.join.left if side == "l" else self.join.right
        ptable, active, slot, grp, povf = _assign(ptable, self.key_of_by_side[side],
                                                  js.stream_id, batch, now)
        is_timer = batch.valid & (batch.kind == KIND_TIMER)
        b2 = dataclasses.replace(batch, valid=(active & (slot < self.p)) | is_timer)
        ctx = partition_ctx(slot, grp.first, self.p, povf)
        jstate, flow, aux = self.join.step_partitioned(state["join"], b2, now, side, ctx)
        _reduce_paux(aux, povf)
        sel_state, out = self.selector.apply(state["sel"], flow)
        self._apply_table_op(out, now, aux)
        self._note_aux(aux)
        self._join_overflow.note(aux["join_overflow"])
        self._join_overflow.poll()
        return ptable, {"join": jstate, "sel": sel_state}, out

    def receive_partitioned(self, ptable: dict, batch: EventBatch, now: int, side: str):
        """A batch of one side's stream. Returns (ptable', out)."""
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state()
            now_t = torch.full((), now, dtype=torch.int64, device=self.device)
            ptable, self.state, out = self._pstep(ptable, self.state, batch, now_t, side)
        return ptable, out


class PartitionedPatternQueryRuntime(PatternQueryRuntime):
    """A pattern or sequence inside a partition: one NFA per key (reference:
    per-key cloned state runtimes, PartitionTestCase pattern/sequence
    coverage; siddhi_tpu/core/partition.py PartitionedPatternQueryRuntime).
    The token table, the selector's state and the TIMER clock are [P]-tiled;
    the keyed step (`_keyed_step_impl`) runs the route the unpartitioned
    query would take, over each slot's rows, and TIMER rows reach every
    slot. `key_fns`: stream id -> key function, one for every stream
    of the pattern."""

    def __init__(self, query: Query, query_id: str, schemas: dict, interner, device,
                 p_capacity: int, key_fns: dict, tables: dict,
                 group_capacity: Optional[int] = None, token_capacity: int = 128,
                 count_capacity: int = 8, batch_size: int = 64,
                 pattern_chunk: Optional[int] = None):
        out = query.output_stream
        if isinstance(out, (UpdateStream, DeleteStream, UpdateOrInsertStream)):
            # the JAX package compiles the inner pattern's output with no
            # table in scope (tables={}): only `insert into` reaches a table
            raise DefinitionNotExistError(f"'{out.target}' is not a defined table")
        super().__init__(query, query_id, schemas, interner, device,
                         group_capacity=group_capacity, token_capacity=token_capacity,
                         count_capacity=count_capacity, batch_size=batch_size,
                         pattern_chunk=pattern_chunk)
        self.p = int(p_capacity)
        for sid in self.prog.stream_ids:
            if sid not in key_fns:
                raise SiddhiAppCreationError(f"partition has no key for pattern stream '{sid}'")
        self.key_fns = key_fns
        # `insert into` a table: applied to the flattened rows, every
        # partition's into the one shared table (JAX _attach_table_output)
        self._attach_tables(tables, interner)

    def init_state(self, now: int = 0) -> dict:
        return _tile(super().init_state(now), self.p)

    def _now(self, now: int) -> torch.Tensor:
        return torch.full((), now, dtype=torch.int64, device=self.device)

    def receive_partitioned(self, ptable: dict, batch: EventBatch, now: int, stream_id: str):
        """A batch of one of the pattern's streams: each row's key to its
        slot on the shared table, a slot first used now refreshed, then the
        keyed step. Returns (ptable', out)."""
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state()
            now_t = self._now(now)
            new_table, _active, slot, _grp, povf = _assign(ptable, self.key_fns[stream_id],
                                                           stream_id, batch, now_t)
            pu = new_table["used"]
            pctx = PatternPartition(slot=slot, used=pu, fresh=pu & ~ptable["used"], p=self.p,
                                    overflow=povf)
            self.state, out, _ctx = self._keyed_step_impl(self.state, batch, now_t, stream_id,
                                                          pctx)
        return new_table, out

    def receive_timer_partitioned(self, ptable: dict, t_ms: int) -> EventBatch:
        """One TIMER step at t_ms over every slot, its rows and timers
        masked to the slots holding a key (as the JAX package's vmap: a slot
        that another query of the block allocates first is not refreshed
        by this one, so it must have been stepped)."""
        dev = self.device
        batch = EventBatch(ts=torch.full((1,), t_ms, dtype=torch.int64, device=dev),
                           kind=torch.full((1,), KIND_TIMER, dtype=torch.int8, device=dev),
                           valid=torch.ones(1, dtype=torch.bool, device=dev), cols={})
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state(t_ms)
            pctx = PatternPartition(slot=torch.full((1,), self.p, dtype=torch.int32, device=dev),
                                    used=ptable["used"], fresh=None, p=self.p,
                                    overflow=torch.zeros((), dtype=torch.bool, device=dev))
            self.state, out, _ctx = self._keyed_step_impl(self.state, batch, self._now(t_ms),
                                                          None, pctx)
        return out

    def prime(self, now: int) -> dict:
        """The earliest deadline over every slot's token table, used or not
        (as the JAX package's prime, partition.py:399-407): arms an
        absent-at-start pattern's timer before any event."""
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state(now)
            t = self.prog.next_timer(keyed_tok(self.state["tok"]))
        return {"next_timer": t}

    def describe_state(self) -> dict:
        d = super().describe_state() if self.state is None else None
        if d is not None:
            return d
        prog = self.prog
        d = {"kind": type(self).__name__, "callbacks": len(self.query_callbacks),
             "rate_limited": self.rate_limiter is not None, "tables": sorted(self.tables),
             "token_capacity": prog.T, "partitions": self.p}
        with self._receive_lock:
            tok = keyed_tok(self.state["tok"])
            active = tok["active"].cpu().numpy()
            slot = tok["slot"].cpu().numpy()
        d["states"] = [{"refs": [a.ref for a in s.atoms], "absent": s.is_absent,
                        "count": [s.min_count, s.max_count] if s.is_count else None,
                        "active": int(((slot == i) & active).sum())}
                       for i, s in enumerate(prog.slots)]
        d["active_instances"] = int(active.sum())
        return d


class PartitionRuntime:
    """Host orchestration of one `partition with (...) begin ... end` block."""

    def __init__(self, partition: Partition, app_runtime, pid: str, query_ids: list):
        self.partition = partition
        self.app = app_runtime
        self.pid = pid
        self.p = app_runtime._capacity_annotation("app:partitionCapacity", DEFAULT_PARTITIONS)
        if self.p < 1:
            raise SiddhiAppCreationError(f"partition capacity must be >= 1, got {self.p}")
        dev = app_runtime.device

        # key executors per partitioned stream (reference:
        # Value/RangePartitionExecutor)
        self.key_fns: dict[str, Callable] = {}
        for pt in partition.partition_types:
            schema = app_runtime.stream_schemas.get(pt.stream_id)
            if schema is None:
                raise SiddhiAppCreationError(f"partition: stream '{pt.stream_id}' is not defined")
            scope = Scope(app_runtime.interner, dev)
            scope.add_stream(pt.stream_id, schema.attr_types)
            if isinstance(pt, ValuePartitionType):
                ce = compile_expression(pt.expression, scope)
                if ce.type is AttrType.OBJECT:
                    raise SiddhiAppCreationError("cannot partition by OBJECT")

                def key_of(env, _ce=ce):
                    k = _as_key_col(_ce(env), _ce.type)
                    return k, torch.ones((), dtype=torch.bool, device=k.device)

            else:
                assert isinstance(pt, RangePartitionType)
                conds = []
                for rp in pt.ranges:
                    c = compile_expression(rp.condition, scope)
                    if c.type is not AttrType.BOOL:
                        raise SiddhiAppCreationError("range partition conditions must be boolean")
                    conds.append(c)

                def key_of(env, _conds=tuple(conds)):
                    # the first matching range wins; unmatched rows are dropped
                    key, matched = None, None
                    for i, c in enumerate(_conds):
                        m = c(env)
                        if key is None:
                            key = torch.where(m, i, -1).to(torch.int64)
                            matched = m
                        else:
                            key = torch.where(~matched & m, i, key)
                            matched = matched | m
                    return key, matched

            self.key_fns[pt.stream_id] = key_of

        # the block's shared key table (reference: PartitionRuntime's per-key
        # instance map)
        self.ptable = {
            "keys": torch.zeros(self.p, dtype=torch.int64, device=dev),
            "used": torch.zeros(self.p, dtype=torch.bool, device=dev),
            "n": torch.zeros((), dtype=torch.int32, device=dev),
        }
        self.inner_schemas: dict[str, StreamSchema] = {}
        self.inner_subscribers: dict[str, list] = {}
        self.queries: list[PartitionedQueryRuntime] = []
        for qid, q in query_ids:
            self._add_query(qid, q)

    def _add_query(self, qid: str, query: Query) -> None:
        app = self.app
        stream = query.input_stream
        if isinstance(stream, JoinInputStream):
            self._add_join_query(qid, query)
            return
        if isinstance(stream, StateInputStream):
            self._add_pattern_query(qid, query)
            return
        if not isinstance(stream, SingleInputStream):
            raise _not_ported(f"a {type(stream).__name__} query")
        if qid in app.queries:
            raise SiddhiAppCreationError(f"duplicate query name '{qid}'")
        # the JAX package compiles an inner query with no table in scope:
        # only its output may name a table
        _refuse_in_tables(query, app.tables)
        if stream.is_inner:
            in_schema = self.inner_schemas.get(stream.stream_id)
            if in_schema is None:
                raise SiddhiAppCreationError(
                    f"inner stream '#{stream.stream_id}' is not produced by an earlier query "
                    "in this partition")
            key_of = None
        else:
            in_schema = app.stream_schemas.get(stream.stream_id)
            if in_schema is None:
                raise SiddhiAppCreationError(f"stream '{stream.stream_id}' is not defined")
            key_of = self.key_fns.get(stream.stream_id)
            if key_of is None:
                raise SiddhiAppCreationError(
                    f"partition has no key for stream '{stream.stream_id}'")
        qr = PartitionedQueryRuntime(query, qid, in_schema, app.interner, app.device,
                                     p_capacity=self.p, key_of=key_of, tables=app.tables,
                                     group_capacity=app.group_capacity)
        self.queries.append(qr)
        app.queries[qid] = qr

        out = query.output_stream
        if isinstance(out, InsertIntoStream) and out.is_inner:
            self.inner_schemas[out.target] = StreamSchema(out.target, qr.out_schema.attrs)
            subs = self.inner_subscribers.setdefault(out.target, [])
            from siddhi_tpu_torch.core.app_runtime import _make_insert_transform

            # `insert [current|expired|all] events into #T`: the kinds kept,
            # then rewritten to CURRENT, as the outer insert path
            transform = _make_insert_transform(out.output_events)

            def publish_inner(batch, ctx, now, _subs=subs, _t=transform):
                batch = _t(batch)
                for fn in _subs:
                    fn(batch, ctx, now)

            qr.inner_publish = publish_inner
        else:
            app._wire_insert(qr)

        if stream.is_inner:
            def recv_inner(batch, ctx, now, _qr=qr):
                out_b, out_ctx = _qr.receive_inner(batch, ctx, now)
                self._route(_qr, out_b, out_ctx, now)
                self._arm(_qr, _qr.next_timer)

            self.inner_subscribers[stream.stream_id].append(recv_inner)
            if qr.uses_scheduler:
                # a TIMER row reaches every slot of the #inner input (the JAX
                # package tiles it across the partition axis)
                def fire_inner(t_ms: int, _qr=qr, _schema=in_schema) -> None:
                    batch = app._timer_batch(_schema, t_ms)
                    ctx = partition_ctx(torch.full((1,), self.p, dtype=torch.int32,
                                                   device=app.device),
                                        torch.zeros(1, dtype=torch.int32, device=app.device),
                                        self.p, torch.zeros((), dtype=torch.bool,
                                                            device=app.device))
                    with app._process_lock:
                        recv_inner(batch, ctx, t_ms)

                qr.timer_targets["in"] = fire_inner
        else:
            def receive(batch: EventBatch, now: int, _qr=qr) -> None:
                with app._process_lock:
                    self.ptable, out_b, out_ctx = _qr.receive_partitioned(self.ptable, batch, now)
                    self._route(_qr, out_b, out_ctx, now)
                    next_timer = _qr.next_timer
                self._arm(_qr, next_timer)

            # no fused endpoint: the stream runs per batch
            app._junction(stream.stream_id).subscribe(receive)
            if qr.uses_scheduler:
                # one TIMER row through the key routing: it takes part in
                # every partition (siddhi_tpu/core/partition.py `fire`)
                def fire(t_ms: int, _schema=in_schema) -> None:
                    receive(app._timer_batch(_schema, t_ms), t_ms)

                qr.timer_targets["in"] = fire

    def _add_join_query(self, qid: str, query: Query) -> None:
        """A join inside the block (JAX PartitionRuntime._add_join_query,
        partition.py:708-765): both sides plain streams with a key; a
        self-join runs its left side then its right on each batch, each
        assigning slots on the shared table in turn."""
        app = self.app
        if getattr(query.output_stream, "is_inner", False):
            raise SiddhiAppCreationError(
                "#inner outputs from joins/patterns inside partitions are not supported yet")
        join = query.input_stream
        schemas, key_by_side = [], {}
        for side, s in (("l", join.left), ("r", join.right)):
            if s.is_inner:
                raise SiddhiAppCreationError(
                    "#inner streams on join sides inside partitions are not supported yet")
            sch = app.stream_schemas.get(s.stream_id)
            if sch is None:
                raise SiddhiAppCreationError("only plain streams can join inside partitions")
            kf = self.key_fns.get(s.stream_id)
            if kf is None:
                raise SiddhiAppCreationError(f"partition has no key for stream '{s.stream_id}'")
            key_by_side[side] = kf
            schemas.append(sch)
        if qid in app.queries:
            raise SiddhiAppCreationError(f"duplicate query name '{qid}'")
        _refuse_in_tables(query, app.tables)
        qr = PartitionedJoinQueryRuntime(
            query, qid, schemas[0], schemas[1], app.interner, app.device, p_capacity=self.p,
            key_of_by_side=key_by_side, tables=app.tables, group_capacity=app.group_capacity,
            join_capacity=app.join_capacity)
        self.queries.append(qr)
        app.queries[qid] = qr
        app._wire_insert(qr)

        def receive_side(batch: EventBatch, now: int, side: str, _qr=qr) -> None:
            with app._process_lock:
                self.ptable, out_b = _qr.receive_partitioned(self.ptable, batch, now, side)
                _qr.route_output(out_b, now, app._decode)

        # no fused endpoint: each stream runs per batch
        if join.left.stream_id == join.right.stream_id:
            app._junction(join.left.stream_id).subscribe(
                lambda b, now: (receive_side(b, now, "l"), receive_side(b, now, "r")))
        else:
            for side, s in (("l", join.left), ("r", join.right)):
                app._junction(s.stream_id).subscribe(
                    lambda b, now, _s=side: receive_side(b, now, _s))

    def _add_pattern_query(self, qid: str, query: Query) -> None:
        """A pattern or sequence inside the block (JAX
        PartitionRuntime._add_pattern_query, partition.py:769-826): every
        stream of the pattern needs a key; its rows leave the partition
        flattened, to a stream, a callback or a table."""
        app = self.app
        if getattr(query.output_stream, "is_inner", False):
            raise SiddhiAppCreationError(
                "#inner outputs from joins/patterns inside partitions are not supported yet")
        from siddhi_tpu_torch.query_api.execution import iter_state_streams

        for s in iter_state_streams(query.input_stream.state):
            if s.stream_id not in app.stream_schemas:
                raise SiddhiAppCreationError(
                    f"query '{qid}': pattern stream '{s.stream_id}' is not defined (patterns "
                    "consume streams, not tables or windows)")
        if qid in app.queries:
            raise SiddhiAppCreationError(f"duplicate query name '{qid}'")
        _refuse_in_tables(query, app.tables)
        qr = PartitionedPatternQueryRuntime(
            query, qid, app.stream_schemas, app.interner, app.device, p_capacity=self.p,
            key_fns=self.key_fns, tables=app.tables, group_capacity=app.group_capacity,
            token_capacity=app._capacity_annotation("app:patternCapacity", 128),
            count_capacity=app._capacity_annotation("app:countCapacity", 8),
            batch_size=app.batch_size,
            pattern_chunk=app._capacity_annotation("app:patternChunk", 0) or None)
        self.queries.append(qr)
        app.queries[qid] = qr
        app._wire_insert(qr)

        def receive(batch: EventBatch, now: int, sid: str, _qr=qr) -> None:
            with app._process_lock:
                self.ptable, out_b = _qr.receive_partitioned(self.ptable, batch, now, sid)
                _qr.route_output(out_b, now, app._decode)
                next_timer = _qr.next_timer
            app._schedule_at(next_timer, _qr.timer_targets.get("timer"))

        # no fused endpoint: each stream runs per batch
        for sid in qr.prog.stream_ids:
            app._junction(sid).subscribe(lambda b, now, _sid=sid: receive(b, now, _sid))
        if qr.uses_scheduler:
            # absent deadlines: a one-row TIMER step over every slot
            def fire(t_ms: int, _qr=qr) -> None:
                with app._process_lock:
                    out_b = _qr.receive_timer_partitioned(self.ptable, t_ms)
                    _qr.route_output(out_b, t_ms, app._decode)
                    next_timer = _qr.next_timer
                app._schedule_at(next_timer, _qr.timer_targets.get("timer"))

            qr.timer_targets["timer"] = fire

    def _arm(self, qr: PartitionedQueryRuntime, next_timer) -> None:
        """Schedule a query's next TIMER step: a cron window's next fire
        from its expression (one for every partition), else the step's
        next timer."""
        target = qr.timer_targets.get("in")
        if qr.host_next_timer is not None:
            self.app._notify(qr.host_next_timer(self.app.clock()), target)
        else:
            self.app._schedule_at(next_timer, target)

    def _route(self, qr: PartitionedQueryRuntime, out: EventBatch, ctx: GroupCtx,
               now: int) -> None:
        if qr.inner_publish is not None:
            qr.inner_publish(out, ctx, now)
            # callbacks on an inner-targeted query still see its rows
            if qr.query_callbacks:
                qr.route_output(out, now, self.app._decode)
        else:
            qr.route_output(out, now, self.app._decode)
