"""Pattern/sequence query runtime: the NFA token table and the selector as
one step per input stream.

Reference analog: the per-query object graph of
util/parser/StateInputStreamParser.java + QueryParser.java for state
streams, with a Pattern*ProcessStreamReceiver per input stream. As in the
JAX package (siddhi_tpu/core/pattern_runtime.py), each input stream gets its
own step `(state, batch, now) -> (state', out)` over the shared token table.
A pattern that takes a batch route (`fast_path_ok`: simple chains with
`every` at the first slot; `count_fast_ok`: a count state at the first
slot) cuts the batch into chunks (padded with invalid rows to a whole
number of them), and each chunk runs the route (core/pattern.py) on device
tensors with no host read. Every other pattern — logical and absent states,
counts elsewhere or under `within`, multi-stream sequences, every-blocks —
takes the per-event scan: one `pattern_scan` over the batch's rows (JAX
`_make_step`'s lax.scan of `apply_event`), and a one-row TIMER step
(`receive_timer`) at each absent deadline the scheduler fires.
Completions collect in one emission buffer, and the selector projects it.

Inside a partition (`_keyed_step_impl`, the JAX package's vmap of the step
over P partition lanes) the token table is [P]-tiled and each row carries
its partition slot: the batch routes run chunk by chunk over the whole
batch with only the slots that have rows in the chunk (K34-K36), the scan
runs every used slot over its rows, and every slot over the TIMER rows
(K37), and each slot's completions are placed by (position, slot) before
the selector, which keys its state by the slot.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import KIND_CURRENT, KIND_TIMER, EventBatch, StreamSchema
from siddhi_tpu_torch.core.executor import TS_ATTR
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core import pattern as pattern_mod
from siddhi_tpu_torch.core.groupby import partition_ctx
from siddhi_tpu_torch.core.pattern import (
    NO_TIMER,
    PatternEmission,
    PatternProgram,
    keyed_out,
    keyed_tok,
    partition_pattern_advance,
    partition_pattern_count,
    partition_pattern_emit,
    partition_pattern_scan,
    pattern_scan,
    tiled_tok,
)
from siddhi_tpu_torch.core.query_runtime import BaseQueryRuntime, _FlagWatch
from siddhi_tpu_torch.core.selector import CompiledSelector
from siddhi_tpu_torch.core.types import InternTable
from siddhi_tpu_torch.observability.lineage import LIN, PatternQueryLineage
from siddhi_tpu_torch.ops.partition import partition_rows, pattern_chunks, pattern_place
from siddhi_tpu_torch.query_api.execution import Query, StateInputStream


@dataclasses.dataclass
class PatternPartition:
    """A keyed step's partition context: each row's slot [B] int32 (P: no
    partition), the slots holding a key after the step (`used` [P] bool),
    the slots first allocated by it (`fresh` [P] bool, None: none), the
    capacity P and the key table's overflow flag (0-d bool)."""

    slot: torch.Tensor
    used: torch.Tensor
    fresh: Optional[torch.Tensor]
    p: int
    overflow: torch.Tensor


class PatternQueryRuntime(BaseQueryRuntime):
    def __init__(self, query: Query, query_id: str, schemas: dict[str, StreamSchema],
                 interner: InternTable, device, group_capacity: Optional[int] = None,
                 token_capacity: int = 128, count_capacity: int = 8, batch_size: int = 64,
                 pattern_chunk: Optional[int] = None):
        self.query = query
        self.query_id = query_id
        self.device = torch.device(device)
        state_stream = query.input_stream
        assert isinstance(state_stream, StateInputStream)
        prog = self.prog = PatternProgram(state_stream, schemas, interner, self.device,
                                          token_capacity=token_capacity,
                                          count_capacity=count_capacity)
        # the route (JAX _make_step :143-170): a batch route when one fits,
        # else the per-event scan (FORCE_SCAN, read here, forces the scan:
        # the batch routes' oracle). The batch routes' chunk: half the token
        # table on the fast route, so lanes freed by one chunk's completions
        # serve the next chunk's forks; T * min count on the count route
        # (@app:patternChunk overrides)
        self._scan = pattern_mod.FORCE_SCAN or not (prog.fast_path_ok or prog.count_fast_ok)
        if self._scan:
            self._kernel = self._chunk = None
        elif prog.fast_path_ok:
            self._kernel, self._chunk = prog.apply_batch_fast, max(1, prog.T // 2)
        else:
            m0 = max(1, prog.slots[0].min_count)
            self._kernel = prog.apply_batch_count
            self._chunk = pattern_chunk or max(1, prog.T * m0)
        # the emission buffer scales with the token table: every pending
        # token can complete on one event
        self.out_cap = max(batch_size, 64, token_capacity)

        # select * over a pattern exposes every ref's attributes in order
        flat_attrs, seen, dup = [], set(), set()
        for a in prog.refs:
            for name, t in schemas[a.stream_id].attrs:
                if name in seen:
                    dup.add(name)
                else:
                    seen.add(name)
                    flat_attrs.append((name, t))
        if query.selector.select_all and dup:
            raise SiddhiAppCreationError(
                f"select * over this pattern is ambiguous for {sorted(dup)}; project explicitly")
        # the selector resolves against a CHILD scope, so its keys (with the
        # cross-ref condition reads) decide which capture lanes exist
        sel_scope = prog.scope.child()
        self.selector = CompiledSelector(query.selector, sel_scope, flat_attrs,
                                         group_capacity=group_capacity)
        self._sel_used_keys = frozenset(sel_scope.used_keys)
        prog.set_capture_readers(self._sel_used_keys)
        if self._scan:
            prog.compile_scan()
        self._setup_output(query, query_id)
        self._scope = prog.scope
        # absent states wait on timers: the app runtime wires the TIMER step
        # and keeps the query off the fused path
        self.uses_scheduler = prog.needs_scheduler
        self._pattern_overflow = _FlagWatch(self.device, self._log_pattern_overflow)

    def arm_lineage(self, cfg) -> None:
        """Record provenance (@app:lineage): every ref's captured-timestamp
        lane is kept (the emission buffer then says, per match, which input
        row filled each linearized slot) and surfaced as `__lin.*` lanes
        feeding a PatternQueryLineage. Before the first step; emissions are
        untouched."""
        prog = self.prog
        prog.widen_capture_readers(
            self._sel_used_keys | {(a.ref, None, TS_ATTR) for a in prog.refs})
        self.lineage = PatternQueryLineage(cfg, self.query_id, self._published_kinds(),
                                           refs=[(a.ref, a.stream_id) for a in prog.refs])

    def init_state(self, now: int = 0) -> dict:
        return {
            "tok": self.prog.init_state(now),
            "sel": self.selector.init_state(),
            # the max TIMER timestamp processed: next_timer never re-arms a
            # deadline at or before it, and late rows fire deadlines by it
            "timer_ts": torch.full((), -(1 << 62), dtype=torch.int64, device=self.device),
        }

    # ---- device program --------------------------------------------------

    def _step_impl(self, state, batch: EventBatch, now: torch.Tensor, stream_id: Optional[str]):
        """One step over `batch` of `stream_id` (None: a TIMER batch)."""
        prog = self.prog
        dev = self.device
        out = prog.init_out(self.out_cap)
        out_n = torch.zeros((), dtype=torch.int32, device=dev)
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        timer_ts = state["timer_ts"]
        if self._scan:
            ev, rmask, regs = prog.scan_inputs(stream_id, batch)
            tok, out, out_n, ovf = pattern_scan(prog, state["tok"], stream_id, batch.ts,
                                                batch.kind, batch.valid, ev, rmask, regs, out,
                                                out_n, ovf, timer_ts)
            timer_rows = batch.valid & (batch.kind == KIND_TIMER)
            floor = torch.full((), -(1 << 62), dtype=torch.int64, device=dev)
            timer_ts = torch.maximum(timer_ts, torch.where(timer_rows, batch.ts, floor).max())
        else:
            tok, ovf = self._chunk_loop(state["tok"], batch, now, stream_id, out, out_n, ovf)
        emit = EventBatch(ts=out["ts"], kind=torch.zeros_like(out["ts"], dtype=torch.int8),
                          valid=out["valid"], cols={})
        flow = Flow(batch=emit, ref=prog.refs[0].ref, now=now, extra_cols=prog.out_env_cols(out))
        sel_state, out_batch = self.selector.apply(state["sel"], flow)
        self._note_aux(flow.aux)
        if self.uses_scheduler:
            self.next_timer = prog.next_timer(tok, after=timer_ts)
        self._pattern_overflow.note(ovf)
        self._pattern_overflow.poll()
        if self.lineage is not None:
            # the emission buffer's per-ref capture timestamps (arm_lineage
            # kept every ref's ts lane)
            lanes = {LIN + "out_valid": out_batch.valid, LIN + "out_kind": out_batch.kind,
                     LIN + "out_ts": out_batch.ts,
                     LIN + "in": batch.valid & (batch.kind == KIND_CURRENT),
                     LIN + "in_ts": batch.ts}
            for i, a in enumerate(prog.refs):
                lanes[f"{LIN}p_n{i}"] = out[f"n{a.ref_idx}"]
                if f"ts{a.ref_idx}" in out:
                    lanes[f"{LIN}p_ts{i}"] = out[f"ts{a.ref_idx}"]
            self._lin_sink.append((stream_id, lanes))
        return {"tok": tok, "sel": sel_state, "timer_ts": timer_ts}, out_batch

    def _chunk_loop(self, tok, batch: EventBatch, now, stream_id: str, out, out_n, ovf):
        """A batch route over the batch's chunks (out and out_n in place);
        returns (tok', overflow')."""
        B = batch.capacity
        C = min(B, self._chunk)
        pad = (-B) % C
        if pad:  # invalid rows up to a whole number of chunks

            def padded(x):
                return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                                 device=x.device)])

            batch = EventBatch(ts=padded(batch.ts), kind=padded(batch.kind),
                               valid=padded(batch.valid),
                               cols={n: padded(c) for n, c in batch.cols.items()})
            B += pad
        k = B // C
        ts, kind, valid = batch.ts.view(k, C), batch.kind.view(k, C), batch.valid.view(k, C)
        cols = {n: c.view(k, C) for n, c in batch.cols.items()}
        for i in range(k):
            tok, out, out_n, ovf = self._kernel(
                tok, ts[i], kind[i], valid[i], {stream_id: {n: c[i] for n, c in cols.items()}},
                out, out_n, ovf, now)
        return tok, ovf

    # ---- the keyed step inside a partition --------------------------------

    def _keyed_step_impl(self, state, batch: EventBatch, now: torch.Tensor,
                         stream_id: Optional[str], pctx: "PatternPartition"):
        """One step of every partition's NFA at once (the JAX package's vmap
        of `_make_step`, siddhi_tpu/core/partition.py:326-376 and :378):
        the fresh lanes refreshed, the route over each slot's rows (and
        every TIMER row), the emissions placed by (position, slot), the
        selector over them with the slot lane in Flow.partition. state:
        the [P]-tiled tree; pctx: the rows' slots, the used and fresh
        slots. Returns (state', out, out partition context)."""
        prog = self.prog
        p, T = pctx.p, prog.T
        dev = self.device
        state = self._refresh(state, pctx.fresh, now, p)
        tok = keyed_tok(state["tok"])
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        timer_ts = state["timer_ts"]
        if self._scan:
            ev, rmask, regs = prog.scan_inputs(stream_id, batch)
            rows = partition_rows(batch, pctx.slot, p)
            timer_rows = batch.valid & (batch.kind == KIND_TIMER)
            # TIMER rows step every slot, used or not, as under the vmap: a
            # slot that another query of the block allocates first is not
            # fresh for this one, and starts from the lanes those steps made
            walk = pctx.used | timer_rows.any()
            # a first guess of each used slot's emissions (the others' rows
            # are dropped, as the vmap masks them)
            caps = torch.where(pctx.used, torch.clamp(2 * rows.rows.to(torch.int64) + 8,
                                                      max=self.out_cap), 0)
            while True:
                emis = keyed_out(prog, caps, self.out_cap)
                tok2 = partition_pattern_scan(prog, tok, stream_id, batch.ts, batch.kind,
                                              batch.valid, ev, rmask, regs, rows, walk, emis,
                                              ovf, timer_ts)
                if not bool(((emis.n > emis.cap) & pctx.used).any()):
                    break
                # a slot emitted past its stretch: again with the room it took
                caps = torch.where(pctx.used, torch.maximum(emis.n, emis.cap), 0)
                ovf.zero_()
            tok = tok2
            emis.n = torch.where(pctx.used, emis.n, 0)
            floor = torch.full((), -(1 << 62), dtype=torch.int64, device=dev)
            timer_ts = torch.maximum(timer_ts, torch.where(timer_rows, batch.ts, floor).max())
        else:  # in place, on the lanes the refresh made
            emis = self._keyed_chunk_loop(tok, batch, now, stream_id, pctx, ovf)
        flat, out_slot, out_first = pattern_place(emis.out, emis.off, emis.cap, emis.n, p)
        emit = EventBatch(ts=flat["ts"], kind=torch.zeros_like(flat["ts"], dtype=torch.int8),
                          valid=flat["valid"], cols={})
        ctx = partition_ctx(out_slot, out_first, p, pctx.overflow)
        aux = {"partition_overflow": pctx.overflow}
        flow = Flow(batch=emit, ref=prog.refs[0].ref, now=now, extra_cols=prog.out_env_cols(flat),
                    aux=aux, partition=ctx)
        sel_state, out_batch = self.selector.apply(state["sel"], flow)
        self._apply_table_op(out_batch, now, flow.aux)
        self._note_aux(flow.aux)
        if self.uses_scheduler:
            # only slots holding a live key schedule (the vmap's mask)
            self.next_timer = prog.next_timer(tok, after=timer_ts.repeat_interleave(T),
                                              live=pctx.used.repeat_interleave(T))
        self._pattern_overflow.note(ovf)
        self._pattern_overflow.poll()
        new_state = {"tok": tiled_tok(tok, p), "sel": sel_state, "timer_ts": timer_ts}
        return new_state, out_batch, flow.partition

    def _refresh(self, state, fresh: Optional[torch.Tensor], now: torch.Tensor, p: int):
        """A slot allocated to a key for the first time starts from the
        whole lane state of `init_state(now)` (token table, selector, timer
        clock), as the JAX package's refresh (partition.py:338-353): its
        absence windows run from its key's first step, not app start."""
        if fresh is None:
            return state
        init = PatternQueryRuntime.init_state(self, now)  # one lane

        def refresh(cur, new):
            if isinstance(cur, dict):
                return {k: refresh(cur[k], new[k]) for k in cur}
            if isinstance(cur, (list, tuple)):
                return type(cur)(refresh(a, b) for a, b in zip(cur, new))
            mask = fresh.reshape((p,) + (1,) * (cur.dim() - 1))
            return torch.where(mask, new.unsqueeze(0).to(cur.dtype), cur)

        return refresh(state, init)

    def _keyed_chunk_loop(self, tok, batch: EventBatch, now, stream_id: str,
                          pctx: "PatternPartition", ovf) -> PatternEmission:
        """A batch route keyed by slot (K34-K36), chunk by chunk over the
        whole padded batch as the vmap cuts it; tok ([P*T]) and ovf in
        place. Returns the emission buffer."""
        ch, caps, inputs = self.keyed_chunk_inputs(batch, now, stream_id, pctx)
        emis = keyed_out(self.prog, caps, self.out_cap)
        entry_row = torch.full((pctx.p * self.prog.T,), -1, dtype=torch.int32, device=self.device)
        for i in range(ch.k):
            self.keyed_chunk(i, tok, entry_row, ch, inputs, emis, now, ovf)
        return emis

    def keyed_chunk_inputs(self, batch: EventBatch, now, stream_id: str,
                           pctx: "PatternPartition"):
        """The keyed batch route's inputs: (chunks, the emission stretch of
        each slot, the row inputs): the batch padded to whole chunks of C
        rows with its member rows listed per chunk (ops/partition.py
        `pattern_chunks`), each NFA slot's stream columns, the conditions
        that read only the row evaluated once over the batch, and the count
        route's two row masks."""
        prog = self.prog
        p, T = pctx.p, prog.T
        dev = self.device
        B = batch.capacity
        C = min(B, self._chunk)
        pad = (-B) % C
        member = batch.valid & (batch.kind == KIND_CURRENT) & (pctx.slot >= 0) & (pctx.slot < p)

        def padded(x):
            if not pad:
                return x
            return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=dev)])

        ts, v = padded(batch.ts), padded(member)
        slot = torch.where(v, padded(pctx.slot), p).to(torch.int32)
        cols = {n: padded(c) for n, c in batch.cols.items()}
        ch = pattern_chunks(ts, v, slot, C, p)
        # a slot completes at most its T tokens and one new token a row
        caps = torch.clamp(ch.rows.to(torch.int64) + T, max=self.out_cap)
        evs = [cols if s.atoms[0].stream_id == stream_id else None for s in prog.slots]
        # a condition that reads only the row: once over the batch
        ones = torch.ones_like(v)
        row_cond = {}
        for q, st in enumerate(prog.slots):
            atom = st.atoms[0]
            keys = prog._cond_keys[(q, atom.ref_idx)]
            if evs[q] is not None and all(k[0] == atom.ref and k[1] is None for k in keys):
                row_cond[q] = prog.row_mask(q, cols, ts, now, ones).reshape(1, -1)
        masks = []
        if self._kernel == prog.apply_batch_count:
            masks = [torch.zeros_like(v) if evs[q] is None else prog.row_mask(q, cols, ts, now, v)
                     for q in (0, 1)]
        return ch, caps, {"ts": ts, "cols": cols, "evs": evs, "row_cond": row_cond,
                          "masks": masks}

    def keyed_chunk(self, i: int, tok, entry_row, ch, inputs: dict, emis: PatternEmission, now,
                    ovf, impl=None) -> None:
        """Chunk i of the keyed batch route: the count pass (K35) on the
        count route, the slot passes (K34), the completions (K36). impl:
        {"advance", "count", "emit"} in place of the wrappers (the card's
        check holds each kernel against its plain version with it)."""
        prog = self.prog
        impl = impl or {"advance": partition_pattern_advance, "count": partition_pattern_count,
                        "emit": partition_pattern_emit}
        evs = inputs["evs"]

        def cond_of(q):
            return self.keyed_cond(q, i, tok, ch, inputs, now)

        fast = self._kernel == prog.apply_batch_fast
        if not fast:
            impl["count"](prog, tok, entry_row, ch, i, inputs["masks"][0], inputs["masks"][1],
                          evs[0], evs[1], ovf)
        for q in range(0 if fast else 2, len(prog.slots)):
            if evs[q] is not None:
                impl["advance"](prog, q, tok, entry_row, ch, i, evs[q], cond_of(q), ovf,
                                tail=not fast)
        impl["emit"](prog, tok, entry_row, ch, i, now, emis, ovf, purge=fast)

    def keyed_cond(self, q: int, i: int, tok, ch, inputs: dict, now):
        """NFA slot q's condition in chunk i: [1, C] when it reads only the
        row (evaluated once over the batch), else [P*T, C] over the token
        table as it stands."""
        C = ch.C
        if q in inputs["row_cond"]:
            return inputs["row_cond"][q][:, i * C:(i + 1) * C]
        s = slice(i * C, (i + 1) * C)
        return self.prog._slot_cond(q, tok, {n: a[s] for n, a in inputs["cols"].items()},
                                    inputs["ts"][s], now)

    def step_for(self, stream_id: str):
        """The fused chunk loop's step for one input stream."""

        def step(st, b, now):
            st, out = self._step_impl(st, b, now, stream_id)
            return st, [out]

        return step

    # ---- host side -------------------------------------------------------

    def receive(self, batch: EventBatch, now: int, stream_id: str) -> EventBatch:
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state(now)
            now_t = torch.full((), now, dtype=torch.int64, device=self.device)
            self.state, out = self._step_impl(self.state, batch, now_t, stream_id)
            if self.lineage is not None:
                self._lin_flush(now)  # under the receive lock: dispatch order
        return out

    def receive_timer(self, t_ms: int) -> EventBatch:
        """One TIMER step at t_ms: a one-row TIMER batch with no columns,
        which fires the absent deadlines due by then."""
        dev = self.device
        batch = EventBatch(ts=torch.full((1,), t_ms, dtype=torch.int64, device=dev),
                           kind=torch.full((1,), KIND_TIMER, dtype=torch.int8, device=dev),
                           valid=torch.ones(1, dtype=torch.bool, device=dev), cols={})
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state(t_ms)
            now_t = torch.full((), t_ms, dtype=torch.int64, device=dev)
            self.state, out = self._step_impl(self.state, batch, now_t, None)
            if self.lineage is not None:
                self._lin_flush(t_ms)
        return out

    def describe_state(self) -> dict:
        """NFA introspection: active instances per linearized slot (the
        token table's active/slot lanes read back) and the earliest pending
        deadline."""
        prog = self.prog
        d = {"kind": type(self).__name__, "callbacks": len(self.query_callbacks),
             "rate_limited": False, "tables": [], "token_capacity": prog.T}
        slots = [{"refs": [a.ref for a in s.atoms], "absent": s.is_absent,
                  "count": [s.min_count, s.max_count] if s.is_count else None}
                 for s in prog.slots]
        if self.state is None:
            d["states"] = [dict(s, active=0) for s in slots]
            return d
        with self._receive_lock:
            tok = self.state["tok"]
            active = tok["active"].cpu().numpy()
            slot = tok["slot"].cpu().numpy()
            deadline = int(prog.next_timer(tok, after=self.state["timer_ts"]))
        per_state = np.bincount(slot[active], minlength=len(slots))
        d["states"] = [dict(s, active=int(per_state[i])) for i, s in enumerate(slots)]
        d["active_instances"] = int(active.sum())
        d["next_deadline_ms"] = deadline if deadline < NO_TIMER else None
        return d

    def prime(self, now: int) -> dict:
        """Create the initial token table at `now` and report its first
        deadline, so an absent-at-start pattern arms its timer before any
        event (reference: AbsentStreamPreStateProcessor.start)."""
        with self._receive_lock:
            if self.state is None:
                self.state = self.init_state(now)
            t = self.prog.next_timer(self.state["tok"], after=self.state["timer_ts"])
        return {"next_timer": t}

    def _log_pattern_overflow(self) -> None:
        logging.getLogger(__name__).warning(
            "query '%s': pattern token table or emission buffer overflowed; partial matches "
            "or emissions were dropped — raise @app:patternCapacity(size='N') (sizes both)",
            self.query_id)

    def flush_aux_warnings(self) -> None:
        super().flush_aux_warnings()
        self._pattern_overflow.flush()
