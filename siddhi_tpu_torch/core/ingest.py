"""Fused columnar ingest: K micro-batches per transfer and per device loop.

Reference analog: the @async Disruptor consumer batching events before the
query chain runs them (stream/StreamJunction.java:262-298). Here a junction
whose subscribers are all fusable takes a `send_columns` call of at least two
micro-batches in chunks of K:

1. the host encodes the K micro-batches into one narrow wire (core/wire.py)
   in a pooled pinned slot (core/pipeline.py);
2. one non-blocking copy moves the slot to the card;
3. K4 (`wire_decode`, csrc/wire_decode.cu) decodes all K micro-batches;
4. a Python loop runs the K query steps (`QueryRuntime._step_impl`, with the
   K1-K3 kernels) on device tensors, with no host sync inside the loop;
5. K5 (`deliver_pack`, csrc/deliver_pack.cu) compacts the rows the query
   callbacks want into one row-major byte buffer behind a count header, so
   EXPIRED rows no callback receives never cross the bus;
6. one readback of the filled prefix, a vectorized host decode into Events,
   and the callbacks, once per non-empty micro-batch, in order, all before
   `send_columns` returns.

Under @app:lineage each step also leaves its `__lin.*` lanes (beside K5's
pack, never in it); after the K steps one readback brings a chunk's lanes
back and each recorder replays them micro-batch by micro-batch. A send that
commits on this path stamps the junction's flight ring and lineage arena
from the host columns it was given.

Engagement is all-or-nothing per junction: the fused path is used only when
nothing host-side observes per-batch boundaries — no stream callbacks, no
subscriber outside the engine, and no consumer of the queries' insert
targets. Anything else takes the per-batch path, with the same rows.

Queries whose expressions run host code (string conversion and UUID in
core/executor.py) copy to the host inside the K loop; they are slower on
this path, not wrong.

The chunk stages run double-buffered through core/pipeline.py by default;
`@pipeline(disable='true')` (or SIDDHI_TPU_PIPELINE=0) runs them serially.
Outputs and delivery order are the same either way.

Under `@app:shard` a junction whose endpoints are all stateless takes a
batch shard router (parallel/shard.py `BatchShardRouter`): its micro-batches
go round-robin to the mesh devices, one `_dispatch_chunk` a chunk of each
device's batches, delivered in the original batch order, the lineage
observations parked and replayed in that order.

Ported from the JAX package's core/ingest.py without its plan groups and
share sets, residual dispatch, profiler waterfall, device statistics and
tracer, tail prewarm, and value-inferred wire hints.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import threading
from typing import Callable, Optional

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.event import (
    KIND_CURRENT,
    KIND_EXPIRED,
    EventBatch,
    WireNarrowMisfit,
    events_from_arrays,
    rows_from_arrays,
)
from siddhi_tpu_torch.core.pipeline import IngestPipeline, device_views
from siddhi_tpu_torch.core.types import NUMPY_DTYPE
from siddhi_tpu_torch.core.wire import choose_encodings, wire_report
from siddhi_tpu_torch.observability.lineage import observe_steps
from siddhi_tpu_torch.query_api.execution import OutputEventsFor

_MAX_LANES = 32  # kMaxLanes of csrc/deliver_pack.cu
_PACK_THREADS = 1024  # kThreads of csrc/deliver_pack.cu (rows per tile)


# ---------------------------------------------------------------------------
# K5: the deliver pack
# ---------------------------------------------------------------------------


def _pack_geometry(K: int, lanes) -> tuple[int, int]:
    """(W, hdr_rows): packed row bytes and the header rows that hold the K
    int32 counts."""
    W = sum(lane.element_size() for lane in lanes)
    return W, -(-4 * K // W)


def deliver_pack_ref(dv: torch.Tensor, lanes: list) -> torch.Tensor:
    """Plain version of `deliver_pack`, as the JAX package's chunk program
    forms it: a cumsum rank over the flattened mask, a scatter of each lane
    into its rank (dropped rows into a dump slot), each lane viewed as bytes,
    the lanes side by side, and the count header in front."""
    K, R = dv.shape
    n = K * R
    flat = dv.reshape(n)
    fi = flat.to(torch.int32)
    rank = torch.cumsum(fi, 0, dtype=torch.int32) - fi
    dst = torch.where(flat, rank, n).long()
    segs = []
    for lane in lanes:
        arr = lane.reshape(n)
        if arr.dtype == torch.bool:
            arr = arr.to(torch.uint8)
        packed = torch.zeros(n + 1, dtype=arr.dtype, device=dv.device)
        packed[dst] = arr
        segs.append(packed[:n].view(torch.uint8).reshape(n, arr.element_size()))
    data = torch.cat(segs, 1)
    W, hdr_rows = _pack_geometry(K, lanes)
    hdr = torch.zeros(hdr_rows * W, dtype=torch.uint8, device=dv.device)
    hdr[: 4 * K] = dv.sum(1, dtype=torch.int32).view(torch.uint8)
    return torch.cat([hdr.reshape(hdr_rows, W), data], 0)


def deliver_pack(dv: torch.Tensor, lanes: list) -> torch.Tensor:
    """Stable compaction of the rows where `dv` holds, over all K*R rows in
    arrival order, into one row-major byte buffer.

    dv:     [K, R] bool deliverable-row mask
    lanes:  [K, R] tensors in packed-row order (bool lanes become one byte)
    returns u8 [hdr_rows + K*R, W]: hdr_rows = ceil(4K / W) header rows whose
            first 4K bytes are the int32 per-micro-batch counts, then the
            kept rows, then zero rows.
    """
    if dv.device.type == "cpu":
        return deliver_pack_ref(dv, lanes)
    kernels.require_cuda("deliver_pack", dv, *lanes)
    if dv.dim() != 2 or dv.dtype != torch.bool or not lanes or any(
        lane.shape != dv.shape for lane in lanes
    ):
        raise ValueError("deliver_pack: expected a [K, R] bool mask and [K, R] lanes")
    K, R = dv.shape
    if len(lanes) > _MAX_LANES or not 0 < K < 65536 or K * R >= 2**31:
        raise ValueError(f"deliver_pack: {len(lanes)} lanes (max {_MAX_LANES}), K={K}, R={R}")
    out, err = _pack_launch(kernels.function("deliver_pack"), dv, lanes, kernels.stream())
    kernels.check(err, "deliver_pack")
    kernels.launches["deliver_pack"] += 1
    return out


def _pack_launch(fn, dv, lanes, stream):
    """Allocate the output and scratch on dv's device and launch the C entry
    point `fn` of csrc/deliver_pack.cu. Returns (out, cudaError_t)."""
    K, R = dv.shape
    dev = dv.device
    W, hdr_rows = _pack_geometry(K, lanes)
    tiles = K * -(-R // _PACK_THREADS)
    out = torch.empty((hdr_rows + K * R, W), dtype=torch.uint8, device=dev)
    tile_counts = torch.empty(tiles, dtype=torch.int32, device=dev)
    tile_off = torch.empty(tiles, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    sizes = [lane.element_size() for lane in lanes]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    c_ptrs = (ctypes.c_void_p * len(lanes))(*[lane.data_ptr() for lane in lanes])
    c_sizes = (ctypes.c_int * len(lanes))(*sizes)
    c_offs = (ctypes.c_int * len(lanes))(*offs)
    err = fn(
        dv.data_ptr(), K, R, len(lanes), ctypes.addressof(c_ptrs),
        ctypes.addressof(c_sizes), ctypes.addressof(c_offs), W, hdr_rows,
        tile_counts.data_ptr(), tile_off.data_ptr(), total.data_ptr(), out.data_ptr(),
        stream,
    )
    return out, err


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class FuseEndpoint:
    """One junction subscriber in fused form: the query runtime `qr` (its
    state, callbacks and output schema) and the step the chunk loop runs,
    `step(state, batch, now) -> (state', [out, ...])`: `outputs` output
    batches per micro-batch, delivered in that order (a self-join's left then
    right half). The default step is `qr._step_impl`, one output.
    `init_state(now)` makes the query's first state (default:
    `qr.init_state()`)."""

    def __init__(self, qr, step: Optional[Callable] = None, outputs: int = 1,
                 init_state: Optional[Callable] = None):
        self.qr = qr
        self.outputs = outputs
        if step is None:
            def step(st, b, now, _qr=qr):
                st, out = _qr._step_impl(st, b, now)
                return st, [out]
        self.step = step
        self.init_state = init_state or (lambda now, _qr=qr: _qr.init_state())


@dataclasses.dataclass(frozen=True)
class _ChunkProgram:
    """Everything one chunk needs, snapshot together so a full-width rebuild
    in another thread can never pair a new encode with an old decode."""

    encode: Callable
    decode: Callable
    wire_bytes: int
    deliver_idx: tuple  # endpoints whose outputs are packed and drained
    layouts: dict  # i -> ([(lane name, np.dtype, byte offset)], row bytes)


class FusedJunctionIngest:
    """Per-junction fused ingest engine (built at app start)."""

    def __init__(
        self,
        app,
        junction,
        endpoints,
        chunk_batches: int = 32,
        pipeline_enabled: bool = True,
        pipeline_depth: int = 2,
        wire_spec=None,
        wire_enabled: bool = True,
    ):
        self.app = app
        self.junction = junction
        self.device = torch.device(junction.device)
        self.endpoints = list(endpoints)
        self.K = max(2, int(chunk_batches))
        self.chunks_dispatched = 0
        self.batches_fused = 0
        self.events_fused = 0
        self._disabled = False
        # wire encodings (core/wire.py): None = not chosen yet (decided at the
        # first engaged send); {} when wire encoding is off OR, permanently,
        # after any misfit = full-width wire
        self._narrow = None
        self._keep = None
        self.wire_spec = wire_spec
        self.wire_enabled = bool(wire_enabled)
        self._prog: Optional[_ChunkProgram] = None
        self._prog_dset = None
        self._lock = threading.Lock()
        self.pipeline_enabled = bool(pipeline_enabled)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.pipeline = None
        self._send_lock = threading.Lock()
        self._sender = None  # thread holding _send_lock (re-entrancy guard)
        self._drain_guess: dict = {}
        self._drain_stream = None
        # the batch-axis router (parallel/shard.py), armed at start() under
        # @app:shard; and the lineage observations it parks during a send
        self.shard_router = None
        self._lin_pending: Optional[list] = None

    def describe_state(self) -> dict:
        d: dict = {
            "chunk_batches": self.K,
            "enabled": not self._disabled,
            "pipeline_enabled": self.pipeline_enabled,
            "depth": self.pipeline_depth if self.pipeline_enabled else 0,
            "chunks": self.chunks_dispatched,
            "batches": self.batches_fused,
            "events": self.events_fused,
        }
        if self.shard_router is not None:
            d["shard_router"] = self.shard_router.describe_state()
        if self._narrow is not None:
            d["wire"] = wire_report(
                self.junction.schema, self._keep, self._narrow, self.wire_spec,
                capacity=self.junction.batch_size,
            )
        return d

    # ---- eligibility (cheap dynamic checks, every send) ------------------

    def eligible(self) -> bool:
        j = self.junction
        if j.stream_callbacks:
            return False
        if len(j.subscribers) != len(self.endpoints):
            return False  # an uncovered subscriber is attached
        for ep in self.endpoints:
            qr = ep.qr
            # a query whose window needs the scheduler takes the per-batch
            # path, where each step's next expiry is read and scheduled
            if qr.uses_scheduler:
                return False
            tj = qr.insert_target_junction
            if tj is not None and (tj.subscribers or tj.stream_callbacks):
                return False
        return True

    def _delivery_set(self) -> frozenset:
        """Indices of endpoints whose outputs must be packed/drained."""
        return frozenset(i for i, ep in enumerate(self.endpoints) if ep.qr.query_callbacks)

    def _compute_keep(self) -> Optional[frozenset]:
        """Projected wire: ship only attributes some subscriber reads."""
        schema = self.junction.schema
        used: Optional[set] = set()
        for ep in self.endpoints:
            ua = ep.qr.used_attrs
            if ua is None:
                used = None  # select * — keep everything
                break
            used |= ua
        self._keep = (
            None if used is None else frozenset(n for n in schema.attr_names if n in used)
        )
        return self._keep

    def _within_kernel_limits(self, dset: frozenset) -> bool:
        """K4 decodes at most 32 sections (the timestamp lane + 31 columns)
        and K5 packs at most 32 lanes; a wider stream or output takes the
        per-batch path."""
        schema = self.junction.schema
        wide = 1 + len(schema.attrs) > _MAX_LANES or any(
            len(self.endpoints[i].qr.out_schema.attrs) + 2 > _MAX_LANES for i in dset
        )
        if wide:
            logging.getLogger(__name__).warning(
                "fused ingest off for stream '%s': more than %d wire sections or "
                "output lanes", schema.stream_id, _MAX_LANES,
            )
        return not wide

    # ---- the chunk program -------------------------------------------------

    def _build(self, dset: frozenset) -> None:
        """(Re)form the chunk program for the current wire encodings and
        delivery set: the wire codec, and the host byte layout of each
        delivering endpoint's pack, in the sorted lane order K5 packs."""
        B = self.junction.batch_size
        encode, decode, wire_bytes = self.junction.schema.wire_codec(
            B, self._compute_keep(), self._narrow or {}
        )
        layouts = {}
        for i in sorted(dset):
            qr = self.endpoints[i].qr
            dtypes = {f"c.{n}": NUMPY_DTYPE[t] for n, t in qr.out_schema.attrs}
            dtypes["ts"] = np.dtype(np.int64)
            if qr.output_events is OutputEventsFor.ALL:
                dtypes["kind"] = np.dtype(np.int8)
            layout, off = [], 0
            for name in sorted(dtypes):
                layout.append((name, dtypes[name], off))
                off += dtypes[name].itemsize
            layouts[i] = (layout, off)
        self._prog = _ChunkProgram(encode, decode, wire_bytes, tuple(sorted(dset)), layouts)
        self._prog_dset = dset

    def _run_chunk(self, prog: _ChunkProgram, wire, counts, bases, K: int, now: int):
        """The chunk's device work, enqueued with no host sync: K4, the K
        query steps per endpoint, K5 per delivering endpoint. Runs under
        the app lock; writes the new states back. Returns (packs, event,
        marks): one packed buffer per delivering endpoint, on the card an
        event recorded after the last kernel, and for each recorded
        endpoint its lineage sink's length before and after each
        micro-batch."""
        eps = self.endpoints
        states = []
        for ep in eps:
            if ep.qr.state is None:
                ep.qr.state = ep.init_state(now)
            states.append(ep.qr.state)
        batch = prog.decode(wire, counts, bases)
        dev = wire.device  # a mesh device under the batch shard router
        now_t = torch.full((), now, dtype=torch.int64, device=dev)
        outs: dict = {i: [] for i in prog.deliver_idx}
        # a recorded query's sink length after each micro-batch's step
        marks = {ei: [len(ep.qr._lin_sink)] for ei, ep in enumerate(eps)
                 if ep.qr.lineage is not None}
        for k in range(K):
            bk = EventBatch(
                ts=batch.ts[k], kind=batch.kind[k], valid=batch.valid[k],
                cols={n: c[k] for n, c in batch.cols.items()},
            )
            for ei, ep in enumerate(eps):
                states[ei], step_outs = ep.step(states[ei], bk, now_t)
                if ei in outs:
                    outs[ei].extend(step_outs)
                if ei in marks:
                    marks[ei].append(len(ep.qr._lin_sink))
        for ep, st in zip(eps, states):
            ep.qr.state = st
        packs = [self._pack(prog, i, outs[i]) for i in prog.deliver_idx]
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return packs, event, marks

    def _pack(self, prog: _ChunkProgram, i: int, outs: list) -> torch.Tensor:
        """K5 over one endpoint's K step outputs. `dv` marks the rows its
        callbacks receive — CURRENT, EXPIRED or both, by `output_events` —
        so no other row crosses the bus."""
        qr = self.endpoints[i].qr
        want = qr.output_events
        dvs = []
        for out in outs:
            if want is OutputEventsFor.CURRENT:
                dvs.append(out.valid & (out.kind == KIND_CURRENT))
            elif want is OutputEventsFor.EXPIRED:
                dvs.append(out.valid & (out.kind == KIND_EXPIRED))
            else:
                dvs.append(out.valid & ((out.kind == KIND_CURRENT) | (out.kind == KIND_EXPIRED)))
        lanes = []
        for name, dt, _off in prog.layouts[i][0]:
            if name == "ts":
                parts = [out.ts for out in outs]
            elif name == "kind":
                parts = [out.kind for out in outs]
            else:
                parts = [out.cols[name[2:]] for out in outs]
            lane = torch.stack(parts)
            want_dt = torch.from_numpy(np.zeros(0, dt)).dtype
            lanes.append(lane if lane.dtype == want_dt else lane.to(want_dt))
        return deliver_pack(torch.stack(dvs), lanes)

    # ---- host side -------------------------------------------------------

    def _chunk_K(self, remaining_batches: int) -> int:
        """Smallest K variant covering the remainder: full chunks use self.K;
        a short tail takes the smallest power of two that holds it, so a
        tail does not pay K iterations of empty micro-batches."""
        if remaining_batches >= self.K:
            return self.K
        k = 2
        while k < remaining_batches:
            k *= 2
        return min(k, self.K)

    def try_send(self, timestamps, cols, now: int) -> bool:
        """Fused ingest of the whole call. Returns False to make the caller
        take the per-batch path (too few events, ineligible subscribers, or
        a timestamp span the int32 wire cannot carry)."""
        n = len(timestamps)
        B = self.junction.batch_size
        # engage for any call of at least two micro-batches: shorter tails
        # ride a smaller-K variant (see _chunk_K)
        if n < 2 * B or self._disabled or not self.eligible():
            return False
        dset = self._delivery_set()
        ts_arr = np.asarray(timestamps)
        if n and int(ts_arr.max()) - int(ts_arr.min()) >= (1 << 31):
            return False  # int32 ts-delta wire can't span >24 days per call
        with self._lock:
            if self._narrow is None:
                # wire-encoding decision at first engagement (core/wire.py):
                # declared @app:wire encoders overlaid on dtypes sampled
                # from the first micro-batch; {} (full width) when disabled
                self._narrow = choose_encodings(
                    self.junction.schema, self._compute_keep(), self.wire_spec,
                    self.wire_enabled, ts_arr[:B],
                    {k: np.asarray(v)[:B] for k, v in cols.items()},
                )
            if self._prog is None or self._prog_dset != dset:
                if not self._within_kernel_limits(dset):
                    self._disabled = True
                    return False
                self._build(dset)
            prog = self._prog

        sent = False
        if self.shard_router is not None:
            # None: the router declined (too few batches, a re-entrant send,
            # a narrow-wire misfit) and the single-device paths own the call
            sent = bool(self.shard_router.try_send(self, prog, ts_arr, cols, n, B, now))
        if not sent and self.pipeline_enabled:
            pl = self._pipeline()
            # a query callback that re-enters send_columns from the drain
            # worker must not block on the pipeline it is draining
            if not pl.is_drain_thread() and self._sender is not threading.current_thread():
                with self._send_lock:
                    self._sender = threading.current_thread()
                    try:
                        sent = self._send_pipelined(prog, dset, ts_arr, cols, n, B, now, pl)
                    finally:
                        self._sender = None
        if not sent:
            sent = self._send_serial(prog, dset, ts_arr, cols, n, B, now)
        # the committed send is this junction's one publish: the flight ring
        # and the lineage arena record it from the host columns
        j = self.junction
        if j.flight is not None:
            j.flight.record_columns(ts_arr, cols, n)
        if j.lineage is not None:
            j.lineage.record_columns(ts_arr, cols, n)
        return sent

    def _pipeline(self):
        pl = self.pipeline
        if pl is None:
            pl = self.pipeline = IngestPipeline(
                self.junction, self.device, depth=self.pipeline_depth, drain_fn=self._drain
            )
        return pl

    def close(self) -> None:
        """Stop the pipeline's drain worker (app shutdown). Serialized with
        senders so no in-flight send can enqueue behind the stop."""
        with self._send_lock:
            if self.pipeline is not None:
                self.pipeline.close()

    def _rebuild_full_width(self, dset) -> _ChunkProgram:
        """A value outgrew the narrow wire: re-form the chunk program
        full-width (once, permanent)."""
        with self._lock:
            self._narrow = {}
            self._build(dset)
            return self._prog

    def _dispatch_chunk(self, prog, wire, counts, bases, K: int, n_events: int, now: int,
                        lin_ks: Optional[list] = None):
        """One chunk's device work under the app lock, then the counters.
        On a failure owned by the junction's exception handler returns
        (None, None) and the caller goes on with the next chunk, as the
        per-batch path goes on with the next batch. `lin_ks`: the shard
        router's global batch index of each micro-batch."""
        with self.app._process_lock:
            try:
                packs, event, marks = self._run_chunk(prog, wire, counts, bases, K, now)
            except Exception as e:
                for ep in self.endpoints:
                    ep.qr._lin_sink.clear()
                handler = self.junction.exception_handler
                if handler is None:
                    raise
                handler(e)
                return None, None
            self.chunks_dispatched += 1
            self.batches_fused += K
            self.events_fused += n_events
            if marks:
                self._lin_observe_chunk(marks, K, n_events, now, lin_ks)
        return packs, event

    def _lin_observe_chunk(self, marks: dict, K: int, n_events: int, now: int,
                           lin_ks: Optional[list] = None) -> None:
        """Replay the chunk's lineage lanes: one readback of every recorded
        endpoint's steps, then each endpoint's micro-batches in order, the
        empty ones (a short chunk's padding) skipped, as JAX does. Under the
        shard router (`lin_ks`, a send begun by `_lin_begin_send`) each
        micro-batch's steps park, keyed by global batch, for the in-order
        replay of `_lin_end_send` (JAX core/ingest.py:909-960)."""
        B = self.junction.batch_size
        per_ep = []
        for ei, m in marks.items():
            qr = self.endpoints[ei].qr
            steps, qr._lin_sink = qr._lin_sink, []
            for k in range(K):
                if n_events - k * B <= 0:
                    continue
                mb = steps[m[k] - m[0]:m[k + 1] - m[0]]
                if lin_ks is not None and self._lin_pending is not None:
                    self._lin_pending.append((int(lin_ks[k]), ei, qr.lineage, mb, now))
                else:
                    per_ep.append((qr.lineage, mb))
        if per_ep:
            observe_steps(per_ep, now)

    def _lin_begin_send(self) -> None:
        if any(ep.qr.lineage is not None for ep in self.endpoints):
            self._lin_pending = []

    def _lin_end_send(self) -> None:
        """Replay the parked observations in the original batch order, then
        endpoint order: the single-device chunk loop's order."""
        pend, self._lin_pending = self._lin_pending, None
        if pend:
            pend.sort(key=lambda x: (x[0], x[1]))
            observe_steps([(lin, mb) for _k, _ei, lin, mb, _now in pend], pend[0][4])

    def _send_serial(self, prog, dset, ts_arr, cols, n, B, now) -> bool:
        """The serial chunk loop (@pipeline(disable='true') or a drain-worker
        re-entrant send): encode, ship, dispatch, and drain the previous
        chunk's outputs on the calling thread, in order."""
        pending = None  # previous chunk's packs, drained one chunk late
        c_off = 0
        while c_off < n:
            K = self._chunk_K(-(-(n - c_off) // B))
            c_end = min(c_off + K * B, n)
            try:
                host = self._encode_chunk(prog.encode, ts_arr, cols, c_off, c_end, B, K,
                                          prog.wire_bytes)
            except WireNarrowMisfit:
                prog = self._rebuild_full_width(dset)
                host = self._encode_chunk(prog.encode, ts_arr, cols, c_off, c_end, B, K,
                                          prog.wire_bytes)
            dev = torch.from_numpy(host).to(self.device)
            wire, counts, bases = device_views(dev, K, prog.wire_bytes)
            packs, event = self._dispatch_chunk(prog, wire, counts, bases, K,
                                                c_end - c_off, now)
            if packs:
                # drain the PREVIOUS chunk now that this chunk's device work
                # is enqueued: the host decode overlaps device compute
                if pending is not None:
                    self._drain_guarded(*pending)
                pending = ((prog, packs, event), K)
            c_off = c_end
        if pending is not None:
            self._drain_guarded(*pending)
        return True

    def _drain_guarded(self, item, K: int) -> None:
        """Drain with the junction's exception handler owning callback
        errors when it has one; unguarded junctions re-raise to the sender."""
        try:
            self._drain(item, K)
        except Exception as e:
            j = self.junction
            if j.exception_handler is None:
                raise
            j._on_worker_error(e, "fused drain")

    def _send_pipelined(self, prog, dset, ts_arr, cols, n, B, now, pl) -> bool:
        """The double-buffered chunk loop (core/pipeline.py): chunk N+1 is
        encoded into a pooled slot and copied while chunk N's device work
        runs; drains run on the pipeline's worker in chunk order. Barriers
        on the drain before returning, so callers see the serial path's
        callback order."""
        err = None
        try:
            staged, c_off, prog = self._stage_chunk(pl, prog, dset, ts_arr, cols, 0, n, B)
            while staged is not None:
                (wire, counts, bases), K, n_events, slot = staged
                staged = None
                packs, event = self._dispatch_chunk(prog, wire, counts, bases, K, n_events,
                                                    now)
                pl.retire(slot)
                if packs:
                    # hand the packs to the drain worker BEFORE staging the
                    # next chunk: its readback+decode overlaps the encode
                    pl.submit((prog, packs, event), K)
                    if pl.pending_error():
                        # an unguarded delivery failure waits at the
                        # barrier: stop ingesting further chunks
                        break
                if c_off < n:
                    staged, c_off, prog = self._stage_chunk(
                        pl, prog, dset, ts_arr, cols, c_off, n, B
                    )
        except BaseException as e:
            err = e
        # always flush delivery before returning or raising: callbacks fire
        # in chunk order and complete before send_columns returns
        try:
            pl.barrier()
        except Exception as be:
            if err is None:
                err = be
        if err is not None:
            raise err
        return True

    def _stage_chunk(self, pl, prog, dset, ts_arr, cols, c_off, n, B):
        """Encode the next chunk into a pooled slot and start its copy.
        Returns (((wire, counts, bases), K, events, slot), next_off, prog) — prog is
        swapped by a full-width rebuild on a narrow-wire misfit."""
        K = self._chunk_K(-(-(n - c_off) // B))
        c_end = min(c_off + K * B, n)
        slot = pl.acquire(K, prog.wire_bytes)
        try:
            self._encode_chunk(prog.encode, ts_arr, cols, c_off, c_end, B, K,
                               prog.wire_bytes, slot=slot)
        except WireNarrowMisfit:
            pl.barrier()  # chunks in flight drain under the old program
            prog = self._rebuild_full_width(dset)
            slot = pl.acquire(K, prog.wire_bytes)
            self._encode_chunk(prog.encode, ts_arr, cols, c_off, c_end, B, K,
                               prog.wire_bytes, slot=slot)
        return (pl.ship(slot), K, c_end - c_off, slot), c_end, prog

    def _encode_chunk(self, encode, ts_arr, cols, c_off, c_end, B, K, wire_bytes, slot=None):
        """Encode one K-batch chunk: the int64 bases, int32 counts and
        [K, wire_bytes] wire rows side by side, into the pooled `slot` or a
        fresh host buffer (returned)."""
        if slot is None:
            host = np.zeros(12 * K + K * wire_bytes, dtype=np.uint8)
            bases = host[: 8 * K].view(np.int64)
            counts = host[8 * K : 12 * K].view(np.int32)
            wire = host[12 * K :].reshape(K, wire_bytes)
        else:
            host, bases, counts, wire = None, slot.bases, slot.counts, slot.wire
        for k in range(K):
            lo = c_off + k * B
            hi = min(lo + B, c_end)
            m = max(hi - lo, 0)
            counts[k] = m
            if m > 0:
                _buf, bases[k] = encode(
                    ts_arr[lo:hi], {kk: v[lo:hi] for kk, v in cols.items()}, m, out=wire[k]
                )
            else:
                bases[k] = 0
                wire[k, :] = 0
        return host

    def _readback(self, buf: torch.Tensor, lo: int, hi: int, event) -> np.ndarray:
        """Rows [lo, hi) of a packed buffer on the host. On the card: a
        copy into pinned memory on the drain stream, after the chunk's
        event."""
        if buf.device.type == "cpu":
            return buf[lo:hi].numpy()
        if self._drain_stream is None:
            self._drain_stream = torch.cuda.Stream(device=self.device)
        ds = self._drain_stream
        host = torch.empty((hi - lo, buf.shape[1]), dtype=torch.uint8, pin_memory=True)
        with torch.cuda.stream(ds):
            if event is not None:
                ds.wait_event(event)
            host.copy_(buf[lo:hi], non_blocking=True)
        ds.synchronize()
        return host.numpy()

    def _drain(self, item, K: int) -> None:
        """Deliver one chunk's packed outputs to query callbacks: one
        readback of the header and a guessed row prefix per endpoint (a
        second one only when the guess undershoots), then a vectorized host
        decode, preserving per-micro-batch callback grouping (reference:
        QueryCallback.receive per chunk)."""
        prog, packs, event = item
        for i, buf in zip(prog.deliver_idx, packs):
            qr = self.endpoints[i].qr
            if not qr.query_callbacks:
                continue
            layout, row_bytes = prog.layouts[i]
            n_out = K * self.endpoints[i].outputs  # output batches in the pack
            hdr_rows = -(-4 * n_out // row_bytes)
            R = buf.shape[0] - hdr_rows

            def bucket(x: int) -> int:
                return min(R, 1 << max(0, int(x - 1).bit_length()))

            # one readback in the steady state: the header rows carry the
            # per-micro-batch counts, and the prefix is sized from the
            # previous chunk's total
            guess = bucket(self._drain_guess.get(i, R))
            head = self._readback(buf, 0, hdr_rows + guess, event)
            cnts = head[:hdr_rows].reshape(-1)[: 4 * n_out].view(np.int32)
            total = int(cnts.sum())
            self._drain_guess[i] = max(total, 1)
            if total == 0:
                continue
            L = bucket(total)
            if L <= guess:
                host = head[hdr_rows:]
            else:
                tail = self._readback(buf, hdr_rows + guess, hdr_rows + L, None)
                host = np.concatenate([head[hdr_rows:], tail])
            self.deliver_endpoint(prog, i, host, cnts, total)

    def deliver_endpoint(self, prog, i: int, host, cnts, total: int) -> None:
        """Decode endpoint `i`'s packed output rows and fire its callbacks
        per micro-batch segment. `host` is the header-stripped byte buffer,
        `cnts` the deliverable-row count per micro-batch, `total` their
        sum."""
        qr = self.endpoints[i].qr
        interner = self.junction.interner
        layout, _row_bytes = prog.layouts[i]
        lanes = {}
        for name, dt, off in layout:
            lanes[name] = np.ascontiguousarray(host[:total, off : off + dt.itemsize]).view(dt)[:, 0]
        want = qr.output_events
        cols = {n: lanes[f"c.{n}"] for n in qr.out_schema.attr_names}
        raw = qr.raw_query_callbacks
        if want is not OutputEventsFor.ALL and len(raw) == len(qr.query_callbacks):
            # single-kind fast path: decode straight to Event lists and
            # invoke the USER callbacks (skips the triple intermediate)
            events = events_from_arrays(qr.out_schema, lanes["ts"], cols, total, interner)
            expired = want is OutputEventsFor.EXPIRED
            off = 0
            for k in range(len(cnts)):
                c = int(cnts[k])
                if c == 0:
                    continue
                seg = events[off : off + c]
                off += c
                ts = seg[-1][0]
                for cb in raw:
                    if expired:
                        cb(ts, None, seg)
                    else:
                        cb(ts, seg, None)
            return
        kind = (
            lanes["kind"]
            if want is OutputEventsFor.ALL
            else int(KIND_CURRENT if want is not OutputEventsFor.EXPIRED else KIND_EXPIRED)
        )
        rows = rows_from_arrays(qr.out_schema, lanes["ts"], kind, cols, total, interner)
        split = want is OutputEventsFor.ALL
        off = 0
        for k in range(len(cnts)):
            c = int(cnts[k])
            if c == 0:
                continue
            seg = rows[off : off + c]
            off += c
            if split:
                ins = [e for e in seg if e[1] == KIND_CURRENT]
                removed = [e for e in seg if e[1] == KIND_EXPIRED]
            elif want is OutputEventsFor.EXPIRED:
                ins, removed = [], seg
            else:
                ins, removed = seg, []
            if ins or removed:
                ts = seg[-1][0]
                for cb in qr.query_callbacks:
                    cb(ts, ins or None, removed or None)
