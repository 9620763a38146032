"""Double-buffered ingest pipeline: overlap encode, H2D, the chunk's device
work, and the drain.

The fused ingest path (core/ingest.py) runs three host-visible stages per
chunk — host encode, host->device copy, the chunk's device work (K4 decode,
K query steps, K5 pack) — plus, when query callbacks want the outputs, a
device->host readback + decode + callback delivery. Run strictly one after
another, the sender's wall per chunk is `encode + h2d + device + d2h` even
though the stages use disjoint resources (Python/numpy on the host, the
copy engine, the SMs, and the readback path).

This module keeps those stages busy together:

1. host encode writes into one of `depth` POOLED pinned wire slots, so chunk
   N+1's encode can start while chunk N's slot is still being copied (a slot
   is reused only after its copy event completed);
2. the copy of chunk N+1 runs on a dedicated copy stream while chunk N's
   kernels run on the compute stream, which waits on the copy's event before
   it decodes;
3. a bounded background drain worker copies each chunk's packed output back
   on its own stream, decodes it, and runs query-callback delivery in chunk
   order, with backpressure (at most `depth` undrained chunks in flight).

Ordering and failure semantics are those of the serial path:

* `try_send` BARRIERS on the drain before returning, so callbacks fire in
  chunk order and complete before `send_columns` returns;
* a delivery failure on the drain worker goes to the junction's exception
  handler when it has one; with none it is re-raised to the sender at the
  barrier, like the serial path's in-line drain.

The drain always runs on the worker thread (there is no inline mode: that
exists in the JAX package only for tunnelled TPU relays).

On a CPU device nothing is asynchronous: `ship` copies the slot, so the
shipped tensor never aliases a pooled buffer that a later encode overwrites.

Configuration: the `@pipeline(depth='N', disable='true')` stream
annotation, overridden process-wide by SIDDHI_TPU_PIPELINE=1 (force on) /
SIDDHI_TPU_PIPELINE=0 (force off).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

DEFAULT_DEPTH = 2
_MAX_DEPTH = 8

PIPELINE_ENV = "SIDDHI_TPU_PIPELINE"

_TRUE = ("1", "on", "true", "force")
_FALSE = ("0", "off", "false")


def pipeline_env_override() -> Optional[bool]:
    """Process-wide pipeline toggle: True (forced on), False (forced off),
    or None (defer to the stream's @pipeline annotation)."""
    v = os.environ.get(PIPELINE_ENV, "").strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return None


def iter_pipeline_annotation_problems(ann):
    """Yield one message per malformed `@pipeline` element."""
    for k, v in ann.elements:
        if k == "depth":
            try:
                ok = 1 <= int(v) <= _MAX_DEPTH
            except (TypeError, ValueError):
                ok = False
            if not ok:
                yield f"@pipeline depth '{v}' must be an integer in 1..{_MAX_DEPTH}"
        elif k == "disable":
            if str(v).strip().lower() not in ("true", "false"):
                yield f"@pipeline disable '{v}' must be true or false"
        else:
            yield (
                f"unknown @pipeline option '{k if k is not None else v}' "
                "(expected depth, disable)"
            )


def resolve_pipeline_annotation(ann) -> tuple[bool, int]:
    """(enabled, depth) for one stream from its `@pipeline` annotation (or
    None) plus the SIDDHI_TPU_PIPELINE env override. Raises
    SiddhiAppCreationError on malformed options."""
    from siddhi_tpu_torch.core.errors import SiddhiAppCreationError

    enabled = True
    depth = DEFAULT_DEPTH
    if ann is not None:
        for problem in iter_pipeline_annotation_problems(ann):
            raise SiddhiAppCreationError(problem)
        depth = int(ann.element("depth", str(DEFAULT_DEPTH)))
        enabled = str(ann.element("disable", "false")).strip().lower() != "true"
    env = pipeline_env_override()
    if env is not None:
        enabled = env
    return enabled, depth


class _WireSlot:
    """One pooled host buffer for a [K, wire_bytes] chunk: the int64 bases,
    the int32 counts and the wire rows side by side in ONE (pinned, on a CUDA
    device) tensor, so a chunk crosses the bus in one copy. `bases`,
    `counts` and `wire` are numpy views of it for the encoder.

    `event` is the CUDA event recorded after the slot's last copy: acquire()
    waits on it before the buffer is overwritten. `dev` holds the shipped
    device tensor until retire()."""

    __slots__ = ("K", "wire_bytes", "host", "bases", "counts", "wire", "event", "dev")

    def __init__(self, K: int, wire_bytes: int, pin: bool):
        self.K, self.wire_bytes = K, wire_bytes
        self.host = torch.zeros(12 * K + K * wire_bytes, dtype=torch.uint8, pin_memory=pin)
        a = self.host.numpy()
        self.bases = a[: 8 * K].view(np.int64)
        self.counts = a[8 * K : 12 * K].view(np.int32)
        self.wire = a[12 * K :].reshape(K, wire_bytes)
        self.event = None
        self.dev = None


def device_views(dev: torch.Tensor, K: int, wire_bytes: int):
    """(wire [K, wire_bytes] u8, counts [K] int32, bases [K] int64) views of
    one shipped slot tensor."""
    return (
        dev[12 * K :].view(K, wire_bytes),
        dev[8 * K : 12 * K].view(torch.int32),
        dev[: 8 * K].view(torch.int64),
    )


class IngestPipeline:
    """Per-junction pipeline engine owned by a FusedJunctionIngest.

    Senders are serialized by the ingest's send lock, so acquire/ship run
    from one thread at a time; the drain worker is the only other thread
    touching this object (via the queue/condvar only).
    """

    def __init__(self, junction, device, depth: int = DEFAULT_DEPTH, drain_fn=None):
        self.junction = junction
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the drain worker sets this device: it needs the index
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.depth = max(1, int(depth))
        self.drain_fn = drain_fn  # fn(item, K): the ingest's _drain
        self._pool: dict[tuple, dict] = {}  # (K, nb) -> {slots, next}
        self._copy_stream = None
        self._cv = threading.Condition()
        self._inflight = 0  # submitted, not yet drained
        self._error: Optional[BaseException] = None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # ---- wire buffer pool ------------------------------------------------

    def acquire(self, K: int, wire_bytes: int) -> _WireSlot:
        """A host slot for one [K, wire_bytes] chunk, safe to overwrite:
        pooled, waiting on the slot's last copy event."""
        key = (int(K), int(wire_bytes))
        ent = self._pool.get(key)
        if ent is None:
            pin = self.device.type == "cuda"
            ent = self._pool[key] = {
                "slots": [_WireSlot(key[0], key[1], pin) for _ in range(max(2, self.depth))],
                "next": 0,
            }
        slots = ent["slots"]
        slot = slots[ent["next"]]
        ent["next"] = (ent["next"] + 1) % len(slots)
        if slot.event is not None:
            slot.event.synchronize()  # the copy out of this buffer finished
            slot.event = None
        return slot

    def ship(self, slot: _WireSlot):
        """Copy the slot to the device and return its (wire, counts, bases)
        device views. On the card: a non-blocking copy on the copy stream, an
        event recorded after it, the compute stream made to wait on that
        event, and the device buffer marked as used by the compute stream so
        the caching allocator cannot hand it out while K4 still reads it. On
        the CPU: a plain copy (never an alias of the pooled buffer)."""
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=self.device)
            cs = self._copy_stream
            with torch.cuda.stream(cs):
                dev = torch.empty(slot.host.shape, dtype=torch.uint8, device=self.device)
                dev.copy_(slot.host, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(cs)
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ev)
            dev.record_stream(compute)
            slot.event = ev
        else:
            dev = slot.host.clone()
        slot.dev = dev
        return device_views(dev, slot.K, slot.wire_bytes)

    def retire(self, slot: _WireSlot) -> None:
        """The chunk's device work that reads the shipped wire is enqueued:
        drop the slot's hold on the device buffer, so it goes back to the
        caching allocator once the compute stream is past it."""
        slot.dev = None

    # ---- drain -----------------------------------------------------------

    def is_drain_thread(self) -> bool:
        return self._thread is not None and threading.current_thread() is self._thread

    def submit(self, item, K: int) -> None:
        """Queue one chunk's packed outputs for ordered delivery. Blocks
        while `depth` chunks are already in flight (backpressure)."""
        if self._thread is None:
            self._start_thread()
        with self._cv:
            while self._inflight >= self.depth and not self._closed:
                self._cv.wait()
            self._inflight += 1
        self._q.put((item, K))

    def pending_error(self) -> bool:
        """True once an unguarded drain failure is stashed for barrier():
        the sender polls this per chunk and stops ingesting."""
        with self._cv:
            return self._error is not None

    def barrier(self) -> None:
        """Wait until every submitted chunk has been delivered; re-raise a
        drain failure here when the junction has no handler to own it."""
        if self._thread is not None:
            with self._cv:
                while self._inflight > 0:
                    self._cv.wait()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _start_thread(self) -> None:
        self._q = queue.Queue()
        self._thread = threading.Thread(
            target=self._drain_loop,
            daemon=True,
            name=f"siddhi-pipeline-{self.junction.schema.stream_id}",
        )
        self._thread.start()

    def _drain_loop(self) -> None:
        setup_error = None
        if self.device.type == "cuda":
            try:
                torch.cuda.set_device(self.device)
            except Exception as exc:  # every chunk then fails with it
                setup_error = exc
        while True:
            item = self._q.get()
            if item is None:
                return
            packs, K = item
            try:
                if setup_error is not None:
                    raise setup_error
                self.drain_fn(packs, K)
            except Exception as exc:  # must not kill the worker
                self._on_drain_error(exc)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _route_drain_error(self, exc: Exception) -> bool:
        """True when the junction's exception handler owned the error;
        unguarded junctions get False and the failure goes back to the
        sender."""
        j = self.junction
        if j.exception_handler is not None:
            j._on_worker_error(exc, "pipeline drain")
            return True
        return False

    def _on_drain_error(self, exc: Exception) -> None:
        if self._route_drain_error(exc):
            return
        with self._cv:
            if self._error is None:
                self._error = exc  # surfaces to the sender at barrier()

    def close(self) -> None:
        """Flush nothing (callers barrier first); stop the drain worker."""
        self._closed = True
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            self._q.put(None)
            t.join(timeout=2.0)
        self._thread = None
