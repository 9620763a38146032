"""Stream junctions and input handlers — host-side event routing.

Reference: stream/StreamJunction.java:58-404 (per-stream pub/sub fan-out) and
stream/input/InputManager.java / InputHandler.java. The device does all per-event
math; the junction packs host events into fixed-capacity columnar micro-batches
and fans them out to subscriber steps synchronously, like the reference's
default pass-through mode.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np

from siddhi_tpu_torch.core.event import EventBatch, StreamSchema
from siddhi_tpu_torch.core.types import InternTable
from siddhi_tpu_torch.observability.flight import FlightRecorder
from siddhi_tpu_torch.observability.lineage import LineageArena, current_publisher

# subscriber: fn(batch: EventBatch, now_ms: int) -> None
Subscriber = Callable[[EventBatch, int], None]


class StreamJunction:
    def __init__(
        self, schema: StreamSchema, interner: InternTable, batch_size: int, device
    ):
        self.schema = schema
        self.interner = interner
        self.batch_size = batch_size
        self.device = device
        self.subscribers: list[Subscriber] = []
        self.stream_callbacks: list[Callable] = []
        # fused ingest (core/ingest.py): every subscriber that registered a
        # FuseEndpoint; the engine built from them at app start
        self.fuse_candidates: list = []
        self.fused_ingest = None
        # set_exception_handler: subscriber and drain failures go to
        # handler(exc) instead of the sender
        self.exception_handler: Callable[[Exception], None] | None = None
        # RLock: a query may legally insert into its own input stream
        # (reference allows self-feeding junctions); recursion stays on-thread
        self.lock = threading.RLock()
        # flight recorder (observability/flight.py): the last N events, armed
        # by @flightRecorder(size='N') or SIDDHI_TPU_FLIGHT=N; None = one
        # check a publish
        self.flight = None
        # lineage arena (observability/lineage.py): stamps each valid CURRENT
        # event with a seq id and keeps the last N decodable, armed by
        # @app:lineage; None = one check a publish
        self.lineage = None

    def enable_flight(self, size: int) -> None:
        """Attach a flight recorder of the last `size` events; re-arming at
        the same size keeps the recorded history."""
        if self.flight is not None and self.flight.size == int(size):
            return
        self.flight = FlightRecorder(self.schema, self.interner, size)

    def enable_lineage(self, size: int) -> None:
        """Attach a lineage arena stamping and keeping the last `size`
        CURRENT events; re-arming at the same size keeps the seq counter."""
        if self.lineage is not None and self.lineage.size == int(size):
            return
        self.lineage = LineageArena(self.schema, self.interner, size)

    def describe_state(self) -> dict:
        """Wiring, the fused engine's counters, the flight ring and the
        lineage arena (one host read each, no device read)."""
        d: dict = {"subscribers": len(self.subscribers), "callbacks": len(self.stream_callbacks),
                   "batch_size": self.batch_size}
        if self.fused_ingest is not None:
            d["pipeline"] = self.fused_ingest.describe_state()
        if self.flight is not None:
            d["flight"] = self.flight.describe_state()
        if self.lineage is not None:
            d["lineage"] = self.lineage.describe_state()
        return d

    def subscribe(self, fn: Subscriber) -> None:
        self.subscribers.append(fn)

    def add_stream_callback(self, fn: Callable) -> None:
        self.stream_callbacks.append(fn)

    def publish_batch(self, batch: EventBatch, now: int) -> None:
        with self.lock:
            if self.flight is not None:
                self.flight.record_batch(batch)
            if self.lineage is not None:
                self._stamp(batch)
            handler = self.exception_handler
            for fn in self.subscribers:
                if handler is None:
                    fn(batch, now)
                    continue
                try:
                    fn(batch, now)
                except Exception as e:
                    handler(e)
            if self.stream_callbacks:
                events = self.schema.from_batch(batch, self.interner)
                if events:
                    rows = [(ts, data) for ts, _kind, data in events]
                    for cb in self.stream_callbacks:
                        cb(rows)

    def _stamp(self, batch: EventBatch) -> None:
        """Stamp the batch's valid CURRENT rows with seq ids; when a recorded
        query's insert publishes them, note it as their producer (its
        recorder counted this batch's published records in its observe,
        which runs before the publish, so the range starts n records back
        from its pub_count)."""
        base, n = self.lineage.record_batch(batch)
        pub = current_publisher()
        if n and pub is not None:
            qid, rec = pub
            self.lineage.note_producer(base, n, qid, max(rec.pub_count - n, 0))

    def _on_worker_error(self, exc: Exception, who: str) -> None:
        """A failure on a worker thread (the fused drain) that the exception
        handler owns: log it and hand it over."""
        logging.getLogger(__name__).error(
            "%s for stream '%s' failed: %s", who, self.schema.stream_id, exc
        )
        try:
            self.exception_handler(exc)
        except Exception:
            logging.getLogger(__name__).exception(
                "exception handler for stream '%s' raised", self.schema.stream_id
            )

    def send_rows(
        self,
        timestamps: Sequence[int],
        rows: Sequence[Sequence[Any]],
        now: int | None = None,
    ) -> None:
        """Pack host rows and publish, chunking to the junction batch size."""
        for ofs in range(0, len(rows), self.batch_size):
            ts_chunk = list(timestamps[ofs : ofs + self.batch_size])
            row_chunk = list(rows[ofs : ofs + self.batch_size])
            batch = self.schema.to_batch(
                ts_chunk, row_chunk, self.interner, self.device, capacity=self.batch_size
            )
            self.publish_batch(batch, now if now is not None else ts_chunk[-1])


class InputHandler:
    """Reference: stream/input/InputHandler.java:27-68."""

    def __init__(self, junction: StreamJunction, clock: Callable[[], int]):
        self.junction = junction
        self.clock = clock

    def send(self, data: Sequence[Any], timestamp: int | None = None) -> None:
        ts = timestamp if timestamp is not None else self.clock()
        self.junction.send_rows([ts], [tuple(data)], now=self.clock())

    def send_many(
        self, rows: Sequence[Sequence[Any]], timestamps: Sequence[int] | None = None
    ) -> None:
        if timestamps is None:
            t = self.clock()
            timestamps = [t] * len(rows)
        self.junction.send_rows(
            list(timestamps), [tuple(r) for r in rows], now=self.clock()
        )

    def send_columns(
        self,
        timestamps: np.ndarray,
        cols: dict[str, np.ndarray],
        now: int | None = None,
    ) -> None:
        """High-throughput columnar ingest: one device batch per junction
        batch-size chunk, no per-row Python work (the analog of the reference's
        @async batched Disruptor path, StreamJunction.java:262-298).

        All-numeric calls (pre-interned string ids included) of at least two
        batches take the junction's fused engine when it has one
        (core/ingest.py: K batches per copy and per device loop); otherwise
        each batch rides the packed codec: ONE contiguous host->device copy
        per batch, split into lanes on the device.
        """
        j = self.junction
        n = len(timestamps)
        if now is None:
            now = self.clock()  # same wall-clock default as send/send_many
        numeric = all(np.asarray(v).dtype.kind not in "OUS" for v in cols.values())
        fi = j.fused_ingest
        if numeric and fi is not None and fi.try_send(timestamps, cols, now):
            return
        if numeric:
            encode, decode = j.schema.packed_codec(j.batch_size, j.device)
            for ofs in range(0, n, j.batch_size):
                end = min(ofs + j.batch_size, n)
                m = end - ofs
                buf = encode(
                    timestamps[ofs:end], {k: v[ofs:end] for k, v in cols.items()}, m
                )
                j.publish_batch(decode(buf, m), now)
            return
        for ofs in range(0, n, j.batch_size):
            ts_chunk = timestamps[ofs : ofs + j.batch_size]
            chunk = {k: v[ofs : ofs + j.batch_size] for k, v in cols.items()}
            batch = j.schema.to_batch_cols(
                ts_chunk, chunk, j.interner, j.device, capacity=j.batch_size
            )
            j.publish_batch(batch, now)


def system_clock_ms() -> int:
    return int(time.time() * 1000)
