"""Per-junction flight recorder: a bounded ring of the last N events.

Ported from siddhi_tpu/observability/flight.py. When a dispatch fails, the
question is not only what failed but what flowed through just before. Each
opted-in junction keeps a fixed columnar arena of the last N events
(timestamp and physical attribute values) that is:

* written on every publish with no per-event Python allocation: the arena is
  allocated once and rows are copied in with at most two slice assignments a
  batch;
* decoded to host rows only on demand (`events()`), by the same vectorized
  `rows_from_arrays` the junction's own host decode uses;
* readable with `runtime.flight_record(stream_id)`.

Enabled per stream with `@flightRecorder(size='256')` or process-wide with
`SIDDHI_TPU_FLIGHT=N`. When not enabled the junction pays one `is None`
check a publish.

Cost when enabled: the fused `send_columns` path records from the host
columns it was given (no device read); the per-batch publish reads the
device batch back, all lanes in one device-to-host copy
(`StreamSchema.d2h_codec`), once a publish.
"""

from __future__ import annotations

import logging
import os
import threading

import numpy as np

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.types import NUMPY_DTYPE

DEFAULT_FLIGHT_SIZE = 256
_MAX_FLIGHT_SIZE = 65536

FLIGHT_ENV = "SIDDHI_TPU_FLIGHT"


def flight_env_size() -> int:
    """Process-wide override: N > 0 arms a ring of N events on every
    junction; 0 or unset defers to each stream's `@flightRecorder`. A
    malformed value warns (the recorder is then not armed); an oversized one
    is clamped to the maximum."""
    log = logging.getLogger(__name__)
    v = os.environ.get(FLIGHT_ENV, "").strip()
    if not v:
        return 0
    try:
        n = int(v)
    except ValueError:
        log.warning("%s=%r is not an integer — the flight recorder is NOT armed", FLIGHT_ENV, v)
        return 0
    if n < 0:
        log.warning("%s=%d is negative — the flight recorder is NOT armed", FLIGHT_ENV, n)
        return 0
    if n > _MAX_FLIGHT_SIZE:
        log.warning("%s=%d exceeds the maximum; clamping the ring to %d events",
                    FLIGHT_ENV, n, _MAX_FLIGHT_SIZE)
        return _MAX_FLIGHT_SIZE
    return n


def iter_flight_annotation_problems(ann):
    """One message per malformed `@flightRecorder` element."""
    for k, v in ann.elements:
        if k == "size" or (k is None and len(ann.elements) == 1):
            try:
                ok = 1 <= int(v) <= _MAX_FLIGHT_SIZE
            except (TypeError, ValueError):
                ok = False
            if not ok:
                yield f"@flightRecorder size '{v}' must be an integer in 1..{_MAX_FLIGHT_SIZE}"
        else:
            yield (f"unknown @flightRecorder option '{k if k is not None else v}'"
                   " (expected size)")


def resolve_flight_annotation(ann) -> int:
    """Ring size for one stream from its `@flightRecorder` annotation (or
    None), the SIDDHI_TPU_FLIGHT override folded in; 0 = not enabled.
    Raises SiddhiAppCreationError on malformed options."""
    size = 0
    if ann is not None:
        for problem in iter_flight_annotation_problems(ann):
            raise SiddhiAppCreationError(problem)
        size = int(ann.element("size") or ann.element(None) or DEFAULT_FLIGHT_SIZE)
    return max(size, flight_env_size())


def batch_to_host(schema, batch):
    """A device batch's (ts, kind, valid, cols) on the host, all lanes in
    one device-to-host copy."""
    pack, unpack = schema.d2h_codec(batch.capacity)
    return unpack(pack(batch).cpu().numpy())


class FlightRecorder:
    """Fixed columnar arena of the last `size` events through one junction.

    The arena (one [size] array per attribute, plus ts and kind lanes) is
    allocated once; `record_*` copies the batch tail in circularly, so
    recording allocates nothing a row. Thread-safe: publishes arrive from
    sender, drain and scheduler threads while `events()` reads."""

    def __init__(self, schema, interner, size: int = DEFAULT_FLIGHT_SIZE):
        if size <= 0:
            raise ValueError("flight recorder size must be positive")
        self.schema = schema
        self.interner = interner
        self.size = int(size)
        self._ts = np.zeros((self.size,), np.int64)
        self._kind = np.zeros((self.size,), np.int8)
        self._cols = {n: np.zeros((self.size,), NUMPY_DTYPE[t]) for n, t in schema.attrs}
        self._head = 0  # next write slot
        self._count = 0  # events ever recorded
        self._lock = threading.Lock()

    # ---- recording -------------------------------------------------------

    def _write(self, ts, kind, cols, n: int) -> None:
        """Copy the last min(n, size) rows into the ring (the caller holds
        the lock); `cols` maps attribute -> [n] physical host array."""
        if n <= 0:
            return
        if n > self.size:  # only the tail can survive
            ts = ts[n - self.size:]
            kind = None if kind is None else kind[n - self.size:]
            cols = {k: v[n - self.size:] for k, v in cols.items()}
            self._count += n - self.size
            n = self.size
        h = self._head
        first = min(n, self.size - h)
        dsts = [(h, 0, first)]
        if first < n:
            dsts.append((0, first, n))
        for dst, lo, hi in dsts:
            m = hi - lo
            self._ts[dst:dst + m] = ts[lo:hi]
            self._kind[dst:dst + m] = 0 if kind is None else kind[lo:hi]
            for name, arena in self._cols.items():
                arena[dst:dst + m] = cols[name][lo:hi]
        self._head = (h + n) % self.size
        self._count += n

    def record_batch(self, batch) -> None:
        """Record a device batch's valid rows (the per-batch publish)."""
        ts, kind, valid, cols = batch_to_host(self.schema, batch)
        idx = np.nonzero(valid)[0]
        if idx.size == 0:
            return
        with self._lock:
            self._write(ts[idx], kind[idx], {n: c[idx] for n, c in cols.items()}, idx.size)

    def record_columns(self, timestamps, cols, n: int) -> None:
        """Record host columnar rows (the fused ingest: every row is a valid
        CURRENT event and the arrays never touched the device)."""
        if n <= 0:
            return
        ts = np.asarray(timestamps)[:n]
        host = {name: np.asarray(cols[name])[:n] for name in self._cols}
        with self._lock:
            self._write(ts, None, host, n)

    # ---- reading ---------------------------------------------------------

    def events(self, limit: int | None = None) -> list[tuple[int, tuple]]:
        """The recorded ring, oldest first, as (timestamp, data tuple)."""
        from siddhi_tpu_torch.core.event import rows_from_arrays

        with self._lock:
            n = min(self._count, self.size)
            if n == 0:
                return []
            order = (np.arange(n) + (self._head - n)) % self.size  # ring -> insertion order
            ts = self._ts[order].copy()
            kind = self._kind[order].copy()
            cols = {name: a[order].copy() for name, a in self._cols.items()}
        if limit is not None and limit < n:
            ts, kind = ts[n - limit:], kind[n - limit:]
            cols = {k: v[n - limit:] for k, v in cols.items()}
            n = limit
        triples = rows_from_arrays(self.schema, ts, kind, cols, n, self.interner)
        return [(t, data) for t, _k, data in triples]

    def describe_state(self) -> dict:
        with self._lock:  # one read: recorded, total and the ts bounds agree
            n = min(self._count, self.size)
            total = self._count
            newest = int(self._ts[(self._head - 1) % self.size]) if n else None
            oldest = int(self._ts[(self._head - n) % self.size]) if n else None
        return {"size": self.size, "recorded": n, "total": total,
                "oldest_ts": oldest, "newest_ts": newest}
