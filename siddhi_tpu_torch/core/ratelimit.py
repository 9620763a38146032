"""Output rate limiters: `output [all|first|last] every N events / N sec` and
`output snapshot every N sec`.

Reference: query/output/ratelimit/OutputRateLimiter.java:38 and its 17
subclasses (event/*, time/*, snapshot/*). FIRST/LAST with a grouped query
automatically become per-group variants (reference: OutputParser
constructOutputRateLimiter dispatch). Rate limiting runs host-side over the
decoded output rows — rate-limited outputs are low-volume by construction, and
the buffered/held rows are exactly the host-visible product.

Rows are `(ts, kind, data, key)` tuples; `key` is the group-by key id (None
when the query has no group-by). Snapshot limiting holds the latest aggregate
row (per key when grouped) and re-emits it every interval with the snapshot
timestamp (reference: WrappedSnapshotOutputRateLimiter for aggregating
selectors; windowed full-content snapshots are approximated the same way).
"""

from __future__ import annotations

from typing import Optional

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import KIND_CURRENT
from siddhi_tpu_torch.query_api.execution import (
    EventOutputRate,
    OutputRateType,
    SnapshotOutputRate,
    TimeOutputRate,
)

Row = tuple  # (ts, kind, data, key)


class RateLimiter:
    """Base: process() on each output chunk, on_timer() at period boundaries."""

    period_ms: Optional[int] = None  # not None => needs the scheduler

    def process(self, rows: list[Row], now: int) -> list[Row]:
        raise NotImplementedError

    def on_timer(self, t_ms: int) -> list[Row]:
        return []


class EventAllLimiter(RateLimiter):
    """Release buffered output in chunks of N events
    (reference: event/AllPerEventOutputRateLimiter)."""

    def __init__(self, n: int):
        self.n = n
        self.buf: list[Row] = []

    def process(self, rows, now):
        self.buf.extend(rows)
        out: list[Row] = []
        while len(self.buf) >= self.n:
            out.extend(self.buf[: self.n])
            del self.buf[: self.n]
        return out


class EventFirstLimiter(RateLimiter):
    """Emit the first event of every N (reference:
    event/FirstPerEventOutputRateLimiter); per-group: first per key within
    each N-chunk (FirstGroupByPerEventOutputRateLimiter)."""

    def __init__(self, n: int, grouped: bool):
        self.n = n
        self.grouped = grouped
        self.count = 0
        self.seen: set = set()
        self.held: list = []  # grouped: firsts buffered until chunk close

    def process(self, rows, now):
        out = []
        for r in rows:
            if self.grouped:
                # the grouped form BUFFERS each group's first and releases
                # the batch when the chunk closes (reference:
                # FirstGroupByPerEventOutputRateLimiter.process collects into
                # allComplexEventChunk and sends at counter == value)
                if r[3] not in self.seen:
                    self.seen.add(r[3])
                    self.held.append(r)
            elif self.count == 0:
                out.append(r)
            self.count += 1
            if self.count == self.n:
                self.count = 0
                self.seen.clear()
                out.extend(self.held)
                self.held.clear()
        return out


class EventLastLimiter(RateLimiter):
    """Emit the last event of every N (reference:
    event/LastPerEventOutputRateLimiter); per-group: last per key within each
    N-chunk (LastGroupByPerEventOutputRateLimiter)."""

    def __init__(self, n: int, grouped: bool):
        self.n = n
        self.grouped = grouped
        self.count = 0
        self.held: dict = {}  # key -> row (insertion ordered)

    def process(self, rows, now):
        out = []
        for r in rows:
            self.held[r[3] if self.grouped else None] = r
            self.count += 1
            if self.count == self.n:
                out.extend(self.held.values())
                self.held.clear()
                self.count = 0
        return out


class TimeAllLimiter(RateLimiter):
    """Flush everything each period (reference: time/AllPerTimeOutputRateLimiter)."""

    def __init__(self, t_ms: int):
        self.period_ms = t_ms
        self.buf: list[Row] = []

    def process(self, rows, now):
        self.buf.extend(rows)
        return []

    def on_timer(self, t_ms):
        out, self.buf = self.buf, []
        return out


class TimeFirstLimiter(RateLimiter):
    """First event per period emits immediately (reference:
    time/FirstPerTimeOutputRateLimiter; grouped: FirstGroupByPerTime...)."""

    def __init__(self, t_ms: int, grouped: bool):
        self.period_ms = t_ms
        self.grouped = grouped
        self.seen: set = set()
        self.emitted = False

    def process(self, rows, now):
        out = []
        for r in rows:
            if self.grouped:
                if r[3] not in self.seen:
                    self.seen.add(r[3])
                    out.append(r)
            elif not self.emitted:
                self.emitted = True
                out.append(r)
        return out

    def on_timer(self, t_ms):
        self.seen.clear()
        self.emitted = False
        return []


class TimeLastLimiter(RateLimiter):
    """Hold the last event (per key when grouped); emit at each period
    (reference: time/LastPerTimeOutputRateLimiter / LastGroupByPerTime...)."""

    def __init__(self, t_ms: int, grouped: bool):
        self.period_ms = t_ms
        self.grouped = grouped
        self.held: dict = {}

    def process(self, rows, now):
        for r in rows:
            self.held[r[3] if self.grouped else None] = r
        return []

    def on_timer(self, t_ms):
        out = list(self.held.values())
        self.held.clear()
        return out


class SnapshotLimiter(RateLimiter):
    """Re-emit the latest row (per key when grouped) every period with the
    snapshot timestamp (reference: snapshot/*PerSnapshotOutputRateLimiter)."""

    def __init__(self, t_ms: int, grouped: bool):
        self.period_ms = t_ms
        self.grouped = grouped
        self.held: dict = {}

    def process(self, rows, now):
        for r in rows:
            if r[1] == KIND_CURRENT:  # snapshots track CURRENT state only
                self.held[r[3] if self.grouped else None] = r
        return []

    def on_timer(self, t_ms):
        return [(t_ms, kind, data, key) for (_ts, kind, data, key) in self.held.values()]


def build_rate_limiter(output_rate, grouped: bool) -> Optional[RateLimiter]:
    """reference: OutputParser.constructOutputRateLimiter dispatch table."""
    if output_rate is None:
        return None
    if isinstance(output_rate, EventOutputRate):
        if output_rate.events <= 0:
            raise SiddhiAppCreationError("output rate event count must be positive")
        if output_rate.type is OutputRateType.ALL:
            return EventAllLimiter(output_rate.events)
        if output_rate.type is OutputRateType.FIRST:
            return EventFirstLimiter(output_rate.events, grouped)
        return EventLastLimiter(output_rate.events, grouped)
    if isinstance(output_rate, TimeOutputRate):
        if output_rate.millis <= 0:
            raise SiddhiAppCreationError("output rate period must be positive")
        if output_rate.type is OutputRateType.ALL:
            return TimeAllLimiter(output_rate.millis)
        if output_rate.type is OutputRateType.FIRST:
            return TimeFirstLimiter(output_rate.millis, grouped)
        return TimeLastLimiter(output_rate.millis, grouped)
    if isinstance(output_rate, SnapshotOutputRate):
        return SnapshotLimiter(output_rate.millis, grouped)
    raise SiddhiAppCreationError(f"unknown output rate {output_rate!r}")
