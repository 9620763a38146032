"""Playback (event-time) clock + event-time scheduler.

Reference: util/timestamp/ — TimestampGenerator SPI with system-time and
event-time impls; `@app:playback(idle.time='100 millisec', increment='2 sec')`
(SiddhiAppParser.java:166-212) drives the app clock from event timestamps with
an idle heartbeat; util/EventTimeBasedScheduler.java:28 fires timers on the
virtual clock instead of wall time.
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, Optional


class EventTimeClock:
    """Virtual clock advanced by event timestamps; optional idle heartbeat
    bumps it by `increment_ms` after `idle_ms` without events."""

    def __init__(
        self,
        idle_ms: Optional[int] = None,
        increment_ms: Optional[int] = None,
    ):
        self._t = 0
        self._lock = threading.Lock()
        self._listeners: list[Callable[[int], None]] = []
        self.idle_ms = idle_ms
        self.increment_ms = increment_ms
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_advance = None

    def now(self) -> int:
        with self._lock:
            return self._t

    def on_advance(self, fn: Callable[[int], None]) -> None:
        self._listeners.append(fn)

    def advance(self, t_ms: int) -> None:
        import time as _time

        with self._lock:
            if t_ms <= self._t:
                return
            self._t = t_ms
            self._last_advance = _time.monotonic()
        for fn in self._listeners:
            fn(t_ms)

    def start_heartbeat(self) -> None:
        if self.idle_ms is None or self.increment_ms is None or self._thread:
            return
        self._stop.clear()

        def run():
            import time as _time

            while not self._stop.wait(self.idle_ms / 1000.0):
                with self._lock:
                    idle = (
                        self._last_advance is not None
                        and (_time.monotonic() - self._last_advance) * 1000
                        >= self.idle_ms
                    )
                    t = self._t + self.increment_ms if idle else None
                if t is not None:
                    self.advance(t)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None


class EventTimeScheduler:
    """Same notify_at contract as SystemTimeScheduler, but fires when the
    playback clock passes the scheduled time (reference:
    util/EventTimeBasedScheduler.java). A target that raises is handed to
    `on_error(exc)` and the due targets after it still fire."""

    def __init__(self, clock: EventTimeClock, on_error: Callable[[Exception], None]):
        self.clock = clock
        self._on_error = on_error
        self._heap: list[tuple[int, int, Callable[[int], None]]] = []
        self._times: dict[int, int] = {}
        self._lock = threading.Lock()
        self._serial = 0
        self._tls = threading.local()  # re-entrancy guard for notify_at
        clock.on_advance(self._on_advance)

    def start(self) -> None:  # same surface as SystemTimeScheduler
        pass

    def notify_at(self, t_ms: int, target: Callable[[int], None]) -> None:
        with self._lock:
            key = id(target)
            prev = self._times.get(key)
            if prev is not None and prev <= t_ms:
                return
            self._times[key] = t_ms
            self._serial += 1
            heapq.heappush(self._heap, (t_ms, self._serial, target))
        # already due? (no-op when called from inside a dispatch: the outer
        # _on_advance loop re-checks the heap, so periodic targets that
        # re-arm themselves from their own callback cannot recurse)
        if not getattr(self._tls, "dispatching", False):
            self._on_advance(self.clock.now())

    def _on_advance(self, now_ms: int) -> None:
        if getattr(self._tls, "dispatching", False):
            return  # the outer loop will pick up anything newly due
        self._tls.dispatching = True
        try:
            while True:
                with self._lock:
                    if not self._heap or self._heap[0][0] > now_ms:
                        return
                    t_ms, _, target = heapq.heappop(self._heap)
                    if self._times.get(id(target)) == t_ms:
                        del self._times[id(target)]
                    else:
                        continue
                try:
                    target(t_ms)
                except Exception as exc:
                    self._on_error(exc)
        finally:
            self._tls.dispatching = False

    def shutdown(self) -> None:
        self.clock.stop()
