"""Timer scheduling: TIMER-event injection for time-based windows and rates.

Reference: util/Scheduler.java:41-115 + util/SystemTimeBasedScheduler.java — a
dedicated thread injects TIMER events into the processor chain at notified
times. Here each target keeps at most one outstanding fire time (window steps
re-report their next deadline via the step's aux output, so the schedule is
self-sustaining). A target that raises is handed to `on_error(exc)` and the
thread goes on timing the others.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable


class SystemTimeScheduler:
    def __init__(self, on_error: Callable[[Exception], None]) -> None:
        self._on_error = on_error
        self._heap: list[tuple[int, int, Callable[[int], None]]] = []
        self._times: dict[int, int] = {}  # id(target) -> scheduled time
        self._cv = threading.Condition()
        self._serial = 0
        self._stop = False
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, daemon=True)
                self._thread.start()

    def notify_at(self, t_ms: int, target: Callable[[int], None]) -> None:
        with self._cv:
            key = id(target)
            prev = self._times.get(key)
            if prev is not None and prev <= t_ms:
                return  # an earlier-or-equal fire is already pending
            self._times[key] = t_ms
            self._serial += 1
            heapq.heappush(self._heap, (t_ms, self._serial, target))
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (
                    not self._heap or self._heap[0][0] > time.time() * 1000
                ):
                    if self._heap:
                        delay = max(self._heap[0][0] / 1000 - time.time(), 0.0)
                        self._cv.wait(timeout=min(delay, 0.25))
                    else:
                        self._cv.wait(timeout=0.25)
                if self._stop:
                    return
                t_ms, _, target = heapq.heappop(self._heap)
                if self._times.get(id(target)) == t_ms:
                    del self._times[id(target)]
                else:
                    continue  # superseded entry
            try:
                target(t_ms)
            except Exception as exc:  # the timing thread outlives a failed target
                self._on_error(exc)

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        # join so no timer target is mid-flight (e.g. inside a device call)
        # when the interpreter tears down — that aborts the process
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
