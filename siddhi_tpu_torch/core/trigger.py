"""Triggers: timestamp-event injection streams.

Reference: core/trigger/PeriodicTrigger.java:30-90, CronTrigger.java,
StartTrigger.java — `define trigger T at every 5 sec | 'cron expr' | 'start'`
creates a stream T(triggered_time long) and injects the trigger time into its
junction on schedule. As in the JAX package (siddhi_tpu/core/trigger.py), the
fires come from the app's scheduler: the wall clock's `SystemTimeScheduler`,
or the event-time `EventTimeScheduler` under @app:playback.
"""

from __future__ import annotations

from typing import Callable

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.query_api.definition import TriggerDefinition


class TriggerRuntime:
    def __init__(self, definition: TriggerDefinition, junction, scheduler,
                 clock: Callable[[], int]):
        self.definition = definition
        self.id = definition.id
        self.junction = junction
        self.scheduler = scheduler
        self.clock = clock
        self._running = False
        self.cron = None
        if definition.at_cron is not None:
            from siddhi_tpu_torch.utils.cron import CronSchedule

            try:
                self.cron = CronSchedule(definition.at_cron)
            except ValueError as e:
                raise SiddhiAppCreationError(f"trigger '{self.id}': {e}") from None

    def start(self) -> None:
        self._running = True
        if self.definition.at_start:
            now = self.clock()
            self.junction.send_rows([now], [(now,)], now=now)
            return
        self.scheduler.start()
        self.scheduler.notify_at(self._next_after(self.clock()), self._fire)

    def _next_after(self, t_ms: int) -> int:
        if self.definition.at_every_ms is not None:
            return t_ms + self.definition.at_every_ms
        return self.cron.next_fire_ms(t_ms)

    def _fire(self, t_ms: int) -> None:
        if not self._running:
            return
        self.junction.send_rows([t_ms], [(t_ms,)], now=t_ms)
        if self._running:
            self.scheduler.notify_at(self._next_after(t_ms), self._fire)

    def stop(self) -> None:
        self._running = False
