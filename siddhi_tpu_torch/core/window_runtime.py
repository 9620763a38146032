"""Named windows: `define window W (...) <window> [output <events>]`.

Reference: core/window/Window.java:63-300 — a shared window processor;
queries insert into it, read its emission stream, join against its live
buffer (find :261) and pull it in store queries. As in the JAX package
(siddhi_tpu/core/window_runtime.py), the buffer is one device state owned by
this runtime, stepped by the window's own stage (`make_window`, every window
of core/windows.py and core/windows_special.py, with their kernels); its
emissions go out through an output junction, and join sides and store
queries read its live `view()` like a table's.
"""

from __future__ import annotations

import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import KIND_CURRENT, KIND_EXPIRED, EventBatch, StreamSchema
from siddhi_tpu_torch.core.executor import Scope
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.windows import make_window
from siddhi_tpu_torch.query_api.definition import WindowDefinition


class NamedWindow:
    """The shared window processor and its live findable buffer."""

    is_named_window = True

    def __init__(self, definition: WindowDefinition, interner, device):
        if definition.window is None:
            raise SiddhiAppCreationError(
                f"window '{definition.id}' needs a window type, "
                "e.g. define window W (...) length(10)")
        self.definition = definition
        self.window_id = definition.id
        self.device = torch.device(device)
        self.schema = StreamSchema(definition.id,
                                   [(a.name, a.type) for a in definition.attributes])
        scope = Scope(interner, self.device)
        scope.add_stream(definition.id, self.schema.attr_types)
        self.stage = make_window(definition.window, self.schema, definition.id, scope)
        self.out_events = definition.output_events  # current | expired | all
        self.state = self.stage.init_state()
        self.needs_scheduler = self.stage.needs_scheduler
        cron = getattr(self.stage, "cron_schedule", None)
        self.host_next_timer = cron.next_fire_ms if cron is not None else None
        self.out_junction = None  # wired by the app runtime
        self.timer_target = None

    # the findable protocol (shared with InMemoryTable)
    @property
    def table_id(self) -> str:
        return self.window_id

    def view(self, state):
        return self.stage.view(state)

    def receive(self, batch: EventBatch, now: int):
        """Step the window over inserted rows (or a TIMER row); the caller
        holds the app's processing lock. Returns (emissions, aux)."""
        now_t = torch.full((), now, dtype=torch.int64, device=self.device)
        self.state, out_flow = self.stage.apply(
            self.state, Flow(batch=batch, ref=self.window_id, now=now_t))
        b = out_flow.batch
        # `output current|expired events` narrows what downstream queries
        # see (reference: Window.java outputEventType dispatch)
        if self.out_events == "current":
            valid = b.valid & (b.kind != KIND_EXPIRED)
        elif self.out_events == "expired":
            valid = b.valid & (b.kind != KIND_CURRENT)
        else:
            valid = b.valid
        return EventBatch(b.ts, b.kind, valid, b.cols), out_flow.aux
