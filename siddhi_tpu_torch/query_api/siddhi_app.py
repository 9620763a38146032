"""Top-level SiddhiApp AST container.

Reference: siddhi-query-api .../SiddhiApp.java — ordered definitions +
execution elements + app-level annotations.
"""

from __future__ import annotations

import dataclasses
from typing import Union

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.definition import (
    AggregationDefinition,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TriggerDefinition,
    WindowDefinition,
)
from siddhi_tpu_torch.query_api.execution import Partition, Query

ExecutionElement = Union[Query, Partition]


@dataclasses.dataclass
class SiddhiApp:
    stream_definitions: dict[str, StreamDefinition] = dataclasses.field(default_factory=dict)
    table_definitions: dict[str, TableDefinition] = dataclasses.field(default_factory=dict)
    window_definitions: dict[str, WindowDefinition] = dataclasses.field(default_factory=dict)
    trigger_definitions: dict[str, TriggerDefinition] = dataclasses.field(default_factory=dict)
    function_definitions: dict[str, FunctionDefinition] = dataclasses.field(default_factory=dict)
    aggregation_definitions: dict[str, AggregationDefinition] = dataclasses.field(
        default_factory=dict
    )
    execution_elements: list[ExecutionElement] = dataclasses.field(default_factory=list)
    annotations: list[Annotation] = dataclasses.field(default_factory=list)

    @staticmethod
    def siddhi_app(name: str | None = None) -> "SiddhiApp":
        app = SiddhiApp()
        if name:
            app.annotations.append(Annotation("name", [(None, name)]))
        return app

    def define_stream(self, d: StreamDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.stream_definitions[d.id] = d
        return self

    def define_table(self, d: TableDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.table_definitions[d.id] = d
        return self

    def define_window(self, d: WindowDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.window_definitions[d.id] = d
        return self

    def define_trigger(self, d: TriggerDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.trigger_definitions[d.id] = d
        return self

    def define_function(self, d: FunctionDefinition) -> "SiddhiApp":
        self.function_definitions[d.id] = d
        return self

    def define_aggregation(self, d: AggregationDefinition) -> "SiddhiApp":
        self._check_unique(d.id)
        self.aggregation_definitions[d.id] = d
        return self

    def add_query(self, q: Query) -> "SiddhiApp":
        self.execution_elements.append(q)
        return self

    def add_partition(self, p: Partition) -> "SiddhiApp":
        self.execution_elements.append(p)
        return self

    @property
    def name(self) -> str:
        for a in self.annotations:
            if a.name.lower() in ("app:name", "app", "name"):
                v = a.element("name") or a.element(None)
                if v:
                    return v
        return "SiddhiApp"

    def _check_unique(self, id_: str) -> None:
        for m in (
            self.stream_definitions,
            self.table_definitions,
            self.window_definitions,
            self.trigger_definitions,
            self.aggregation_definitions,
        ):
            if id_ in m:
                raise ValueError(f"duplicate definition id '{id_}'")
