"""Stream / table / window / trigger / function / aggregation definitions.

Reference: siddhi-query-api .../definition/*.java (StreamDefinition, TableDefinition,
WindowDefinition, TriggerDefinition, FunctionDefinition, AggregationDefinition,
Attribute) and aggregation/TimePeriod.java.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.expression import Expression, Variable
from siddhi_tpu_torch.core.types import AttrType


class SourceLocated:
    """Mixin: 1-based source position of the node's first token, stamped by
    the SiddhiQL parser (None for programmatic ASTs). Plain class attributes
    on purpose — they are not dataclass fields, so constructor signatures of
    the dataclasses mixing this in are unchanged."""

    line = None
    col = None


@dataclasses.dataclass
class Attribute(SourceLocated):
    name: str
    type: AttrType


@dataclasses.dataclass
class AbstractDefinition(SourceLocated):
    id: str
    attributes: list[Attribute] = dataclasses.field(default_factory=list)
    annotations: list[Annotation] = dataclasses.field(default_factory=list)

    def attribute(self, name: str, type_: AttrType) -> "AbstractDefinition":
        self.attributes.append(Attribute(name, type_))
        return self

    def annotation(self, ann: Annotation) -> "AbstractDefinition":
        self.annotations.append(ann)
        return self

    @property
    def attribute_names(self) -> list[str]:
        return [a.name for a in self.attributes]


class StreamDefinition(AbstractDefinition):
    pass


class TableDefinition(AbstractDefinition):
    pass


@dataclasses.dataclass
class WindowDefinition(AbstractDefinition):
    """`define window W(...) length(10) output all events`
    (reference: definition/WindowDefinition.java)."""

    window: Optional["WindowSpec"] = None
    output_events: str = "all"  # current | expired | all


@dataclasses.dataclass
class WindowSpec(SourceLocated):
    """A window invocation `ns:name(params)` attached to a stream or window
    def, plus static state-bound metadata: which builtin windows tumble
    (two device buckets instead of one ring), which arm host timers, and
    the constant row bound when one is declared — consumed by the static
    cost model (analysis/cost.py) and anyone else reasoning about device
    state without building a runtime stage. The sets mirror
    `core/windows.py make_window` dispatch."""

    namespace: Optional[str]
    name: str
    parameters: list[Expression] = dataclasses.field(default_factory=list)

    # tumbling family: state is cur + prev buckets (core/windows.py
    # BatchWindow / windows_special.py CronWindow)
    BATCH_WINDOWS = frozenset(
        {"lengthbatch", "timebatch", "externaltimebatch", "cron"}
    )
    # these arm the host scheduler unconditionally; externalTimeBatch joins
    # them only with its 4th (idle timeout) parameter — see arms_scheduler
    SCHEDULER_WINDOWS = frozenset({"time", "timelength", "timebatch", "cron"})
    # parameter position of the constant row bound, where one is declared
    _LENGTH_PARAM = {
        "length": 0, "lengthbatch": 0, "timelength": 1, "sort": 0,
        "frequent": 0,
    }

    @property
    def key(self) -> str:
        """Lowercased dispatch key (`ns:name` for extensions)."""
        return (
            self.name.lower()
            if self.namespace is None
            else f"{self.namespace}:{self.name}".lower()
        )

    @property
    def is_batch(self) -> bool:
        return self.key in self.BATCH_WINDOWS

    @property
    def arms_scheduler(self) -> bool:
        """True when this window needs host timer wake-ups between batches
        (mirrors the runtime stages' `needs_scheduler`)."""
        k = self.key
        if k in self.SCHEDULER_WINDOWS:
            return True
        return k == "externaltimebatch" and len(self.parameters) > 3

    def length_bound(self) -> Optional[int]:
        """The window's constant row bound, or None when its capacity is a
        runtime default (time-capacity family) / unknowable (extension,
        non-constant parameter)."""
        from siddhi_tpu_torch.query_api.expression import Constant

        i = self._LENGTH_PARAM.get(self.key)
        if i is None or i >= len(self.parameters):
            return None
        p = self.parameters[i]
        if isinstance(p, Constant) and isinstance(p.value, (int, float)) \
                and not isinstance(p.value, bool):
            return int(p.value)
        return None


@dataclasses.dataclass
class TriggerDefinition(SourceLocated):
    """`define trigger T at every 5 sec | 'cron' | 'start'`
    (reference: definition/TriggerDefinition.java)."""

    id: str
    at_every_ms: Optional[int] = None
    at_cron: Optional[str] = None
    at_start: bool = False
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FunctionDefinition(SourceLocated):
    """`define function f[lang] return type { body }`
    (reference: definition/FunctionDefinition.java)."""

    id: str
    language: str
    return_type: AttrType
    body: str
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


class Duration(enum.Enum):
    """reference: query-api aggregation/TimePeriod.java SEC..YEARS"""

    SECONDS = 1_000
    MINUTES = 60_000
    HOURS = 3_600_000
    DAYS = 86_400_000
    MONTHS = -2  # calendar-based; resolved by time conversion util
    YEARS = -1

    @property
    def millis(self) -> int:
        if self.value < 0:
            raise ValueError(f"{self.name} is calendar-based")
        return self.value


DURATION_ORDER = [
    Duration.SECONDS,
    Duration.MINUTES,
    Duration.HOURS,
    Duration.DAYS,
    Duration.MONTHS,
    Duration.YEARS,
]


@dataclasses.dataclass
class TimePeriod:
    """`every sec ... year` range or explicit list."""

    durations: list[Duration]

    @staticmethod
    def range(start: Duration, end: Duration) -> "TimePeriod":
        i, j = DURATION_ORDER.index(start), DURATION_ORDER.index(end)
        if i > j:
            raise ValueError(f"invalid time period {start}..{end}")
        return TimePeriod(DURATION_ORDER[i : j + 1])


@dataclasses.dataclass
class AggregationDefinition(SourceLocated):
    """`define aggregation A from S select ... group by ... aggregate by ts every ...`
    (reference: definition/AggregationDefinition.java)."""

    id: str
    basic_single_input_stream: "object" = None  # SingleInputStream (import cycle)
    selector: "object" = None  # Selector
    aggregate_attribute: Optional[Variable] = None
    time_period: Optional[TimePeriod] = None
    annotations: list[Annotation] = dataclasses.field(default_factory=list)

    def bucket_durations(self) -> list[Duration]:
        """The declared per-duration bucket tables (state-bound metadata:
        one closed-bucket device table per entry — analysis/cost.py sizes
        them; []) when the definition is incomplete."""
        if self.time_period is None:
            return []
        return list(self.time_period.durations)
