"""Execution elements: queries, input streams (single/join/state), pattern state
elements, handlers, selectors, output streams/rates, partitions, store queries.

Reference: siddhi-query-api .../execution/** (Query.java, StoreQuery.java,
partition/Partition.java, query/input/state/*StateElement.java,
query/selection/Selector.java, query/output/stream/*, query/output/ratelimit/*).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.definition import SourceLocated, WindowSpec
from siddhi_tpu_torch.query_api.expression import Expression, Variable


# ---------------------------------------------------------------------------
# stream handlers (filter / window / stream function)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Filter(SourceLocated):
    expression: Expression


@dataclasses.dataclass
class WindowHandler(SourceLocated):
    window: WindowSpec


@dataclasses.dataclass
class StreamFunctionHandler(SourceLocated):
    namespace: Optional[str]
    name: str
    parameters: list[Expression]


StreamHandler = Union[Filter, WindowHandler, StreamFunctionHandler]


# ---------------------------------------------------------------------------
# input streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SingleInputStream(SourceLocated):
    stream_id: str
    alias: Optional[str] = None  # `as e1`
    handlers: list[StreamHandler] = dataclasses.field(default_factory=list)
    is_inner: bool = False  # `#innerStream` inside partitions
    is_fault: bool = False  # `!faultStream`

    @property
    def ref(self) -> str:
        """Name by which expressions refer to this stream."""
        return self.alias or self.stream_id

    @staticmethod
    def fault_stream(stream_id: str) -> "SingleInputStream":
        """Programmatic `from !S` — S's fault stream (attributes + `_error`),
        auto-defined when S declares @OnError(action='STREAM')."""
        return SingleInputStream("!" + stream_id, is_fault=True)

    def filter(self, e: Expression) -> "SingleInputStream":
        self.handlers.append(Filter(e))
        return self

    def window(self, ns: Optional[str], name: str, *params: Expression) -> "SingleInputStream":
        self.handlers.append(WindowHandler(WindowSpec(ns, name, list(params))))
        return self


class JoinType(enum.Enum):
    JOIN = "join"  # inner
    LEFT_OUTER = "left outer join"
    RIGHT_OUTER = "right outer join"
    FULL_OUTER = "full outer join"


class JoinEventTrigger(enum.Enum):
    LEFT = "left"
    RIGHT = "right"
    ALL = "all"


@dataclasses.dataclass
class JoinInputStream(SourceLocated):
    left: SingleInputStream
    join_type: JoinType
    right: SingleInputStream
    on: Optional[Expression] = None
    trigger: JoinEventTrigger = JoinEventTrigger.ALL
    within: Optional[Expression] = None  # aggregation joins
    per: Optional[Expression] = None
    unidirectional: Optional[str] = None  # 'left' | 'right' | None


# ---------------------------------------------------------------------------
# pattern / sequence state elements
# (reference: execution/query/input/state/{Stream,Next,Every,Count,Logical,
#  AbsentStream}StateElement.java)
# ---------------------------------------------------------------------------


class StateElement(SourceLocated):
    """Base; every element may carry a `within_ms` bound
    (reference: query-api execution/query/input/state/StateElement.java)."""

    within_ms: Optional[int]


@dataclasses.dataclass
class StreamStateElement(StateElement):
    stream: SingleInputStream
    within_ms: Optional[int] = None


@dataclasses.dataclass
class AbsentStreamStateElement(StreamStateElement):
    waiting_time_ms: Optional[int] = None  # `not S for 5 sec`


@dataclasses.dataclass
class CountStateElement(StateElement):
    stream: StreamStateElement
    min_count: int = 0
    max_count: int = -1  # -1 == ANY / unbounded
    within_ms: Optional[int] = None

    ANY = -1


@dataclasses.dataclass
class NextStateElement(StateElement):
    state: StateElement
    next: StateElement
    within_ms: Optional[int] = None


@dataclasses.dataclass
class EveryStateElement(StateElement):
    state: StateElement
    within_ms: Optional[int] = None


class LogicalType(enum.Enum):
    AND = "and"
    OR = "or"


@dataclasses.dataclass
class LogicalStateElement(StateElement):
    left: StateElement
    type: LogicalType
    right: StateElement
    within_ms: Optional[int] = None


class StateStreamType(enum.Enum):
    PATTERN = "pattern"
    SEQUENCE = "sequence"


@dataclasses.dataclass
class StateInputStream(SourceLocated):
    type: StateStreamType
    state: StateElement
    within_ms: Optional[int] = None


InputStream = Union[SingleInputStream, JoinInputStream, StateInputStream]


def iter_state_streams(state: StateElement):
    """Yield every SingleInputStream referenced by a pattern/sequence state
    tree, in source order (used by the runtime for pre-validation and by the
    semantic analyzer for scope construction)."""
    if isinstance(state, CountStateElement):
        yield from iter_state_streams(state.stream)
    elif isinstance(state, StreamStateElement):
        yield state.stream
    elif isinstance(state, NextStateElement):
        yield from iter_state_streams(state.state)
        yield from iter_state_streams(state.next)
    elif isinstance(state, EveryStateElement):
        yield from iter_state_streams(state.state)
    elif isinstance(state, LogicalStateElement):
        yield from iter_state_streams(state.left)
        yield from iter_state_streams(state.right)


# ---------------------------------------------------------------------------
# selector
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OutputAttribute(SourceLocated):
    rename: Optional[str]
    expression: Expression

    @property
    def name(self) -> str:
        if self.rename:
            return self.rename
        if isinstance(self.expression, Variable):
            return self.expression.attribute
        raise ValueError(f"unnamed non-variable projection: {self.expression}")


class OrderDir(enum.Enum):
    ASC = "asc"
    DESC = "desc"


@dataclasses.dataclass
class OrderByAttribute:
    variable: Variable
    order: OrderDir = OrderDir.ASC


@dataclasses.dataclass
class Selector(SourceLocated):
    selection_list: list[OutputAttribute] = dataclasses.field(default_factory=list)
    group_by: list[Variable] = dataclasses.field(default_factory=list)
    having: Optional[Expression] = None
    order_by: list[OrderByAttribute] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    select_all: bool = False  # `select *`

    def select(self, rename: Optional[str], e: Expression) -> "Selector":
        self.selection_list.append(OutputAttribute(rename, e))
        return self


# ---------------------------------------------------------------------------
# output streams & rate limiting
# ---------------------------------------------------------------------------


class OutputEventsFor(enum.Enum):
    CURRENT = "current events"
    EXPIRED = "expired events"
    ALL = "all events"


@dataclasses.dataclass
class OutputStream(SourceLocated):
    output_events: OutputEventsFor = OutputEventsFor.CURRENT


@dataclasses.dataclass
class InsertIntoStream(OutputStream):
    target: str = ""
    is_inner: bool = False
    is_fault: bool = False


@dataclasses.dataclass
class ReturnStream(OutputStream):
    pass


@dataclasses.dataclass
class DeleteStream(OutputStream):
    target: str = ""
    on: Optional[Expression] = None


@dataclasses.dataclass
class UpdateSetAttribute:
    table_variable: Variable
    expression: Expression


@dataclasses.dataclass
class UpdateStream(OutputStream):
    target: str = ""
    on: Optional[Expression] = None
    set_attributes: Optional[list[UpdateSetAttribute]] = None


@dataclasses.dataclass
class UpdateOrInsertStream(OutputStream):
    target: str = ""
    on: Optional[Expression] = None
    set_attributes: Optional[list[UpdateSetAttribute]] = None


class OutputRateType(enum.Enum):
    ALL = "all"
    FIRST = "first"
    LAST = "last"


@dataclasses.dataclass
class EventOutputRate:
    events: int
    type: OutputRateType = OutputRateType.ALL


@dataclasses.dataclass
class TimeOutputRate:
    millis: int
    type: OutputRateType = OutputRateType.ALL


@dataclasses.dataclass
class SnapshotOutputRate:
    millis: int


OutputRate = Union[EventOutputRate, TimeOutputRate, SnapshotOutputRate, None]


# ---------------------------------------------------------------------------
# query / partition / store query
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Query(SourceLocated):
    input_stream: InputStream = None
    selector: Selector = dataclasses.field(default_factory=Selector)
    output_stream: OutputStream = dataclasses.field(default_factory=ReturnStream)
    output_rate: OutputRate = None
    annotations: list[Annotation] = dataclasses.field(default_factory=list)

    @staticmethod
    def query() -> "Query":
        return Query()

    def from_(self, s: InputStream) -> "Query":
        self.input_stream = s
        return self

    def select(self, sel: Selector) -> "Query":
        self.selector = sel
        return self

    def insert_into(self, target: str, for_: OutputEventsFor = OutputEventsFor.CURRENT) -> "Query":
        self.output_stream = InsertIntoStream(output_events=for_, target=target)
        return self

    def insert_into_fault(
        self, target: str, for_: OutputEventsFor = OutputEventsFor.CURRENT
    ) -> "Query":
        """Programmatic `insert into !target` (target must declare
        @OnError(action='STREAM'))."""
        self.output_stream = InsertIntoStream(
            output_events=for_, target="!" + target, is_fault=True
        )
        return self


@dataclasses.dataclass
class ValuePartitionType(SourceLocated):
    stream_id: str
    expression: Expression


@dataclasses.dataclass
class RangePartitionProperty:
    partition_key: str
    condition: Expression


@dataclasses.dataclass
class RangePartitionType(SourceLocated):
    stream_id: str
    ranges: list[RangePartitionProperty]


@dataclasses.dataclass
class Partition(SourceLocated):
    partition_types: list[Union[ValuePartitionType, RangePartitionType]] = dataclasses.field(
        default_factory=list
    )
    queries: list[Query] = dataclasses.field(default_factory=list)
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class InputStore(SourceLocated):
    store_id: str
    alias: Optional[str] = None
    on: Optional[Expression] = None
    within: Optional[tuple[Expression, Optional[Expression]]] = None
    per: Optional[Expression] = None


@dataclasses.dataclass
class StoreQuery(SourceLocated):
    """One-shot pull query (reference: execution/query/StoreQuery.java)."""

    input_store: Optional[InputStore] = None
    selector: Selector = dataclasses.field(default_factory=Selector)
    # for store insert/update/delete forms
    output_stream: Optional[OutputStream] = None
    select_expression_rows: Optional[list] = None


def assign_execution_ids(app) -> list:
    """THE query/partition id assignment for an app, shared by the runtime
    (app_runtime.py + partition.py), the semantic analyzer (analysis/
    analyzer.py), and the EXPLAIN plan builder (observability/explain.py)
    so the three can never drift: explicit @info names are reserved
    app-wide (including names on queries inside partitions), unnamed
    top-level queries take the next free `queryN`, partitions number
    `partitionM` in source order, and their unnamed inner queries take
    `{pid}_queryK` where K counts ALL inner queries (named ones included).

    Returns source-ordered entries:
      ("query", qid, query)
      ("partition", pid, partition, [(qid, query), ...])
    """
    from siddhi_tpu_torch.query_api.annotation import find_annotation

    def info_name(q):
        info = find_annotation(q.annotations, "info")
        return info.element("name") if info else None

    taken = set()
    for elem in app.execution_elements:
        inner = (
            [elem] if isinstance(elem, Query)
            else list(getattr(elem, "queries", []) or [])
        )
        for q in inner:
            name = info_name(q)
            if name:
                taken.add(name)
    out: list = []
    unnamed = 0
    n_partitions = 0
    for elem in app.execution_elements:
        if isinstance(elem, Query):
            qid = info_name(elem)
            if not qid:
                while f"query{unnamed}" in taken:
                    unnamed += 1
                qid = f"query{unnamed}"
                unnamed += 1
            out.append(("query", qid, elem))
        elif isinstance(elem, Partition):
            pid = f"partition{n_partitions}"
            n_partitions += 1
            inner_ids = []
            p_unnamed = 0
            for q in elem.queries:
                qid = info_name(q) or f"{pid}_query{p_unnamed}"
                p_unnamed += 1
                inner_ids.append((qid, q))
            out.append(("partition", pid, elem, inner_ids))
    return out
