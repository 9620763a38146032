"""Typed query object model — the IR between the SiddhiQL front-end and the compiler.

Mirrors the reference's siddhi-query-api POJO/builder AST (reference:
modules/siddhi-query-api, SURVEY.md §2.2) and doubles as the public programmatic
API for building apps without SiddhiQL text.
"""

from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.definition import (
    AggregationDefinition,
    Attribute,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TimePeriod,
    TriggerDefinition,
    WindowDefinition,
)
from siddhi_tpu_torch.query_api.execution import (
    AbsentStreamStateElement,
    CountStateElement,
    DeleteStream,
    EventOutputRate,
    EveryStateElement,
    Filter,
    InsertIntoStream,
    JoinInputStream,
    LogicalStateElement,
    NextStateElement,
    OutputAttribute,
    OrderByAttribute,
    Partition,
    Query,
    RangePartitionType,
    ReturnStream,
    Selector,
    SingleInputStream,
    SnapshotOutputRate,
    StateInputStream,
    StoreQuery,
    StreamFunctionHandler,
    StreamStateElement,
    TimeOutputRate,
    UpdateOrInsertStream,
    UpdateSetAttribute,
    UpdateStream,
    ValuePartitionType,
    WindowHandler,
)
from siddhi_tpu_torch.query_api.expression import (
    Add,
    And,
    AttributeFunction,
    Compare,
    Constant,
    Divide,
    Expression,
    In,
    IsNull,
    Mod,
    Multiply,
    Not,
    Or,
    Subtract,
    TimeConstant,
    Variable,
)
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp

__all__ = [n for n in dir() if not n.startswith("_")]
