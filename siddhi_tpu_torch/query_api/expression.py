"""Expression AST.

Reference: siddhi-query-api .../expression/Expression.java tree — math, conditions,
constants, variables, attribute functions. Built either programmatically or by the
SiddhiQL parser; compiled to vectorized jax functions by
siddhi_tpu_torch.core.executor (the analog of core/util/parser/ExpressionParser.java).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

from siddhi_tpu_torch.core.types import AttrType


class Expression:
    """AST base class. Builder helpers (`value`, `var`) are module functions,
    mirroring the reference's `Expression.value()/variable()` statics.

    `line`/`col` carry the 1-based source position of the node's first token
    when the node came out of the SiddhiQL parser (None for programmatically
    built ASTs) — semantic diagnostics (`siddhi_tpu_torch.analysis`) report them."""

    line: Optional[int] = None
    col: Optional[int] = None


def value(v: Any, type_: Optional[AttrType] = None) -> "Constant":
    if type_ is None:
        if isinstance(v, bool):
            type_ = AttrType.BOOL
        elif isinstance(v, int):
            type_ = AttrType.INT if -(2**31) <= v < 2**31 else AttrType.LONG
        elif isinstance(v, float):
            type_ = AttrType.DOUBLE
        elif isinstance(v, str):
            type_ = AttrType.STRING
        else:
            raise TypeError(f"cannot infer constant type of {v!r}")
    return Constant(v, type_)


def var(name: str, stream_id: Optional[str] = None) -> "Variable":
    return Variable(name, stream_id=stream_id)


@dataclasses.dataclass
class Constant(Expression):
    value: Any
    type: AttrType


@dataclasses.dataclass
class TimeConstant(Constant):
    """A time literal like `1 min` — LONG milliseconds (reference: expression/constant/TimeConstant.java)."""

    def __init__(self, millis: int):
        super().__init__(millis, AttrType.LONG)


@dataclasses.dataclass
class Variable(Expression):
    """Attribute reference, optionally qualified by stream alias / pattern index.

    `stream_index` mirrors the reference's e1[0]/e1[last] indexing into
    count-state collected events (reference: expression/Variable.java).
    """

    attribute: str
    stream_id: Optional[str] = None
    stream_index: Optional[int] = None  # LAST == -1
    is_inner: bool = False
    is_fault: bool = False

    LAST = -1


@dataclasses.dataclass
class _Binary(Expression):
    left: Expression
    right: Expression


class Add(_Binary):
    pass


class Subtract(_Binary):
    pass


class Multiply(_Binary):
    pass


class Divide(_Binary):
    pass


class Mod(_Binary):
    pass


class CompareOp(enum.Enum):
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="
    EQ = "=="
    NEQ = "!="


@dataclasses.dataclass
class Compare(Expression):
    left: Expression
    op: CompareOp
    right: Expression


@dataclasses.dataclass
class And(Expression):
    left: Expression
    right: Expression


@dataclasses.dataclass
class Or(Expression):
    left: Expression
    right: Expression


@dataclasses.dataclass
class Not(Expression):
    expression: Expression


@dataclasses.dataclass
class IsNull(Expression):
    expression: Optional[Expression] = None
    # stream-null form: `S1 is null` inside patterns
    stream_id: Optional[str] = None
    stream_index: Optional[int] = None


@dataclasses.dataclass
class In(Expression):
    """`<condition> in TableName` (reference: expression/condition/In.java)."""

    expression: Expression
    source_id: str


@dataclasses.dataclass
class AttributeFunction(Expression):
    """`ns:name(arg, ...)` — built-in or extension function / aggregator."""

    namespace: Optional[str]
    name: str
    parameters: list[Expression]
