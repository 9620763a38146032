"""Expression compiler: query-api Expression AST -> vectorized torch functions.

The analog of the reference's compiled scalar executor trees
(reference: core/executor/ExpressionExecutor.java and the per-type classes built by
core/util/parser/ExpressionParser.java:215-530) — except each compiled node maps a
whole columnar batch at once: `fn(env) -> Tensor` where `env` supplies `[B]`-shaped
attribute columns. Type promotion follows the reference's executor-selection
matrix (DOUBLE > FLOAT > LONG > INT); integer divide/mod use Java truncation
semantics, and divide/mod by zero give XLA's defined results (x / 0 = -1,
x % 0 = x) so the engine never faults on data.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.types import (
    NUMERIC_TYPES,
    PHYSICAL_DTYPE,
    AttrType,
    InternTable,
    convert_to,
    float_arith,
    float_extreme,
    flush_needed,
    flush_subnormal,
    mod_pow2_divisor,
    null_value,
    promote,
)
from siddhi_tpu_torch.query_api.expression import (
    Add,
    And,
    AttributeFunction,
    Compare,
    CompareOp,
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
    Variable,
)

# Canonical variable key: (stream_ref, stream_index, attribute). stream_ref is the
# scope-canonicalized alias; TS_ATTR keys the timestamp lane.
VarKey = tuple[str, Optional[int], str]
TS_ATTR = "__ts__"
VALID_ATTR = "__valid__"


class Env:
    """Runtime column provider for a compiled expression."""

    def __init__(
        self, columns: dict[VarKey, torch.Tensor], now: torch.Tensor | None = None
    ):
        self.columns = columns
        self._now = now

    def read(self, key: VarKey) -> torch.Tensor:
        try:
            return self.columns[key]
        except KeyError:
            raise KeyError(f"env missing column {key}; has {list(self.columns)}") from None

    def now(self) -> torch.Tensor:
        if self._now is None:
            raise ValueError("this site does not provide currentTimeMillis")
        return self._now


@dataclasses.dataclass
class CompiledExpr:
    type: AttrType
    fn: Callable[[Env], torch.Tensor]
    # a numeric constant's value (None: not a constant, or a null)
    const: int | float | None = None
    # its float32 values hold no subnormal (an arithmetic result)
    flushed: bool = False

    def __call__(self, env: Env) -> torch.Tensor:
        return self.fn(env)


class Scope:
    """Compile-time name resolution: Variable -> (VarKey, AttrType), plus the
    device every compiled constant lives on.

    Concrete scopes are built by the query layer for each expression site
    (filter over one stream, selector over stream + aggregator outputs...).
    """

    def __init__(self, interner: InternTable, device, default_ref: str | None = None):
        self.interner = interner
        self.device = torch.device(device)
        self.default_ref = default_ref
        # every VarKey any expression compiled against this scope (or a
        # child) resolved: fused ingest ships only the attributes some
        # query reads (QueryRuntime.used_attrs)
        self.used_keys: set[VarKey] = set()
        # pattern-node filters resolve unqualified attrs to the CURRENT event's
        # stream even when earlier state refs carry the same attribute
        # (reference: MatchingMetaInfoHolder default stream-event index)
        self.prefer_default = False
        # in-table conditions resolve unqualified attrs against the OUTER
        # (stream) scope before the table's own columns (reference:
        # CollectionExpressionParser matching-side resolution)
        self.prefer_parent = False
        self._streams: dict[str, dict[str, AttrType]] = {}
        self._tables: dict[str, object] = {}
        self._parent: Scope | None = None

    def add_table(self, table) -> "Scope":
        """Register an InMemoryTable for `in <table>` conditions."""
        self._tables[table.table_id] = table
        return self

    def resolve_table(self, name: str):
        scope: Scope | None = self
        while scope is not None:
            if name in scope._tables:
                return scope._tables[name]
            scope = scope._parent
        return None

    def add_stream(self, ref: str, attrs: dict[str, AttrType]) -> "Scope":
        self._streams[ref] = dict(attrs)
        if self.default_ref is None:
            self.default_ref = ref
        return self

    def child(self) -> "Scope":
        c = Scope(self.interner, self.device, self.default_ref)
        c._parent = self
        return c

    def record_key(self, key: VarKey) -> None:
        # record at every level, so the root holds the full set
        scope: Scope | None = self
        while scope is not None:
            scope.used_keys.add(key)
            scope = scope._parent

    def root_used_keys(self) -> set[VarKey]:
        scope: Scope = self
        while scope._parent is not None:
            scope = scope._parent
        return scope.used_keys

    def resolve(self, var: Variable) -> tuple[VarKey, AttrType]:
        key, t = self._resolve(var)
        self.record_key(key)
        return key, t

    def _resolve(self, var: Variable) -> tuple[VarKey, AttrType]:
        if var.stream_id is not None:
            scope: Scope | None = self
            while scope is not None:
                if var.stream_id in scope._streams:
                    attrs = scope._streams[var.stream_id]
                    if var.attribute not in attrs:
                        raise KeyError(
                            f"no attribute '{var.attribute}' in '{var.stream_id}'"
                        )
                    return (
                        (var.stream_id, var.stream_index, var.attribute),
                        attrs[var.attribute],
                    )
                scope = scope._parent
            raise KeyError(f"unknown stream reference '{var.stream_id}'")
        # unqualified: unique attribute across in-scope streams (reference
        # resolves unprefixed attrs the same way)
        if self.prefer_parent and self._parent is not None:
            try:
                return self._parent._resolve(var)
            except KeyError:
                pass
        if self.prefer_default and self.default_ref is not None:
            scope = self
            while scope is not None:
                attrs = scope._streams.get(self.default_ref)
                if attrs is not None and var.attribute in attrs:
                    return (
                        (self.default_ref, var.stream_index, var.attribute),
                        attrs[var.attribute],
                    )
                scope = scope._parent
        scope = self
        while scope is not None:
            hits = [
                (ref, attrs[var.attribute])
                for ref, attrs in scope._streams.items()
                if var.attribute in attrs
            ]
            if len(hits) > 1:
                raise KeyError(f"ambiguous attribute '{var.attribute}' in {sorted(r for r, _ in hits)}")
            if hits:
                ref, t = hits[0]
                return (ref, var.stream_index, var.attribute), t
            scope = scope._parent
        raise KeyError(f"unknown attribute '{var.attribute}'")

    def ts_key(self) -> VarKey:
        return (self.default_ref, None, TS_ATTR)


def _cast(x: torch.Tensor, t: AttrType) -> torch.Tensor:
    return convert_to(x, PHYSICAL_DTYPE[t])


def _const_expr(value, t: AttrType, scope: Scope) -> CompiledExpr:
    if t in (AttrType.STRING, AttrType.OBJECT):
        value_dev = scope.interner.intern(value)
    elif value is None:
        value_dev = null_value(t)
    else:
        value_dev = value
    dev = torch.tensor(value_dev, dtype=PHYSICAL_DTYPE[t], device=scope.device)
    const = value if t in NUMERIC_TYPES and value is not None else None
    return CompiledExpr(t, lambda env: dev, const)


def _int_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java truncating division with XLA's defined edge results: x / 0 = -1
    and MIN / -1 = MIN (C++ leaves both undefined, and the CPU faults)."""
    zero = b == 0
    overflow = (a == torch.iinfo(a.dtype).min) & (b == -1)
    q = torch.div(a, torch.where(zero | overflow, torch.ones_like(b), b), rounding_mode="trunc")
    q = torch.where(overflow, a, q)
    return torch.where(zero, torch.full_like(q, -1), q)


def _int_rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java remainder (sign of the dividend) with x % 0 = x and MIN % -1 = 0."""
    zero = b == 0
    overflow = (a == torch.iinfo(a.dtype).min) & (b == -1)
    r = torch.fmod(a, torch.where(zero | overflow, torch.ones_like(b), b))
    r = torch.where(overflow, torch.zeros_like(r), r)
    return torch.where(zero, a, r)


def _float_operand(e: CompiledExpr, t: AttrType):
    """(value fn, holds no subnormal) of an operand of float32 arithmetic or
    min/max in type t: a constant cast and flushed once, here; an int or
    long operand cast (no int is a subnormal); an arithmetic result as it
    is; any other read as it is, for the operation to flush."""
    if e.const is not None:
        v = flush_subnormal(_cast(e(None), t))
        return (lambda env: v), True
    return (lambda env: _cast(e(env), t)), e.flushed or e.type in (AttrType.INT, AttrType.LONG)


def _arith(op_name: str, le: CompiledExpr, re_: CompiledExpr) -> CompiledExpr:
    t = promote(le.type, re_.type)
    if t in (AttrType.INT, AttrType.LONG):

        def fn(env: Env) -> torch.Tensor:
            a, b = _cast(le(env), t), _cast(re_(env), t)
            if op_name == "add":
                return a + b
            if op_name == "sub":
                return a - b
            if op_name == "mul":
                return a * b
            if op_name == "div":
                return _int_div(a, b)
            if op_name == "mod":
                return _int_rem(a, b)
            raise AssertionError(op_name)

        return CompiledExpr(t, fn)

    if le.const is not None and re_.const is not None and op_name != "mod":
        # two constants: the JAX package folds them in numpy when it traces
        # (subnormals kept)
        ops = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div}
        v = ops[op_name](_cast(le(None), t), _cast(re_(None), t))
        return CompiledExpr(t, lambda env: v, const=float(v))
    # float32 as XLA's CPU code computes it (core/types.py float_arith)
    if op_name == "mod" and mod_pow2_divisor(re_.const):
        op_name = "mod_pow2"
    (lv, lflushed), (rv, rflushed) = _float_operand(le, t), _float_operand(re_, t)
    return CompiledExpr(
        t, lambda env: float_arith(op_name, lv(env), rv(env), not lflushed, not rflushed),
        flushed=op_name != "mod")


_CMP = {
    CompareOp.LT: torch.lt,
    CompareOp.LE: torch.le,
    CompareOp.GT: torch.gt,
    CompareOp.GE: torch.ge,
    CompareOp.EQ: torch.eq,
    CompareOp.NEQ: torch.ne,
}


def _notnull(v: torch.Tensor, t: AttrType) -> torch.Tensor:
    """Mask of rows whose value is NOT the type's null encoding."""
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        return ~torch.isnan(v)
    if t in (AttrType.INT, AttrType.LONG):
        return v != int(null_value(t))
    if t in (AttrType.STRING, AttrType.OBJECT):
        return v != 0
    return torch.ones_like(v, dtype=torch.bool)  # BOOL: never null


def _compare(op: CompareOp, le: CompiledExpr, re_: CompiledExpr) -> CompiledExpr:
    lt, rt = le.type, re_.type
    if lt in NUMERIC_TYPES and rt in NUMERIC_TYPES:
        t = promote(lt, rt)

        def side(e: CompiledExpr, other: CompiledExpr):
            # float operands compare as XLA compares them: subnormals as
            # zero. A constant is cast and flushed once, here; another
            # operand is flushed only where the other side needs it.
            if e.const is not None:
                v = flush_subnormal(_cast(e(None), t))
                return lambda x: v
            if flush_needed(other.const):
                return lambda x: flush_subnormal(_cast(x, t))
            return lambda x: _cast(x, t)

        lside, rside = side(le, re_), side(re_, le)

        def fn(env: Env) -> torch.Tensor:
            lv, rv = le(env), re_(env)
            # a null operand makes ANY comparison false, NEQ included
            # (reference: CompareConditionExpressionExecutor.java:42)
            ok = _notnull(lv, lt) & _notnull(rv, rt)
            return _CMP[op](lside(lv), rside(rv)) & ok

    elif lt == rt and lt in (AttrType.BOOL, AttrType.STRING, AttrType.OBJECT):
        if op not in (CompareOp.EQ, CompareOp.NEQ):
            raise TypeError(f"operator {op.value} not defined for {lt!r}")

        def fn(env: Env) -> torch.Tensor:
            lv, rv = le(env), re_(env)
            ok = _notnull(lv, lt) & _notnull(rv, rt)
            return _CMP[op](lv, rv) & ok

    else:
        raise TypeError(f"cannot compare {lt!r} {op.value} {rt!r}")
    return CompiledExpr(AttrType.BOOL, fn)


def _require_bool(c: CompiledExpr, what: str) -> None:
    if c.type is not AttrType.BOOL:
        raise TypeError(f"{what} requires BOOL, got {c.type!r}")


def compile_expression(expr: Expression, scope: Scope) -> CompiledExpr:
    """Recursively compile an expression tree against a name-resolution scope."""
    if isinstance(expr, Constant):
        return _const_expr(expr.value, expr.type, scope)

    if isinstance(expr, Variable):
        key, t = scope.resolve(expr)
        return CompiledExpr(t, lambda env, k=key: env.read(k))

    arith = {Add: "add", Subtract: "sub", Multiply: "mul", Divide: "div", Mod: "mod"}
    if type(expr) in arith:
        return _arith(
            arith[type(expr)],
            compile_expression(expr.left, scope),
            compile_expression(expr.right, scope),
        )

    if isinstance(expr, Compare):
        return _compare(expr.op, compile_expression(expr.left, scope), compile_expression(expr.right, scope))

    if isinstance(expr, And):
        le, re_ = compile_expression(expr.left, scope), compile_expression(expr.right, scope)
        _require_bool(le, "and"), _require_bool(re_, "and")
        return CompiledExpr(AttrType.BOOL, lambda env: le(env) & re_(env))
    if isinstance(expr, Or):
        le, re_ = compile_expression(expr.left, scope), compile_expression(expr.right, scope)
        _require_bool(le, "or"), _require_bool(re_, "or")
        return CompiledExpr(AttrType.BOOL, lambda env: le(env) | re_(env))
    if isinstance(expr, Not):
        ce = compile_expression(expr.expression, scope)
        _require_bool(ce, "not")
        return CompiledExpr(AttrType.BOOL, lambda env: ~ce(env))

    if isinstance(expr, IsNull):
        if expr.expression is not None:
            ce = compile_expression(expr.expression, scope)
            return CompiledExpr(AttrType.BOOL, _is_null_fn(ce))
        # stream-null form (`e1 is null` in patterns): the pattern engine
        # provides a per-state arrival flag column
        key = (expr.stream_id, expr.stream_index, "__arrived__")
        scope.record_key(key)
        return CompiledExpr(AttrType.BOOL, lambda env, k=key: ~env.read(k))

    if isinstance(expr, In):
        table = scope.resolve_table(expr.source_id)
        if table is None:
            raise KeyError(f"'in {expr.source_id}': no such table in scope")
        inner_scope = scope.child()
        inner_scope.add_stream(expr.source_id, table.schema.attr_types)
        inner_scope.prefer_parent = True
        cond = compile_expression(expr.expression, inner_scope)
        _require_bool(cond, "in-table condition")
        from siddhi_tpu_torch.core.table import compile_in_condition

        return CompiledExpr(AttrType.BOOL, compile_in_condition(table, expr.expression,
                                                                inner_scope))

    if isinstance(expr, AttributeFunction):
        return _compile_function(expr, scope)

    raise TypeError(f"cannot compile expression node {type(expr).__name__}")


def _is_null_fn(ce: CompiledExpr):
    t = ce.type

    def fn(env: Env) -> torch.Tensor:
        v = ce(env)
        if t in (AttrType.FLOAT, AttrType.DOUBLE):
            return torch.isnan(v)
        if t in (AttrType.STRING, AttrType.OBJECT):
            return v == 0
        if t in (AttrType.INT, AttrType.LONG):
            return v == int(null_value(t))
        return torch.zeros_like(v, dtype=torch.bool)  # BOOL: never null

    return fn


# ---------------------------------------------------------------------------
# built-in scalar functions
# (reference: core/executor/function/*FunctionExecutor.java — ~20 built-ins)
# ---------------------------------------------------------------------------

_TYPE_NAMES = {
    "string": AttrType.STRING,
    "int": AttrType.INT,
    "long": AttrType.LONG,
    "float": AttrType.FLOAT,
    "double": AttrType.DOUBLE,
    "bool": AttrType.BOOL,
    "object": AttrType.OBJECT,
}

# Aggregator names are handled by the selector layer, never here.
AGGREGATOR_NAMES = {
    "sum", "avg", "count", "min", "max", "stdDev", "stddev",
    "distinctCount", "distinctcount", "minForever", "minforever",
    "maxForever", "maxforever",
}


def is_aggregator(expr: Expression) -> bool:
    return (
        isinstance(expr, AttributeFunction)
        and expr.namespace is None
        and expr.name in AGGREGATOR_NAMES
    )


def _valid_like(env: Env, scope: Scope, v: torch.Tensor) -> torch.Tensor:
    try:
        return env.read((scope.default_ref, None, VALID_ATTR)).expand_as(v)
    except KeyError:
        return torch.ones_like(v, dtype=torch.bool)


def _to_string_fn(src: CompiledExpr, scope: Scope):
    """numeric -> string: host code formats and interns the distinct valid
    values of the batch (reference: ConvertFunctionExecutor string
    conversion); null inputs and padding rows map to the null id."""
    interner = scope.interner
    is_int = src.type in (AttrType.INT, AttrType.LONG)
    src_null = _is_null_fn(src)

    def fn(env: Env) -> torch.Tensor:
        v = src(env)
        mask = (_valid_like(env, scope, v) & ~src_null(env)).cpu().numpy()
        flat = v.cpu().numpy().reshape(-1)
        m = mask.reshape(-1)
        out = np.zeros(flat.shape, dtype=np.int32)
        uniq = np.unique(flat[m])
        if is_int:
            strings = [str(int(u)) for u in uniq.tolist()]
        else:
            # shortest round-trip form of the float32 value
            strings = [np.format_float_positional(u, unique=True, trim="0") for u in uniq]
        ids = np.array([interner.intern(s) for s in strings], dtype=np.int32)
        if uniq.size:
            out[m] = ids[np.searchsorted(uniq, flat[m])]
        return torch.from_numpy(out.reshape(v.shape)).to(v.device)

    return fn


def _uuid_fn(scope: Scope):
    """UUID(): host code mints and interns one UUID per valid row
    (reference: executor/function/UUIDFunctionExecutor)."""
    import uuid

    interner = scope.interner

    def fn(env: Env) -> torch.Tensor:
        ts = env.read(scope.ts_key())
        valid = _valid_like(env, scope, ts).cpu().numpy()
        out = np.zeros(valid.shape, dtype=np.int32)  # padding: null id
        for i in np.nonzero(valid)[0]:
            out[i] = interner.intern(str(uuid.uuid4()))
        return torch.from_numpy(out).to(ts.device)

    return fn


def _compile_function(expr: AttributeFunction, scope: Scope) -> CompiledExpr:
    if is_aggregator(expr):
        raise TypeError(
            f"aggregator '{expr.name}' is only valid in a select clause"
        )
    name = (f"{expr.namespace}:{expr.name}" if expr.namespace else expr.name)
    params = expr.parameters

    if name in ("cast", "convert"):
        if len(params) != 2 or not isinstance(params[1], Constant):
            raise TypeError(f"{name}(value, 'type') requires a constant type name")
        target = _TYPE_NAMES.get(str(params[1].value).lower())
        if target is None:
            raise TypeError(f"unknown cast target {params[1].value!r}")
        src = compile_expression(params[0], scope)
        if target in (AttrType.STRING, AttrType.OBJECT) or src.type in (
            AttrType.STRING,
            AttrType.OBJECT,
        ):
            if src.type == target:
                return src
            if target is AttrType.STRING and src.type in NUMERIC_TYPES:
                return CompiledExpr(AttrType.STRING, _to_string_fn(src, scope))
            raise NotImplementedError(
                f"{name} between {src.type!r} and {target!r} requires host egress"
            )
        if target is AttrType.BOOL or src.type is AttrType.BOOL:
            if src.type == target:
                return src
            raise TypeError(f"cannot {name} {src.type!r} to {target!r}")
        return CompiledExpr(target, lambda env: _cast(src(env), target))

    if name == "coalesce":
        compiled = [compile_expression(p, scope) for p in params]
        t = compiled[0].type
        if any(c.type != t for c in compiled):
            raise TypeError("coalesce requires homogeneous parameter types")

        def fn(env: Env) -> torch.Tensor:
            out = compiled[-1](env)
            for c in reversed(compiled[:-1]):
                out = torch.where(_is_null_fn(c)(env), out, c(env))
            return out

        return CompiledExpr(t, fn)

    if name == "ifThenElse":
        cond, a, b = (compile_expression(p, scope) for p in params)
        _require_bool(cond, "ifThenElse condition")
        if a.type in NUMERIC_TYPES and b.type in NUMERIC_TYPES:
            t = promote(a.type, b.type)
        elif a.type == b.type:
            t = a.type
        else:
            raise TypeError(f"ifThenElse branches {a.type!r} vs {b.type!r}")
        return CompiledExpr(
            t, lambda env: torch.where(cond(env), _cast(a(env), t), _cast(b(env), t))
        )

    if name.startswith("instanceOf"):
        target = _TYPE_NAMES.get(name[len("instanceOf"):].lower())
        if target is None:
            raise TypeError(f"unknown function '{name}'")
        src = compile_expression(params[0], scope)
        matches = src.type == target
        isnull = _is_null_fn(src)
        return CompiledExpr(AttrType.BOOL, lambda env: ~isnull(env) & matches)

    if name in ("maximum", "minimum"):
        compiled = [compile_expression(p, scope) for p in params]
        t = compiled[0].type
        for c in compiled[1:]:
            t = promote(t, c.type)
        is_min = name == "minimum"
        if t not in (AttrType.FLOAT, AttrType.DOUBLE) or len(compiled) == 1:
            red = torch.minimum if is_min else torch.maximum

            def fn(env: Env) -> torch.Tensor:
                out = _cast(compiled[0](env), t)
                for c in compiled[1:]:
                    out = red(out, _cast(c(env), t))
                return out

            return CompiledExpr(t, fn)

        # float32 as XLA's CPU code computes it (core/types.py float_extreme)
        ops = [_float_operand(c, t) for c in compiled]

        def ffn(env: Env) -> torch.Tensor:
            out, flushed = ops[0][0](env), ops[0][1]
            for v, f in ops[1:]:
                out = float_extreme(out, v(env), is_min, not flushed, not f)
                flushed = True
            return out

        return CompiledExpr(t, ffn, flushed=True)

    if name == "eventTimestamp":
        key = scope.ts_key()
        return CompiledExpr(AttrType.LONG, lambda env: env.read(key))

    if name == "currentTimeMillis":
        return CompiledExpr(AttrType.LONG, lambda env: env.now())

    if name == "UUID":
        return CompiledExpr(AttrType.STRING, _uuid_fn(scope))

    if name == "default":
        src = compile_expression(params[0], scope)
        dflt = compile_expression(params[1], scope)
        if src.type != dflt.type and not (
            src.type in NUMERIC_TYPES and dflt.type in NUMERIC_TYPES
        ):
            raise TypeError(f"default({src.type!r}, {dflt.type!r}) type mismatch")
        t = src.type
        isnull = _is_null_fn(src)
        return CompiledExpr(
            t, lambda env: torch.where(isnull(env), _cast(dflt(env), t), src(env))
        )

    from siddhi_tpu_torch.core.extension import lookup_function

    ext = lookup_function(name)
    if ext is not None:
        return ext([compile_expression(p, scope) for p in params], scope)

    raise NotImplementedError(f"unknown function '{name}'")
