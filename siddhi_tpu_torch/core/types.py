"""Attribute types, physical dtype mapping, and host-side string interning.

The reference engine types attributes as STRING/INT/LONG/FLOAT/DOUBLE/BOOL/OBJECT
(reference: siddhi-query-api .../definition/Attribute.java). The engine keeps the
*logical* type for promotion semantics and maps each to a 32-bit-or-narrower
physical torch dtype, except timestamps and LONG (int64): DOUBLE runs as float32
(no tensor in the engine is float64), STRING/OBJECT are dictionary-encoded to
int32 ids via a host-side intern table (equality works on ids; decoding happens
at the egress boundary).
"""

from __future__ import annotations

import enum
import math
import threading
from typing import Any

import numpy as np
import torch


class AttrType(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    BOOL = "bool"
    OBJECT = "object"

    def __repr__(self) -> str:  # compact in error messages
        return self.name


# Logical -> physical torch dtype on device.
PHYSICAL_DTYPE = {
    AttrType.STRING: torch.int32,   # interned id
    AttrType.INT: torch.int32,
    AttrType.LONG: torch.int64,
    AttrType.FLOAT: torch.float32,
    AttrType.DOUBLE: torch.float32,  # no float64; logical DOUBLE tracked separately
    AttrType.BOOL: torch.bool,
    AttrType.OBJECT: torch.int32,   # interned id
}

# The same mapping as numpy dtypes, for host staging buffers.
NUMPY_DTYPE = {
    t: torch.empty(0, dtype=d).numpy().dtype for t, d in PHYSICAL_DTYPE.items()
}

NUMERIC_TYPES = (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)

# Promotion order for arithmetic, mirroring the reference's per-type executor
# selection (reference: core/util/parser/ExpressionParser.java:560+ — DOUBLE wins,
# then FLOAT, then LONG, then INT).
_PROMOTION_ORDER = [AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE]

# Null sentinels: columnar tensors cannot hold Java nulls, so each physical class
# reserves a sentinel. STRING/OBJECT id 0 is always null ("" interns to 1+).
NULL_ID = 0
NULL_INT = np.int32(np.iinfo(np.int32).min)
NULL_LONG = np.int64(np.iinfo(np.int64).min)
# float/double nulls are NaN.


FLT_MIN = float(np.finfo(np.float32).tiny)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor as XLA reads it: each subnormal a zero of its own
    sign (the JAX package's comparisons, sorts, searches and arithmetic
    flush them), NaN and every other value as it is. Another dtype passes
    through."""
    if x.dtype != torch.float32:
        return x
    return torch.where(x.abs() < FLT_MIN, x * 0, x)


# |x| below this rounds, in 24 bits with an unbounded exponent, below FLT_MIN
_FTZ_BELOW = FLT_MIN * (1.0 - 2.0**-25)


def _ftz(r: torch.Tensor, tiny: torch.Tensor) -> torch.Tensor:
    return torch.where(tiny, r * 0, r)


def float32_ftz(p: torch.Tensor) -> torch.Tensor:
    """A float64 result rounded to float32 as XLA's CPU code rounds it: a
    zero of its sign where it rounds, in 24 bits with an unbounded
    exponent, below FLT_MIN (FTZ, tininess after rounding)."""
    return _ftz(p.float(), p.abs() < _FTZ_BELOW)


def float_arith(op: str, a: torch.Tensor, b: torch.Tensor, flush_a: bool = True,
                flush_b: bool = True) -> torch.Tensor:
    """`a op b` (op: add, sub, mul, div, mod) on float32 as XLA's CPU code
    computes it for the JAX package. + - * / read each subnormal operand as
    a zero of its sign (DAZ) and give a zero of its sign where the result,
    rounded to 24 bits with an unbounded exponent, lies below FLT_MIN (FTZ,
    tininess after rounding: a product rounded up to FLT_MIN only by the
    subnormal grid flushes too). % ("mod") is fmodf, a library call: it
    reads a subnormal divisor as zero and keeps everything else; XLA
    rewrites a % by a constant power of two of at least 1 in magnitude
    ("mod_pow2", `mod_pow2_divisor`) into arithmetic, whose dividend reads a
    subnormal as zero too. flush_a / flush_b False: that operand is known to
    hold no subnormal."""
    if flush_b:
        b = flush_subnormal(b)
    if op == "mod":
        return torch.fmod(a, b)
    if flush_a:
        a = flush_subnormal(a)
    if op == "mod_pow2":
        return torch.fmod(a, b)
    if op in ("add", "sub"):
        # the exact sum of two float32s past the flush is a float32 when
        # below FLT_MIN: no rounding to tell apart
        r = a + b if op == "add" else a - b
        return _ftz(r, r.abs() < FLT_MIN)
    # a float64 product is exact and a float64 quotient close enough to
    # tell tininess after rounding (csrc/common.cuh xla_mul / xla_div)
    if op == "mul":
        r, p = a * b, a.double() * b.double()
    else:
        r, p = a / b, a.double() / b.double()
    return _ftz(r, p.abs() < _FTZ_BELOW)


def mod_pow2_divisor(c) -> bool:
    """Whether a float % by the constant c is XLA's "mod_pow2"
    (`float_arith`): c a power of two of at least 1 in magnitude."""
    if c is None:
        return False
    m, _e = math.frexp(abs(float(np.float32(c))))
    return abs(float(c)) >= 1 and m == 0.5


def float_extreme(a: torch.Tensor, b: torch.Tensor, is_min: bool, flush_a: bool = True,
                  flush_b: bool = True) -> torch.Tensor:
    """`jnp.minimum` / `jnp.maximum` on float32 as XLA's CPU code computes
    them: subnormal operands read as zeros of their sign, NaN wins, and of
    a zero of each sign the minimum is -0.0, the maximum 0.0."""
    if flush_a:
        a = flush_subnormal(a)
    if flush_b:
        b = flush_subnormal(b)
    r = torch.minimum(a, b) if is_min else torch.maximum(a, b)
    return torch.where(a == b, torch.where(a.signbit() == is_min, a, b), r)


def flushed_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of a [n] lane, for float32 as XLA's CPU code
    takes it: x holds no subnormal, and a partial sum that comes out
    subnormal is a zero of its sign that the sum goes on from (FTZ; it can
    only come of a cancellation). Another dtype: the plain running sum."""
    c = torch.cumsum(x, 0, dtype=x.dtype)
    if x.dtype != torch.float32:
        return c
    tiny = (c != 0) & (c.abs() < FLT_MIN)
    if not bool(tiny.any()):
        return c
    # from the first flushed partial on, one add at a time
    i = int(tiny.nonzero()[0])
    xs = x.cpu().numpy()
    cs = c.cpu().numpy().copy()
    s = cs[i] * np.float32(0)
    cs[i] = s
    for j in range(i + 1, cs.shape[0]):
        s = np.float32(s + xs[j])
        if s != 0 and abs(s) < FLT_MIN:
            s = s * np.float32(0)
        cs[j] = s
    return torch.from_numpy(cs).to(x.device)


def convert_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as `dtype`, converted as XLA converts (the JAX package's
    `astype`): a float to an integer type maps NaN to 0, saturates at the
    type's range (so a value at or below its minimum is that type's null)
    and truncates toward zero within it. Every other conversion is
    Tensor.to's."""
    if not x.is_floating_point() or dtype.is_floating_point or dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    # -min is 2^31 / 2^63, exact in every float type (float32 rounds max up to it)
    hi, lo = -float(info.min), float(info.min)
    big, small = x >= hi, x <= lo
    safe = torch.where(big | small | torch.isnan(x), torch.zeros_like(x), x)
    out = safe.to(dtype)
    out = torch.where(big, torch.full_like(out, info.max), out)
    return torch.where(small, torch.full_like(out, info.min), out)


def flush_needed(const) -> bool:
    """Whether a comparison must flush an operand whose other side is the
    constant `const` (a number; None: not a constant). Only against a zero
    or a subnormal: every other value, NaN too, sits on the same side of a
    subnormal as of the zero it flushes to."""
    return const is None or abs(const) < FLT_MIN


def promote(a: AttrType, b: AttrType) -> AttrType:
    """Binary arithmetic result type, per the reference's executor matrix."""
    if a not in NUMERIC_TYPES or b not in NUMERIC_TYPES:
        raise TypeError(f"cannot apply arithmetic to {a!r} and {b!r}")
    return _PROMOTION_ORDER[max(_PROMOTION_ORDER.index(a), _PROMOTION_ORDER.index(b))]


def null_value(t: AttrType):
    """The device-side sentinel representing null for a logical type."""
    if t in (AttrType.STRING, AttrType.OBJECT):
        return NULL_ID
    if t is AttrType.INT:
        return NULL_INT
    if t is AttrType.LONG:
        return NULL_LONG
    if t in (AttrType.FLOAT, AttrType.DOUBLE):
        return np.float32(np.nan)
    if t is AttrType.BOOL:
        return False  # BOOL has no null on device
    raise TypeError(t)


class InternTable:
    """Bidirectional string/object <-> int32 id table (host side, thread-safe).

    Replaces the reference's boxed Object payloads for STRING/OBJECT attributes.
    id 0 is reserved for null. Objects that are not strings are interned by
    identity-equality via their Python hash/eq.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._to_id: dict[Any, int] = {}
        self._from_id: list[Any] = [None]  # id 0 -> null
        self._snapshot = None  # cached object-array view for lookup_many

    def intern(self, value: Any) -> int:
        if value is None:
            return NULL_ID
        with self._lock:
            ident = self._to_id.get(value)
            if ident is None:
                ident = len(self._from_id)
                self._to_id[value] = ident
                self._from_id.append(value)
                self._snapshot = None  # invalidate lookup_many cache
            return ident

    def lookup(self, ident: int) -> Any:
        return self._from_id[int(ident)]

    def lookup_many(self, ids) -> list:
        """Vectorized id -> value for an integer array (one fancy index
        instead of len(ids) Python calls). The object-array snapshot is
        cached and invalidated by intern()."""
        with self._lock:
            table = self._snapshot
            if table is None:
                table = self._snapshot = np.asarray(self._from_id, dtype=object)
        return table[np.asarray(ids, dtype=np.int64)].tolist()

    def __len__(self) -> int:
        return len(self._from_id)
