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
    """A float32 tensor as XLA compares it: each subnormal a zero of its own
    sign (the JAX package's comparisons, sorts and searches flush them), NaN
    and every other value as it is. Another dtype passes through."""
    if x.dtype != torch.float32:
        return x
    return torch.where(x.abs() < FLT_MIN, x * 0, x)


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
