"""Compact wire encodings for fused ingest: per-column codecs for the H2D link.

Fused ingest (core/ingest.py) ships K micro-batches per chunk in one narrow
wire buffer. The host encodes each micro-batch into the compact form with
numpy, the buffer crosses the bus once, and the card decodes it back into the
columnar lanes (the K4 kernel, csrc/wire_decode.cu) before the query steps
run. Bytes stay compressed across the link and the host never materializes
wide columns.

Encoders (per lane of the fused wire):

* ``narrow``  — integer downcast (int64 -> int32/int16/int8). Chosen from a
  declared `@app:wire(range.S.col='lo..hi')` contract, or sampled from the
  first engaged send (`StreamSchema.propose_narrow`).
* ``dict``    — per-batch dictionary encoding for low-cardinality string /
  interned columns (`@app:wire(dict.S.col='N')`): each micro-batch ships
  uint8/uint16 codes plus an N-slot dictionary of the original values;
  decode is a gather.
* ``delta``   — per-batch int64 base + consecutive diffs for declared-monotone
  int/long columns (`@app:wire(delta.S.col='int16')`), rebuilt with an int64
  inclusive scan — the trick the timestamp lane (`__tsd__`) always plays.
* ``bitpack`` — BOOL columns ride 1 bit/value (big-endian bit order), on
  whenever wire encoding is enabled.

Every encoder is guarded per batch: a batch that violates the assumption
(value out of range, dictionary overflow, delta outside the narrow dtype)
raises `WireNarrowMisfit` and the sender rebuilds the chunk program
FULL-WIDTH (once, permanent), so emissions are identical encode-on vs off.

Toggle: `@app:wire(disable='true')` on the app, overridden process-wide by
SIDDHI_TPU_WIRE=1 (force on) / SIDDHI_TPU_WIRE=0 (force off: full-width
lanes, no narrowing, no sampling).

The encode side writes buffers byte-identical to the JAX package's
`siddhi_tpu/core/wire.py`; the port never infers hints from value analysis
(only declared `@app:wire` hints overlay the sampled narrow dtypes).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.types import NUMPY_DTYPE, PHYSICAL_DTYPE, AttrType, null_value

WIRE_ENV = "SIDDHI_TPU_WIRE"

WIRE_SPEC_VERSION = 1

_TRUE = ("1", "on", "true", "force")
_FALSE = ("0", "off", "false")

# hint kinds accepted as `@app:wire(<kind>.<Stream>.<col>='...')`
_HINT_KINDS = ("range", "dict", "delta")

_DELTA_DTYPES = {
    "true": np.dtype(np.int16),  # delta.S.col='true' -> default int16 diffs
    "int8": np.dtype(np.int8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
}

_INTEGRAL = (AttrType.INT, AttrType.LONG)
_INTERNED = (AttrType.STRING, AttrType.OBJECT)


def wire_env_override() -> Optional[bool]:
    """Process-wide wire-encoding toggle: True (forced on), False (forced
    off), or None (defer to the app's @app:wire annotation)."""
    v = os.environ.get(WIRE_ENV, "").strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return None


def _parse_range(v) -> Optional[tuple[int, int]]:
    try:
        lo_s, hi_s = str(v).split("..", 1)
        lo, hi = int(lo_s), int(hi_s)
    except (TypeError, ValueError):
        return None
    return (lo, hi) if lo <= hi else None


def iter_wire_annotation_problems(ann):
    """Yield one message per malformed `@app:wire` element."""
    for k, v in ann.elements:
        if k == "disable":
            if str(v).strip().lower() not in ("true", "false"):
                yield f"@app:wire disable '{v}' must be true or false"
            continue
        parts = str(k).split(".") if k is not None else []
        if len(parts) != 3 or parts[0] not in _HINT_KINDS:
            yield (
                f"unknown @app:wire option '{k if k is not None else v}' (expected "
                "disable, range.<stream>.<col>, dict.<stream>.<col>, "
                "delta.<stream>.<col>)"
            )
            continue
        kind = parts[0]
        if kind == "range":
            if _parse_range(v) is None:
                yield f"@app:wire {k} '{v}' must be 'lo..hi' with integer lo <= hi"
        elif kind == "dict":
            try:
                ok = 2 <= int(v) <= 65536
            except (TypeError, ValueError):
                ok = False
            if not ok:
                yield (
                    f"@app:wire {k} '{v}' must be an integer dictionary "
                    "capacity in 2..65536"
                )
        elif str(v).strip().lower() not in _DELTA_DTYPES:
            yield f"@app:wire {k} '{v}' must be true, int8, int16, or int32"


def parse_wire_hints(ann) -> dict:
    """(stream_id, col) -> hint tuple from a (validated) `@app:wire`
    annotation: ("range", lo, hi) | ("dict", card) | ("delta", np.dtype).
    Malformed elements are skipped (the validator reports them)."""
    hints: dict = {}
    if ann is None:
        return hints
    for k, v in ann.elements:
        if k is None or k == "disable":
            continue
        parts = str(k).split(".")
        if len(parts) != 3 or parts[0] not in _HINT_KINDS:
            continue
        kind, sid, col = parts
        if kind == "range":
            r = _parse_range(v)
            if r is not None:
                hints[(sid, col)] = ("range",) + r
        elif kind == "dict":
            try:
                card = int(v)
            except (TypeError, ValueError):
                continue
            if 2 <= card <= 65536:
                hints[(sid, col)] = ("dict", card)
        elif kind == "delta":
            dt = _DELTA_DTYPES.get(str(v).strip().lower())
            if dt is not None:
                hints[(sid, col)] = ("delta", dt)
    return hints


def resolve_wire_annotation(ann) -> tuple[bool, dict]:
    """(enabled, hints) for one app from its `@app:wire` annotation (or
    None) plus the SIDDHI_TPU_WIRE env override. Raises
    SiddhiAppCreationError on malformed options."""
    from siddhi_tpu_torch.core.errors import SiddhiAppCreationError

    enabled = True
    hints: dict = {}
    if ann is not None:
        for problem in iter_wire_annotation_problems(ann):
            raise SiddhiAppCreationError(problem)
        enabled = str(ann.element("disable", "false")).strip().lower() != "true"
        hints = parse_wire_hints(ann)
    env = wire_env_override()
    if env is not None:
        enabled = env
    return enabled, hints


# ---------------------------------------------------------------------------
# WireSpec: the static per-stream encoding choice
# ---------------------------------------------------------------------------


def _narrow_for_range(lo: int, hi: int, wide: np.dtype) -> Optional[np.dtype]:
    """Smallest integer dtype covering the DECLARED [lo, hi] contract (no
    sampling margin — out-of-range values hit the runtime guard)."""
    for nd in (np.int8, np.int16, np.int32):
        dt = np.dtype(nd)
        if dt.itemsize >= wide.itemsize:
            return None
        info = np.iinfo(dt)
        if lo >= info.min and hi <= info.max:
            return dt
    return None


@dataclasses.dataclass
class WireSpec:
    """Versioned static wire-encoding choice for one stream.

    `encodings` maps lane names (attribute names; "__tsd__" for the
    timestamp-delta lane) to normalized entries:
    ("narrow", np.dtype) | ("dict", code np.dtype, card) |
    ("delta", np.dtype) | ("bitpack",). Lanes absent from the map ride
    full-width."""

    stream_id: str
    encodings: dict = dataclasses.field(default_factory=dict)
    version: int = WIRE_SPEC_VERSION


def encoding_label(entry) -> str:
    """Human/JSON-stable label for one encoding entry."""
    if isinstance(entry, np.dtype) or not isinstance(entry, tuple):
        return f"narrow:{np.dtype(entry).name}"
    kind = entry[0]
    if kind == "narrow":
        return f"narrow:{np.dtype(entry[1]).name}"
    if kind == "dict":
        return f"dict:{np.dtype(entry[1]).name}[{entry[2]}]"
    if kind == "delta":
        return f"delta:{np.dtype(entry[1]).name}"
    if kind == "bitpack":
        return "bitpack:1bit"
    return str(entry)


def _hint_entry(hint, t: AttrType, wide: np.dtype) -> Optional[tuple]:
    """Encoding entry for one hint tuple against one declared type, or
    None when the hint does not apply / does not shrink the lane."""
    if hint is None:
        return None
    if hint[0] == "range" and t in _INTEGRAL:
        dt = _narrow_for_range(int(hint[1]), int(hint[2]), wide)
        if dt is not None:
            return ("narrow", dt)
    elif hint[0] == "dict" and t in _INTEGRAL + _INTERNED:
        card = int(hint[1])
        code = np.dtype(np.uint8 if card <= 256 else np.uint16)
        if code.itemsize < wide.itemsize:
            return ("dict", code, card)
    elif hint[0] == "delta" and t in _INTEGRAL:
        dt = np.dtype(hint[1])
        if dt.itemsize < wide.itemsize:
            return ("delta", dt)
    return None


def build_wire_spec(
    stream_id: str, attrs, hints: dict, capacity: Optional[int] = None
) -> Optional[WireSpec]:
    """Static per-stream spec from declared attribute types + `@app:wire`
    hints. `attrs` is [(name, AttrType)]. With `capacity` (the micro-batch
    row count each batch amortizes a dictionary/delta header over) an
    encoding is kept only when its amortized bytes/row undercut the wide
    lane. Returns None when nothing is statically encodable (the sampled
    narrow wire then stands alone)."""
    enc: dict = {}
    for name, t in attrs:
        if t is None:
            continue
        wide = NUMPY_DTYPE[t]
        if t is AttrType.BOOL:
            entry = ("bitpack",)  # 1 bit/value, lossless, guard-free
        else:
            entry = _hint_entry(hints.get((stream_id, name)), t, wide)
        if entry is None:
            continue
        if capacity is not None and lane_bytes_per_row(
            name, wide, entry, capacity
        ) >= wide.itemsize:
            continue  # net loss at this chunk shape: stay wide
        enc[name] = entry
    if not enc:
        return None
    return WireSpec(stream_id, enc)


def choose_encodings(schema, keep, spec: Optional[WireSpec], enabled: bool,
                     ts_sample, cols_sample) -> dict:
    """The one place the wire-encoding decision is made for an engaging
    fused ingest: disabled -> {} (FULL-WIDTH wire, no sampling); enabled ->
    the sampled narrow map (`propose_narrow`) overlaid with the static
    spec's entries (static wins per lane)."""
    if not enabled:
        return {}
    enc = schema.propose_narrow(ts_sample, cols_sample, keep)
    if spec is not None:
        for lane, entry in spec.encodings.items():
            if keep is not None and lane not in keep and lane != "__tsd__":
                continue
            enc[lane] = entry
    return enc


def encodings_source(enc: dict, spec: Optional[WireSpec]) -> str:
    """'full-width' | 'sampled' | 'static' | 'static+sampled'."""
    if not enc:
        return "full-width"
    has_static = any(isinstance(e, tuple) for e in enc.values())
    has_sampled = any(not isinstance(e, tuple) for e in enc.values())
    if has_static and has_sampled:
        return "static+sampled"
    return "static" if has_static else "sampled"


def logical_row_bytes(attrs) -> int:
    """Full-width bytes/event with NO wire encoding (the packed per-batch
    codec: int64 ts + every column at its physical width)."""
    total = 8  # int64 timestamp
    for _name, t in attrs:
        total += NUMPY_DTYPE[t or AttrType.LONG].itemsize
    return total


def lane_bytes_per_row(name: str, wide: np.dtype, entry, capacity: int) -> float:
    """Amortized wire bytes/row of one lane under an encoding entry."""
    if entry is None:
        return wide.itemsize
    if not isinstance(entry, tuple):
        return np.dtype(entry).itemsize
    kind = entry[0]
    if kind == "narrow":
        return np.dtype(entry[1]).itemsize
    if kind == "dict":
        return np.dtype(entry[1]).itemsize + entry[2] * wide.itemsize / max(capacity, 1)
    if kind == "delta":
        return np.dtype(entry[1]).itemsize + 8.0 / max(capacity, 1)
    if kind == "bitpack":
        return 0.125
    return wide.itemsize


def wire_report(schema, keep, narrow: dict, spec: Optional[WireSpec],
                capacity: int = 8192) -> dict:
    """Wire summary for one engaged fused ingest: per-lane encoding labels +
    encoded vs logical bytes/event, amortizing dict/delta headers over
    `capacity` (the junction's micro-batch rows)."""
    enc = {k: _normalize(v) for k, v in (narrow or {}).items()}
    kept = [(name, t) for name, t in schema.attrs if keep is None or name in keep]
    tsd = enc.get("__tsd__", ("narrow", np.dtype(np.int32)))
    lanes = {"__tsd__": encoding_label(tsd)}
    encoded = np.dtype(tsd[1]).itemsize * 1.0
    for name, t in kept:
        wide = NUMPY_DTYPE[t]
        e = enc.get(name)
        lanes[name] = encoding_label(e) if e is not None else f"wide:{wide.name}"
        encoded += lane_bytes_per_row(name, wide, e, capacity)
    return {
        "source": encodings_source(narrow or {}, spec),
        "spec_version": spec.version if spec is not None else None,
        "lanes": lanes,
        "encoded_B_per_ev": round(encoded, 2),
        "logical_B_per_ev": logical_row_bytes(schema.attrs),
        "projected_out": [
            name for name, _t in schema.attrs if keep is not None and name not in keep
        ],
    }


# ---------------------------------------------------------------------------
# the codec: host encode (numpy), device decode (K4)
# ---------------------------------------------------------------------------


def _normalize(entry) -> tuple:
    """Plain dtypes (the sampled-narrow form) normalize to ("narrow",
    dtype); tuples pass through."""
    if isinstance(entry, tuple):
        return entry
    return ("narrow", np.dtype(entry))


def _lane_nbytes(kind: str, cap: int, wire_dt, wide_dt, card: int) -> int:
    if kind == "dict":
        return cap * wire_dt.itemsize + card * wide_dt.itemsize
    if kind == "delta":
        return 8 + cap * wire_dt.itemsize
    if kind == "bitpack":
        return -(-cap // 8)
    return cap * wire_dt.itemsize  # narrow / wide


# section kinds of csrc/wire_decode.cu (keep in step with its SectionKind)
SEC_TSD, SEC_COPY, SEC_DICT, SEC_DELTA, SEC_BITPACK, SEC_FILL = range(6)
_KIND_CODE = {"wide": SEC_COPY, "narrow": SEC_COPY, "dict": SEC_DICT,
              "delta": SEC_DELTA, "bitpack": SEC_BITPACK}
_MAX_SECTIONS = 32  # kMaxSections of csrc/wire_decode.cu


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Byte layout of one wire row for the decoder. `lanes` holds one entry
    per schema attribute, in schema order:
    (name, kind, offset, wire np.dtype, output torch dtype, dict card,
    fill bits) — kind in SEC_*; the timestamp lane is (tsd_offset, tsd_dtype)."""

    cap: int
    row_bytes: int
    tsd_dtype: np.dtype
    lanes: tuple


def _fill_bits(t: AttrType) -> int:
    """The null value of `t` as the little-endian bit pattern of its
    physical dtype (signed 64-bit)."""
    nv = null_value(t)
    dt = NUMPY_DTYPE[t]
    raw = np.asarray(0 if nv is None else nv, dt).tobytes()
    return int.from_bytes(raw.ljust(8, b"\0"), "little", signed=True)


def _bytes_as(seg: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """[K, n * itemsize] uint8 -> [K, n] of `dt`, from a dense copy (the
    section may sit at any byte offset of the row)."""
    tdt = torch.from_numpy(np.zeros(0, dt)).dtype
    if tdt is torch.bool:
        return seg != 0
    return seg.reshape(-1).clone().view(tdt).reshape(seg.shape[0], -1)


def wire_decode_ref(wire: torch.Tensor, counts: torch.Tensor, bases: torch.Tensor,
                    plan: DecodePlan):
    """Plain version of `wire_decode`, section by section as the JAX
    package's `build_codec.decode` computes it (bitcast, widen, gather,
    int64 / int32 cumsum, bit unpack, null fill)."""
    cap = plan.cap
    K = wire.shape[0]
    dev = wire.device
    tsd_dt = plan.tsd_dtype
    arr = _bytes_as(wire[:, : cap * tsd_dt.itemsize], tsd_dt)
    if tsd_dt.itemsize < 4:  # narrow tsd = diff-coded, int32 running sum
        arr = torch.cumsum(arr.to(torch.int32), 1, dtype=torch.int32)
    ts = bases.view(K, 1) + arr.to(torch.int64)
    cols = {}
    for name, kind, o, dt, out_dt, card, fill in plan.lanes:
        if kind == SEC_COPY:
            cols[name] = _bytes_as(wire[:, o : o + cap * dt.itemsize], dt).to(out_dt)
        elif kind == SEC_DICT:
            codes = _bytes_as(wire[:, o : o + cap * dt.itemsize], dt)
            o2 = o + cap * dt.itemsize
            wide = np.dtype(torch.empty(0, dtype=out_dt).numpy().dtype)
            vals = _bytes_as(wire[:, o2 : o2 + card * wide.itemsize], wide)
            idx = codes.to(torch.int64).clamp(max=card - 1)  # jnp gathers clamp
            cols[name] = torch.gather(vals, 1, idx)
        elif kind == SEC_DELTA:
            d_base = _bytes_as(wire[:, o : o + 8], np.dtype(np.int64))
            d = _bytes_as(wire[:, o + 8 : o + 8 + cap * dt.itemsize], dt)
            vals = d_base + torch.cumsum(d.to(torch.int64), 1)
            cols[name] = vals.to(out_dt)
        elif kind == SEC_BITPACK:
            seg = wire[:, o : o + -(-cap // 8)]
            idx = torch.arange(cap, dtype=torch.int64, device=dev)
            byte = seg[:, idx >> 3].to(torch.int32)
            cols[name] = ((byte >> (7 - (idx & 7)).to(torch.int32)) & 1).to(torch.bool)
        else:  # SEC_FILL: a column no subscriber reads
            bits = torch.tensor([fill], dtype=torch.int64)
            nbytes = torch.empty(0, dtype=out_dt).element_size()
            val = bits.view(torch.uint8)[:nbytes].view(out_dt)
            cols[name] = val.to(dev).expand(K, cap).clone()
    valid = torch.arange(cap, dtype=torch.int32, device=dev).view(1, cap) < counts.view(K, 1)
    kind_lane = torch.zeros((K, cap), dtype=torch.int8, device=dev)
    return ts, valid, kind_lane, cols


def wire_decode(wire: torch.Tensor, counts: torch.Tensor, bases: torch.Tensor,
                plan: DecodePlan):
    """Decode K wire rows into [K, cap] lanes (one launch for all K).

    wire:   [K, row_bytes] uint8, one encoded micro-batch per row
    counts: [K] int32 valid rows per micro-batch
    bases:  [K] int64 timestamp base per micro-batch
    returns (ts [K, cap] int64, valid [K, cap] bool, kind [K, cap] int8,
             {col: [K, cap] physical dtype} in schema order)
    """
    if wire.device.type == "cpu":
        return wire_decode_ref(wire, counts, bases, plan)
    kernels.require_cuda("wire_decode", wire, counts, bases)
    K = wire.shape[0]
    if (wire.dtype != torch.uint8 or wire.dim() != 2 or wire.shape[1] != plan.row_bytes
            or counts.dtype != torch.int32 or counts.shape != (K,)
            or bases.dtype != torch.int64 or bases.shape != (K,)):
        raise ValueError(
            f"wire_decode: expected uint8 [K, {plan.row_bytes}], int32 [K] counts and "
            f"int64 [K] bases; got {wire.dtype}{list(wire.shape)}, "
            f"{counts.dtype}{list(counts.shape)}, {bases.dtype}{list(bases.shape)}"
        )
    n_sec = 1 + len(plan.lanes)
    if n_sec > _MAX_SECTIONS or not 0 < K < 65536:
        raise ValueError(f"wire_decode: {n_sec} sections (max {_MAX_SECTIONS}), K={K}")
    out, err = _decode_launch(kernels.function("wire_decode"), wire, counts, bases, plan,
                              kernels.stream())
    kernels.check(err, "wire_decode")
    kernels.launches["wire_decode"] += 1
    return out


def _decode_launch(fn, wire, counts, bases, plan: DecodePlan, stream):
    """Allocate the output lanes on the wire's device and launch the C entry
    point `fn` of csrc/wire_decode.cu. Returns ((ts, valid, kind, cols),
    cudaError_t)."""
    K, cap, dev = wire.shape[0], plan.cap, wire.device
    ts = torch.empty((K, cap), dtype=torch.int64, device=dev)
    valid = torch.empty((K, cap), dtype=torch.bool, device=dev)
    kind = torch.empty((K, cap), dtype=torch.int8, device=dev)
    cols = {
        name: torch.empty((K, cap), dtype=out_dt, device=dev)
        for name, _k, _o, _dt, out_dt, _c, _f in plan.lanes
    }
    # per section: kind, wire itemsize, output itemsize, dict card, bool output
    ints = [SEC_TSD, plan.tsd_dtype.itemsize, 8, 0, 0]
    lls = [0, 0]  # byte offset, fill bits
    outs = [ts.data_ptr()]
    for name, k, o, dt, out_dt, card, fill in plan.lanes:
        lane = cols[name]
        ints += [k, dt.itemsize, lane.element_size(), card, int(out_dt is torch.bool)]
        lls += [o, fill]
        outs.append(lane.data_ptr())
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_lls = (ctypes.c_longlong * len(lls))(*lls)
    c_outs = (ctypes.c_void_p * len(outs))(*outs)
    err = fn(
        wire.data_ptr(), counts.data_ptr(), bases.data_ptr(), K, plan.row_bytes, cap,
        len(outs), ctypes.addressof(c_ints), ctypes.addressof(c_lls),
        ctypes.addressof(c_outs), valid.data_ptr(), kind.data_ptr(), stream,
    )
    return (ts, valid, kind, cols), err


def build_codec(schema, capacity: int, keep, narrow: dict):
    """The fused-ingest wire codec: encode(ts, cols, n, out=None) ->
    (buf u8[total], base int64); decode(wire [K, total], counts [K],
    bases [K]) -> EventBatch of [K, capacity] lanes; total = row bytes.
    `narrow` maps lane names to encoding entries (plain np.dtype = sampled
    narrow downcast). Invoked through `StreamSchema.wire_codec` (which owns
    the cache)."""
    from siddhi_tpu_torch.core.event import EventBatch, WireNarrowMisfit

    narrow = {k: _normalize(v) for k, v in (narrow or {}).items()}
    cap = int(capacity)
    kept = [(name, t) for name, t in schema.attrs if keep is None or name in keep]

    # (lane, kind, wire dtype, decoded dtype, dict card)
    tsd_entry = narrow.get("__tsd__", ("narrow", np.dtype(np.int32)))
    sections: list[tuple] = [
        ("__tsd__", "narrow", np.dtype(tsd_entry[1]), np.dtype(np.int32), 0)
    ]
    for name, t in kept:
        wide = NUMPY_DTYPE[t]
        entry = narrow.get(name)
        if entry is None:
            sections.append((name, "wide", wide, wide, 0))
            continue
        kind = entry[0]
        if kind == "narrow":
            sections.append((name, "narrow", np.dtype(entry[1]), wide, 0))
        elif kind == "dict":
            sections.append((name, "dict", np.dtype(entry[1]), wide, int(entry[2])))
        elif kind == "delta":
            sections.append((name, "delta", np.dtype(entry[1]), wide, 0))
        elif kind == "bitpack":
            sections.append((name, "bitpack", np.dtype(np.uint8), wide, 0))
        else:
            sections.append((name, "wide", wide, wide, 0))
    offsets = []
    off = 0
    for _name, kind, wire_dt, wide_dt, card in sections:
        offsets.append(off)
        off += _lane_nbytes(kind, cap, wire_dt, wide_dt, card)
    total = off

    tsd_diff = sections[0][2].itemsize < 4  # narrow tsd = diff-coded

    def _check_fits(src, dt: np.dtype, name: str) -> None:
        if src.size == 0:
            return
        info = np.iinfo(dt)
        if int(src.min()) < info.min or int(src.max()) > info.max:
            raise WireNarrowMisfit(name)

    def encode(timestamps: np.ndarray, cols: dict, n: int, out=None):
        base = np.int64(timestamps[0]) if n > 0 else np.int64(0)
        if out is None:
            buf = np.zeros((total,), dtype=np.uint8)
        else:  # a row of a pooled wire slot
            buf = out
            buf[:] = 0
        for (name, kind, dt, wide, card), o in zip(sections, offsets):
            if name == "__tsd__":
                ts64 = timestamps[:n].astype(np.int64, copy=False)
                if n > 0 and (
                    int(ts64.max()) - int(base) >= (1 << 31)
                    or int(ts64.min()) - int(base) < -(1 << 31)
                ):
                    raise ValueError(
                        "wire_codec: timestamp span exceeds int32 deltas "
                        "(>~24.8 days per batch); use packed_codec"
                    )
                src = np.diff(ts64, prepend=base) if tsd_diff else ts64 - base
                if dt.itemsize < 4:
                    _check_fits(src, dt, name)
                buf[o : o + cap * dt.itemsize].view(dt)[:n] = src.astype(dt, copy=False)
                continue
            src = np.asarray(cols[name])[:n]
            if kind == "wide":
                buf[o : o + cap * dt.itemsize].view(dt)[:n] = src.astype(dt, copy=False)
            elif kind == "narrow":
                if dt.itemsize < wide.itemsize:
                    _check_fits(src, dt, name)
                buf[o : o + cap * dt.itemsize].view(dt)[:n] = src.astype(dt, copy=False)
            elif kind == "dict":
                # per-batch dictionary: codes + the batch's unique values;
                # cardinality overflow = the runtime guard (full-width
                # fallback), so a mis-declared stream stays correct
                uniq, inv = np.unique(src, return_inverse=True)
                if uniq.size > card:
                    raise WireNarrowMisfit(name)
                codes = buf[o : o + cap * dt.itemsize].view(dt)
                if n > 0:
                    codes[:n] = inv.astype(dt, copy=False)
                vals = buf[
                    o + cap * dt.itemsize : o + cap * dt.itemsize + card * wide.itemsize
                ].view(wide)
                vals[: uniq.size] = uniq.astype(wide, copy=False)
            elif kind == "delta":
                d_base = np.int64(src[0]) if n > 0 else np.int64(0)
                d = np.diff(src.astype(np.int64, copy=False), prepend=d_base)
                _check_fits(d, dt, name)
                buf[o : o + 8].view(np.int64)[0] = d_base
                buf[o + 8 : o + 8 + cap * dt.itemsize].view(dt)[:n] = d.astype(
                    dt, copy=False
                )
            elif kind == "bitpack":
                if n > 0:
                    packed = np.packbits(src.astype(bool), bitorder="big")
                    buf[o : o + packed.size] = packed
        return buf, base

    lanes = []
    by_name = {s[0]: (s, o) for s, o in zip(sections, offsets)}
    for name, t in schema.attrs:
        out_dt = PHYSICAL_DTYPE[t]
        hit = by_name.get(name)
        if hit is None:  # dropped: no subscriber reads it
            lanes.append((name, SEC_FILL, 0, NUMPY_DTYPE[t], out_dt, 0, _fill_bits(t)))
            continue
        (_n, kind, dt, _wide, card), o = hit
        lanes.append((name, _KIND_CODE[kind], o, dt, out_dt, card, 0))
    plan = DecodePlan(cap=cap, row_bytes=total, tsd_dtype=sections[0][2],
                      lanes=tuple(lanes))

    def decode(wire: torch.Tensor, counts: torch.Tensor, bases: torch.Tensor):
        ts, valid, kind, cols = wire_decode(wire, counts, bases, plan)
        return EventBatch(ts=ts, kind=kind, valid=valid, cols=cols)

    decode.plan = plan
    return encode, decode, total
