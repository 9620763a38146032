"""Columnar event substrate.

Replaces the reference's pooled linked-list event representation
(reference: core/event/ComplexEvent.java:48-53, event/stream/StreamEvent.java:37-120,
event/ComplexEventChunk.java:29-246) with a fixed-capacity columnar `EventBatch`:
one device tensor per attribute plus timestamp / kind / validity lanes. The four
reference event types CURRENT/EXPIRED/TIMER/RESET become an int8 `kind` lane;
pool-borrowing becomes padding to a static batch capacity.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch

from siddhi_tpu_torch.core.types import (
    NUMPY_DTYPE,
    PHYSICAL_DTYPE,
    AttrType,
    InternTable,
    null_value,
)

# ComplexEvent.Type equivalents (reference: core/event/ComplexEvent.java:48-53).
KIND_CURRENT = 0
KIND_EXPIRED = 1
KIND_TIMER = 2
KIND_RESET = 3

# Host-side event (reference: core/event/Event.java — timestamp + Object[] data).
Event = collections.namedtuple("Event", ["timestamp", "data"])


class WireNarrowMisfit(ValueError):
    """A value in this batch does not fit the chosen narrow wire dtype; the
    sender must rebuild with the full-width wire and retry."""


@dataclasses.dataclass
class EventBatch:
    """A fixed-capacity micro-batch of events for one stream.

    ts:    [B] int64 — epoch milliseconds (reference StreamEvent.timestamp)
    kind:  [B] int8  — KIND_* lane
    valid: [B] bool  — row occupancy (padding rows are False)
    cols:  {attr_name: [B] tensor} in schema order
    """

    ts: torch.Tensor
    kind: torch.Tensor
    valid: torch.Tensor
    cols: dict[str, torch.Tensor]

    @property
    def capacity(self) -> int:
        return self.ts.shape[-1]


def _sections(capacity: int, lanes: list[tuple[str, np.dtype]]):
    """Byte layout of one packed buffer: widest lanes first, so every section
    offset is a multiple of its itemsize for ANY capacity and each section can
    be reinterpreted in place (`Tensor.view(dtype)` / `ndarray.view`)."""
    lanes = sorted(lanes, key=lambda s: -s[1].itemsize)
    out = []
    off = 0
    for name, dt in lanes:
        out.append((name, dt, off))
        off += capacity * dt.itemsize
    return out, off


class StreamSchema:
    """Typed stream definition (reference: query-api definition/StreamDefinition.java)."""

    def __init__(self, stream_id: str, attrs: Sequence[tuple[str, AttrType]]):
        self.stream_id = stream_id
        self.attrs: list[tuple[str, AttrType]] = list(attrs)
        self.attr_names = [n for n, _ in self.attrs]
        self.attr_types = {n: t for n, t in self.attrs}
        if len(self.attr_types) != len(self.attrs):
            raise ValueError(f"duplicate attribute in stream '{stream_id}'")
        self._codecs: dict = {}

    def __repr__(self) -> str:
        return f"StreamSchema({self.stream_id}, {self.attrs})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, StreamSchema)
            and self.stream_id == other.stream_id
            and self.attrs == other.attrs
        )

    def __hash__(self) -> int:
        return hash((self.stream_id, tuple(self.attrs)))

    # ---- host <-> device conversion -------------------------------------

    def to_batch(
        self,
        timestamps: Sequence[int],
        rows: Sequence[Sequence[Any]],
        interner: InternTable,
        device,
        capacity: int | None = None,
        kinds: Sequence[int] | None = None,
    ) -> EventBatch:
        """Pack host events into a padded columnar batch (numpy staging)."""
        n = len(rows)
        cap = capacity if capacity is not None else n
        if n > cap:
            raise ValueError(f"{n} events exceed batch capacity {cap}")
        ts = np.zeros((cap,), dtype=np.int64)
        ts[:n] = np.asarray(list(timestamps), dtype=np.int64)
        kind = np.zeros((cap,), dtype=np.int8)
        if kinds is not None:
            kind[:n] = np.asarray(list(kinds), dtype=np.int8)
        valid = np.zeros((cap,), dtype=np.bool_)
        valid[:n] = True
        for r in rows:
            if len(r) != len(self.attrs):
                raise ValueError(
                    f"stream '{self.stream_id}' expects {len(self.attrs)} "
                    f"attributes {self.attr_names}, got {len(r)}: {r!r}"
                )
        cols: dict[str, torch.Tensor] = {}
        for j, (name, t) in enumerate(self.attrs):
            arr = np.full((cap,), null_value(t), dtype=NUMPY_DTYPE[t])
            for i in range(n):
                v = rows[i][j]
                if t in (AttrType.STRING, AttrType.OBJECT):
                    arr[i] = interner.intern(v)
                elif v is None:
                    arr[i] = null_value(t)
                else:
                    arr[i] = v
            cols[name] = torch.from_numpy(arr).to(device)
        return EventBatch(
            ts=torch.from_numpy(ts).to(device),
            kind=torch.from_numpy(kind).to(device),
            valid=torch.from_numpy(valid).to(device),
            cols=cols,
        )

    def to_batch_cols(
        self,
        timestamps: np.ndarray,
        cols: dict[str, np.ndarray],
        interner: InternTable,
        device,
        capacity: int | None = None,
    ) -> EventBatch:
        """Vectorized columnar packing: numpy arrays -> device batch.

        String/object columns may be pre-interned int arrays or object arrays
        (interned via np.unique — one table lookup per distinct value).
        """
        ts = np.asarray(timestamps, dtype=np.int64)
        n = ts.shape[0]
        cap = capacity if capacity is not None else n
        if n > cap:
            raise ValueError(f"{n} events exceed batch capacity {cap}")
        out_ts = np.zeros((cap,), dtype=np.int64)
        out_ts[:n] = ts
        valid = np.zeros((cap,), dtype=np.bool_)
        valid[:n] = True
        out_cols: dict[str, torch.Tensor] = {}
        for name, t in self.attrs:
            dt = NUMPY_DTYPE[t]
            src = np.asarray(cols[name])
            if t in (AttrType.STRING, AttrType.OBJECT) and src.dtype.kind in "OUS":
                if t is AttrType.OBJECT or src.dtype.kind == "O":
                    # objects may not be orderable (np.unique sorts) — intern
                    # per item like the row path
                    src = np.asarray(
                        [interner.intern(v) for v in src.tolist()], dtype=dt
                    )
                else:
                    uniq, inv = np.unique(src, return_inverse=True)
                    ids = np.asarray(
                        [interner.intern(v) for v in uniq.tolist()], dtype=dt
                    )
                    src = ids[inv]
            arr = np.full((cap,), null_value(t), dtype=dt)
            arr[:n] = src.astype(dt)
            out_cols[name] = torch.from_numpy(arr).to(device)
        return EventBatch(
            ts=torch.from_numpy(out_ts).to(device),
            kind=torch.zeros(cap, dtype=torch.int8, device=device),
            valid=torch.from_numpy(valid).to(device),
            cols=out_cols,
        )

    def packed_codec(self, capacity: int, device):
        """Single-transfer ingest codec: the host packs timestamps + all
        columns into ONE contiguous byte buffer (pinned on a CUDA device),
        copies it to the device in one transfer, and splits it back into
        the columnar lanes as dtype views of that one device buffer.

        encode(ts, cols, n) -> host uint8 tensor; decode(buf, n) -> EventBatch
        """
        device = torch.device(device)
        key = ("packed", capacity, device)
        if key in self._codecs:
            return self._codecs[key]
        cap = int(capacity)
        lanes = [("__ts__", np.dtype(np.int64))] + [
            (name, NUMPY_DTYPE[t]) for name, t in self.attrs
        ]
        sections, total = _sections(cap, lanes)
        pin = device.type == "cuda"
        arange = torch.arange(cap, device=device)
        kind = torch.zeros(cap, dtype=torch.int8, device=device)
        torch_dtype = {n: PHYSICAL_DTYPE[t] for n, t in self.attrs}
        torch_dtype["__ts__"] = torch.int64

        def encode(timestamps: np.ndarray, cols: dict, n: int) -> torch.Tensor:
            buf = torch.zeros(total, dtype=torch.uint8, pin_memory=pin)
            host = buf.numpy()
            for name, dt, o in sections:
                dst = host[o : o + cap * dt.itemsize].view(dt)
                src = timestamps if name == "__ts__" else cols[name]
                dst[:n] = np.asarray(src[:n]).astype(dt, copy=False)
            return buf

        def decode(buf: torch.Tensor, n: int) -> EventBatch:
            dev = buf.to(device, non_blocking=True)
            lanes_out = {
                name: dev[o : o + cap * dt.itemsize].view(torch_dtype[name])
                for name, dt, o in sections
            }
            ts = lanes_out.pop("__ts__")
            return EventBatch(
                ts=ts,
                kind=kind,
                valid=arange < n,
                cols={name: lanes_out[name] for name in self.attr_names},
            )

        self._codecs[key] = (encode, decode)
        return encode, decode

    def propose_narrow(
        self,
        timestamps: np.ndarray,
        cols: dict,
        keep: frozenset | None = None,
        margin: int = 4,
    ) -> dict:
        """Sample-driven narrow wire dtypes: for each integer lane (and the
        ts-delta lane), the smallest dtype whose range covers `margin`x the
        sample's extremes. Used once at fused-ingest engagement; a later
        batch that does not fit raises WireNarrowMisfit and the caller falls
        back to the full-width wire (one rebuild, then permanent)."""
        narrow: dict[str, np.dtype] = {}

        def pick(lo: int, hi: int, wide: np.dtype) -> np.dtype | None:
            for nd in (np.int16, np.int32):
                dt = np.dtype(nd)
                if dt.itemsize >= wide.itemsize:
                    return None
                info = np.iinfo(dt)
                if lo * margin >= info.min and hi * margin <= info.max:
                    return dt
            return None

        n = len(timestamps)
        if n:
            # tsd rides as CONSECUTIVE diffs (decode reconstructs with a
            # device cumsum), so steady event streams narrow to int8/int16
            # even when the whole batch spans more than the dtype's range
            d = np.diff(timestamps[:n].astype(np.int64), prepend=timestamps[0])
            lo, hi = int(d.min()), int(d.max())
            for nd in (np.int8, np.int16):
                info = np.iinfo(nd)
                if lo * margin >= info.min and hi * margin <= info.max:
                    narrow["__tsd__"] = np.dtype(nd)
                    break
        for name, t in self.attrs:
            if keep is not None and name not in keep:
                continue
            wide = NUMPY_DTYPE[t]
            if wide.kind != "i" or name not in cols or n == 0:
                continue
            src = np.asarray(cols[name])[:n]
            if src.dtype.kind not in "iu":
                continue  # un-interned strings etc. — leave wide
            got = pick(int(src.min()), int(src.max()), wide)
            if got is not None:
                narrow[name] = got
        return narrow

    def wire_codec(
        self,
        capacity: int,
        keep: frozenset | None = None,
        narrow: dict | None = None,
    ):
        """Projected/narrowed single-transfer codec for fused ingest
        (core/wire.py `build_codec`), cached per (capacity, keep, narrow).

        Cuts wire bytes/event three ways against `packed_codec`: timestamps
        ride as int32 (or narrower, diff-coded) offsets from a per-batch
        int64 base; columns not in `keep` (attributes no subscriber ever
        reads, from Scope.used_keys) are not shipped and decode null-filled;
        `narrow` maps lanes to smaller encodings (sampled downcasts or the
        dict/delta/bitpack tuples of core/wire.py), each guarded on encode by
        WireNarrowMisfit.

        encode(ts, cols, n) -> (buf uint8[total], base int64)
        decode(wire [K, total] u8, counts [K] int32, bases [K] int64)
            -> EventBatch of [K, capacity] lanes (the K4 kernel on the card)
        """
        from siddhi_tpu_torch.core.wire import build_codec

        narrow = narrow or {}
        key = (
            "wire",
            capacity,
            keep,
            tuple(sorted((k, str(v)) for k, v in narrow.items())),
        )
        cached = self._codecs.get(key)
        if cached is not None:
            return cached
        codec = build_codec(self, capacity, keep, narrow)
        self._codecs[key] = codec
        return codec

    def d2h_codec(self, capacity: int):
        """Single-transfer device->host codec: `pack` views every lane of an
        EventBatch as bytes and concatenates them into ONE device buffer, so
        the host readback is one copy instead of one per lane.
        pack(batch) -> u8[total]; unpack(host_buf) -> (ts, kind, valid, cols).
        """
        key = ("d2h", capacity)
        if key in self._codecs:
            return self._codecs[key]
        cap = int(capacity)
        lanes = [
            ("__ts__", np.dtype(np.int64)),
            ("__kind__", np.dtype(np.int8)),
            ("__valid__", np.dtype(np.uint8)),
        ] + [(name, NUMPY_DTYPE[t]) for name, t in self.attrs]
        sections, _total = _sections(cap, lanes)

        def pack(batch: EventBatch) -> torch.Tensor:
            segs = []
            for name, _dt, _o in sections:
                if name == "__ts__":
                    x = batch.ts
                elif name == "__kind__":
                    x = batch.kind
                elif name == "__valid__":
                    x = batch.valid
                else:
                    x = batch.cols[name]
                if x.stride(-1) != 1:  # a broadcast lane (a one-row batch's constant)
                    x = torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)
                segs.append(x.contiguous().view(torch.uint8))
            return torch.cat(segs)

        def unpack(buf: np.ndarray):
            out = {
                name: buf[o : o + cap * dt.itemsize].view(dt)
                for name, dt, o in sections
            }
            ts = out.pop("__ts__")
            kind = out.pop("__kind__")
            valid = out.pop("__valid__").astype(bool)
            return ts, kind, valid, out

        self._codecs[key] = (pack, unpack)
        return pack, unpack

    def from_batch(
        self, batch: EventBatch, interner: InternTable
    ) -> list[tuple[int, int, tuple]]:
        """Unpack valid rows to host `(timestamp, kind, data_tuple)` triples,
        with ONE device->host copy for all lanes."""
        pack, unpack = self.d2h_codec(batch.capacity)
        ts, kind, valid, host_cols = unpack(pack(batch).cpu().numpy())
        idx = np.nonzero(valid)[0]
        if idx.size == 0:
            return []
        return rows_from_arrays(
            self,
            ts[idx],
            kind[idx],
            {n: c[idx] for n, c in host_cols.items()},
            idx.size,
            interner,
        )


def column_lists(schema, cols: dict, n: int, interner) -> list[list]:
    """Vectorized host decode of n packed rows into per-attribute Python
    lists (bulk .tolist() + null fix-ups)."""
    col_lists = []
    for name, t in schema.attrs:
        arr = np.asarray(cols[name])[:n]
        if t in (AttrType.STRING, AttrType.OBJECT):
            col_lists.append(interner.lookup_many(arr))
        elif t is AttrType.BOOL:
            col_lists.append(arr.astype(bool).tolist())
        elif t in (AttrType.FLOAT, AttrType.DOUBLE):
            vals = arr.tolist()
            for i in np.nonzero(np.isnan(arr))[0]:
                vals[i] = None
            col_lists.append(vals)
        else:
            vals = arr.tolist()
            for i in np.nonzero(arr == np.asarray(null_value(t), arr.dtype))[0]:
                vals[i] = None
            col_lists.append(vals)
    return col_lists


def rows_from_arrays(
    schema, ts: np.ndarray, kind: np.ndarray, cols: dict, n: int, interner
) -> list[tuple[int, int, tuple]]:
    """Vectorized host decode of n packed rows -> (ts, kind, data) triples."""
    if n <= 0:
        return []
    col_lists = column_lists(schema, cols, n, interner)
    ts_l = np.asarray(ts)[:n].tolist()
    if isinstance(kind, int):  # single-kind fast path (deliver drain)
        kind_l = [kind] * n
    else:
        kind_l = np.asarray(kind)[:n].tolist()
    return list(zip(ts_l, kind_l, zip(*col_lists)))


def events_from_arrays(
    schema, ts: np.ndarray, cols: dict, n: int, interner
) -> list:
    """Vectorized host decode straight to Event objects (single-kind fused
    egress fast path — skips the triple intermediate entirely)."""
    if n <= 0:
        return []
    col_lists = column_lists(schema, cols, n, interner)
    ts_l = np.asarray(ts)[:n].tolist()
    mk = functools.partial(tuple.__new__, Event)
    return list(map(mk, zip(ts_l, zip(*col_lists))))
