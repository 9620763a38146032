"""Pattern / sequence NFA engine over token tables: the two batch routes.

Reference: query/input/stream/state/*PreStateProcessor.java and
StreamPostStateProcessor.java — a per-event interpreter over linked state
processors, each holding a pending list of partial matches. As in the JAX
package (siddhi_tpu/core/pattern.py), the whole NFA lives in one
fixed-capacity token table on the device: every partial match is a lane
holding its current slot, its start and entry timestamps, and per state ref
an occurrence count and capture columns. `every` at the first slot is a
persistent slot whose matches fork into free lanes.

Two batch routes process a chunk of rows per device pass (the JAX package's
`apply_batch_fast` and `apply_batch_count`), with three hand-written CUDA
kernels on the card, each beside its plain PyTorch version (taken only for
tensors on the CPU):
- `pattern_advance` (csrc/pattern_advance.cu): one slot's pass over the
  [T, C] token x row match — each eligible token advances to its first
  matching row, or, for `every` at slot 0, each matching row forks a token;
- `pattern_count` (csrc/pattern_count.cu): the closed form of a count state
  `<m:n>` at slot 0 and the advance at slot 1, with the `every` generation
  chain;
- `pattern_emit` (csrc/pattern_emit.cu): completed tokens into the emission
  buffer, ordered by completion row then lane, and the `within` purge.

The per-event scan route (`apply_event`: logical and absent states, counts
under `within`, multi-stream sequences, counts anywhere but slot 0) is not
ported yet: a pattern that needs it raises at app creation.

Deliberate deviations from the reference interpreter are the JAX package's
(its module docstring): static token/capture capacity with overflow flags,
the generation chain of `every` over a count, lane-order emission among
tokens completing on the same event, and counts that keep counting past the
capture capacity.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.aggregators import _null_bits
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import KIND_CURRENT, StreamSchema
from siddhi_tpu_torch.core.executor import TS_ATTR, Env, Scope, compile_expression
from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE, AttrType, InternTable, null_value
from siddhi_tpu_torch.ops.prefix import first_indices
from siddhi_tpu_torch.ops.scatter import set_at
from siddhi_tpu_torch.query_api.execution import (
    AbsentStreamStateElement,
    CountStateElement,
    EveryStateElement,
    Filter,
    LogicalStateElement,
    LogicalType,
    NextStateElement,
    StateElement,
    StateInputStream,
    StateStreamType,
    StreamStateElement,
)

NO_TIMER = int(np.iinfo(np.int64).max)

DEFAULT_TOKEN_CAPACITY = 128
DEFAULT_COUNT_CAPACITY = 8

_UNBOUNDED = 1 << 30  # a count's max when `<m:>`: counting runs on past the captures


def _min_within(slot_ms, global_ms):
    """Effective within bound: a token dies when EITHER the slot's or the
    pattern-global within is exceeded."""
    if slot_ms is None:
        return global_ms
    if global_ms is None:
        return slot_ms
    return min(slot_ms, global_ms)


@dataclasses.dataclass
class Atom:
    """One stream obligation inside a slot (reference: a single
    Stream/AbsentStream state element)."""

    ref: str
    ref_idx: int
    stream_id: str
    filters: list  # raw Expression list, compiled in PatternProgram
    absent: bool = False
    waiting_ms: Optional[int] = None
    cap: int = 1  # occurrence capture capacity K


@dataclasses.dataclass
class Slot:
    """One linearized NFA state (reference: one Pre/Post state-processor pair)."""

    index: int
    atoms: list  # [Atom] — two entries for logical elements
    logical: Optional[LogicalType] = None
    min_count: int = 1
    max_count: int = 1  # -1 == unbounded
    persistent: bool = False  # `every` entry: matches fork, token stays
    within_ms: Optional[int] = None

    @property
    def is_count(self) -> bool:
        return not (self.min_count == 1 and self.max_count == 1)

    @property
    def is_absent(self) -> bool:
        return len(self.atoms) == 1 and self.atoms[0].absent


def _flatten_state(elem: StateElement, slots: list, refs: list, schemas: dict, count_cap: int,
                   every_blocks: list) -> None:
    """Linearize the state-element tree into the slot chain (reference:
    StateInputStreamParser.parseInputStream recursive walk)."""

    def new_atom(stream, absent=False, waiting=None, cap=1) -> Atom:
        sid = stream.stream_id
        if sid not in schemas:
            raise SiddhiAppCreationError(f"stream '{sid}' is not defined")
        ref = stream.alias
        if ref is None:
            # unaliased: referenceable by stream name when that stream appears
            # exactly once in the pattern; otherwise synthetic
            uses = sum(1 for r in refs if r.stream_id == sid)
            ref = sid if uses == 0 else f"__p{len(refs)}"
        if any(r.ref == ref for r in refs):
            raise SiddhiAppCreationError(f"duplicate pattern event reference '{ref}'")
        filters = [h.expression for h in stream.handlers if isinstance(h, Filter)]
        if len(filters) != len(stream.handlers):
            raise SiddhiAppCreationError(
                "pattern sources support only filters (no windows/stream functions)")
        a = Atom(ref, len(refs), sid, filters, absent=absent, waiting_ms=waiting, cap=cap)
        refs.append(a)
        return a

    if isinstance(elem, NextStateElement):
        first = len(slots)
        _flatten_state(elem.state, slots, refs, schemas, count_cap, every_blocks)
        _flatten_state(elem.next, slots, refs, schemas, count_cap, every_blocks)
        if elem.within_ms is not None:
            for s in slots[first:]:
                s.within_ms = s.within_ms or elem.within_ms
    elif isinstance(elem, EveryStateElement):
        first = len(slots)
        _flatten_state(elem.state, slots, refs, schemas, count_cap, every_blocks)
        if len(slots) == first + 1:
            slots[first].persistent = True  # single-slot every: forks per match
        elif len(slots) > first + 1:
            every_blocks.append((first, len(slots) - 1))  # re-arms when the block completes
        if elem.within_ms is not None:
            for s in slots[first:]:
                s.within_ms = s.within_ms or elem.within_ms
    elif isinstance(elem, CountStateElement):
        mx = elem.max_count
        cap = mx if 0 < mx <= count_cap else count_cap
        atom = new_atom(elem.stream.stream, cap=cap)
        slots.append(Slot(len(slots), [atom], min_count=elem.min_count, max_count=mx,
                          within_ms=elem.within_ms))
    elif isinstance(elem, LogicalStateElement):
        atoms = []
        for side in (elem.left, elem.right):
            if isinstance(side, AbsentStreamStateElement):
                atoms.append(new_atom(side.stream, absent=True, waiting=side.waiting_time_ms))
            elif isinstance(side, StreamStateElement):
                atoms.append(new_atom(side.stream))
            else:
                raise SiddhiAppCreationError("'and'/'or' sides must be plain or absent streams")
        if all(a.absent for a in atoms) and any(a.waiting_ms is None for a in atoms):
            raise SiddhiAppCreationError(
                "a logical element with both sides absent needs 'for <time>' on each side "
                "(reference: AbsentLogicalPreStateProcessor waiting times)")
        slots.append(Slot(len(slots), atoms, logical=elem.type, within_ms=elem.within_ms))
    elif isinstance(elem, AbsentStreamStateElement):
        if elem.waiting_time_ms is None:
            raise SiddhiAppCreationError(
                "a standalone absent stream needs 'for <time>' "
                "(reference: AbsentStreamPreStateProcessor waiting time)")
        atom = new_atom(elem.stream, absent=True, waiting=elem.waiting_time_ms)
        slots.append(Slot(len(slots), [atom], within_ms=elem.within_ms))
    elif isinstance(elem, StreamStateElement):
        atom = new_atom(elem.stream)
        slots.append(Slot(len(slots), [atom], within_ms=elem.within_ms))
    else:
        raise SiddhiAppCreationError(f"unsupported state element {type(elem).__name__}")


# ---------------------------------------------------------------------------
# shared kernel plumbing
# ---------------------------------------------------------------------------


def _with_col0(arr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    out = arr.clone()
    out[:, 0] = col
    return out


def _cond_view(cond: Optional[torch.Tensor], dev) -> tuple:
    """A condition broadcastable to [T, C] as (contiguous tensor, stride
    along T, stride along C) in elements; None is always true."""
    if cond is None:
        return torch.ones((1, 1), dtype=torch.bool, device=dev), 0, 0
    c = cond.reshape(1, 1) if cond.dim() == 0 else cond
    c = c.contiguous()
    a, b = c.shape
    return c, (b if a > 1 else 0), (1 if b > 1 else 0)


class _Lanes:
    """Host arrays of lane descriptors for one C entry point (kept alive
    until the call returns)."""

    def __init__(self, fields: dict):
        self.n = len(next(iter(fields.values()))[1]) if fields else 0
        self._arrays = {}
        for name, (ctype, vals) in fields.items():
            arr = (ctype * max(1, self.n))(*vals)
            self._arrays[name] = arr

    def __getitem__(self, name: str) -> int:
        return ctypes.addressof(self._arrays[name])


def _flag_out(overflow: torch.Tensor) -> torch.Tensor:
    return torch.empty((), dtype=torch.bool, device=overflow.device)


# ---------------------------------------------------------------------------
# K13: one slot's pass over the token x row match
# ---------------------------------------------------------------------------


def pattern_advance_ref(prog: "PatternProgram", p: int, tok: dict, entry_row, v, batch_ts,
                        ev: dict, cond, overflow, tail: bool = False):
    """Plain version of `pattern_advance`, in the JAX package's formulation
    (apply_batch_fast's slot body; with tail=True, apply_batch_count's tail
    slot body): the [T, C] match matrix materialised, argmax for the first
    match, first_indices for the free lanes."""
    slot = prog.slots[p]
    atom = slot.atoms[0]
    _keep, ts_used = prog.capture_keep()
    T = tok["active"].shape[0]
    C = batch_ts.shape[0]
    dev = batch_ts.device
    rows = torch.arange(C, dtype=torch.int32, device=dev)
    elig = tok["active"] & (tok["slot"] == p)
    M = elig[:, None] & v[None, :] & (rows[None, :] > entry_row[:, None])
    if cond is not None:
        M = M & cond
    fork, strict, win = prog._pass_kind(p, tail)
    if win is not None:
        started = tok["start_ts"] >= 0
        M = M & ~(started[:, None] & (batch_ts[None, :] - tok["start_ts"][:, None] > win))
    if strict:
        nxt_ok = v[None, :] & (rows[None, :] > entry_row[:, None])
        has_next = nxt_ok.any(dim=1)
        jnext = torch.argmax(nxt_ok.to(torch.int8), dim=1).to(torch.int32)
        M = M & (rows[None, :] == jnext[:, None])
        die = elig & has_next & ~M.any(dim=1)
        tok = {**tok, "active": tok["active"] & ~die}
    caps = list(tok["caps"])
    cr = dict(caps[atom.ref_idx])
    if fork:
        fk = M.any(dim=0) & v
        fi = fk.to(torch.int32)
        frank = torch.cumsum(fi, 0, dtype=torch.int32) - fi
        free_idx = first_indices(~tok["active"], C)
        dest = torch.where(fk, free_idx[frank.clamp(0, C - 1).long()], -1)
        okf = fk & (dest >= 0)
        overflow = overflow | (fk & (dest < 0)).any()
        dstc = torch.where(okf, dest, T)
        one = torch.ones((), dtype=torch.int32, device=dev)
        new = {
            "active": set_at(tok["active"], dstc, torch.ones((), dtype=torch.bool, device=dev)),
            "slot": set_at(tok["slot"], dstc, one * (p + 1)),
            "start_ts": set_at(tok["start_ts"], dstc, batch_ts),
            "entry_ts": set_at(tok["entry_ts"], dstc, batch_ts),
        }
        entry_row = set_at(entry_row, dstc, rows)
        cr["n"] = set_at(cr["n"], dstc, one)
        if ts_used[atom.ref_idx]:
            cr["ts"] = _with_col0(cr["ts"], set_at(cr["ts"][:, 0], dstc, batch_ts))
        cr["cols"] = {name: _with_col0(arr, set_at(arr[:, 0], dstc, ev[name]))
                      for name, arr in cr["cols"].items()}
    else:
        has = M.any(dim=1)
        j = torch.argmax(M.to(torch.int8), dim=1).to(torch.int32)
        jc = j.clamp(0, C - 1).long()
        mts = batch_ts[jc]
        cr["n"] = torch.where(has, torch.ones_like(cr["n"]), cr["n"])
        if ts_used[atom.ref_idx]:
            cr["ts"] = _with_col0(cr["ts"], torch.where(has, mts, cr["ts"][:, 0]))
        cr["cols"] = {name: _with_col0(arr, torch.where(has, ev[name][jc], arr[:, 0]))
                      for name, arr in cr["cols"].items()}
        start = tok["start_ts"]
        new = {
            "active": tok["active"],
            "slot": torch.where(has, torch.full_like(tok["slot"], p + 1), tok["slot"]),
            "start_ts": start if tail else torch.where(has & (start < 0), mts, start),
            "entry_ts": torch.where(has, mts, tok["entry_ts"]),
        }
        entry_row = torch.where(has, j, entry_row)
    caps[atom.ref_idx] = cr
    return {**tok, **new, "caps": caps}, entry_row, overflow


def pattern_advance(prog: "PatternProgram", p: int, tok: dict, entry_row, v, batch_ts,
                    ev: dict, cond, overflow, tail: bool = False):
    """One NFA slot's pass over a chunk (the match of every token at slot p
    against rows C; see csrc/pattern_advance.cu).

    tok: the token table; entry_row [T] int32, each token's chunk-local
    entry row (-1 before its first hop in the chunk); v [C] bool, the
    chunk's valid CURRENT rows; batch_ts [C] int64; ev: {attr: [C]} the
    slot's stream columns; cond: the slot's condition, broadcastable to
    [T, C] (None: true) — a row-only condition stays [1, C]; overflow: 0-d
    bool. tail: the count route's tail slots (no `every`, sequence or
    `within`, start_ts untouched). Returns (tok', entry_row', overflow')."""
    if batch_ts.device.type == "cpu":
        return pattern_advance_ref(prog, p, tok, entry_row, v, batch_ts, ev, cond, overflow, tail)
    atom = prog.slots[p].atoms[0]
    _keep, ts_used = prog.capture_keep()
    cr = tok["caps"][atom.ref_idx]
    lanes_in = [tok["active"], tok["slot"], tok["start_ts"], tok["entry_ts"], entry_row, cr["n"]]
    kernels.require_cuda("pattern_advance", *lanes_in, v, batch_ts, overflow,
                         *[ev[n] for n in cr["cols"]])
    T, C = tok["active"].shape[0], batch_ts.shape[0]
    if v.shape != (C,) or any(x.shape != (T,) for x in lanes_in):
        raise ValueError(f"pattern_advance: [{T}] token lanes and [{C}] rows expected")
    dev = batch_ts.device
    fork, strict, win = prog._pass_kind(p, tail)
    c, cst, csc = _cond_view(cond, dev)
    if c.dtype != torch.bool or c.shape[0] not in (1, T) or c.shape[1] not in (1, C):
        raise ValueError(f"pattern_advance: condition {list(c.shape)} does not broadcast to "
                         f"[{T}, {C}]")
    out = [torch.empty_like(x) for x in lanes_in]
    src = torch.empty(T, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * T if fork else 1, dtype=torch.int32, device=dev)
    ovf = _flag_out(overflow)
    gathered = []  # (column name or None for the timestamps, old lane, source lane)
    if ts_used[atom.ref_idx]:
        gathered.append((None, cr["ts"], batch_ts))
    for name, arr in cr["cols"].items():
        if arr.dtype != ev[name].dtype:
            raise ValueError(f"pattern_advance: capture lane {name} is {arr.dtype}, "
                             f"the column {ev[name].dtype}")
        gathered.append((name, arr, ev[name]))
    new_lanes = {name: torch.empty_like(arr) for name, arr, _s in gathered}
    L = _Lanes({
        "old": (ctypes.c_void_p, [arr.data_ptr() for _n, arr, _s in gathered]),
        "src": (ctypes.c_void_p, [s.data_ptr() for _n, _a, s in gathered]),
        "out": (ctypes.c_void_p, [new_lanes[n].data_ptr() for n, _a, _s in gathered]),
        "size": (ctypes.c_int, [arr.element_size() for _n, arr, _s in gathered]),
    })
    kernels.check(kernels.function("pa_step")(
        *[x.data_ptr() for x in lanes_in], v.data_ptr(), batch_ts.data_ptr(), c.data_ptr(),
        cst, csc, T, C, p, int(fork), int(strict), int(not tail), int(win is not None),
        0 if win is None else int(win), *[x.data_ptr() for x in out], src.data_ptr(),
        scratch.data_ptr(), overflow.data_ptr(), ovf.data_ptr(), L.n, L["old"], L["src"],
        L["out"], L["size"], kernels.stream()), "pattern_advance")
    kernels.launches["pattern_advance"] += 1
    caps = list(tok["caps"])
    ncr = {"n": out[5], "ts": new_lanes.get(None, cr["ts"]),
           "cols": {name: new_lanes[name] for name in cr["cols"]}}
    caps[atom.ref_idx] = ncr
    new_tok = {**tok, "active": out[0], "slot": out[1], "start_ts": out[2], "entry_ts": out[3],
               "caps": caps}
    return new_tok, out[4], ovf


# ---------------------------------------------------------------------------
# K14: the closed-form count pass (slots 0 and 1)
# ---------------------------------------------------------------------------


def pattern_count_ref(prog: "PatternProgram", tok: dict, Mc, Madv, batch_ts, ev0, ev1, overflow):
    """Plain version of `pattern_count`, in the JAX package's formulation
    (apply_batch_count :1406-1645): cumsum ranks, first_indices, a reverse
    cummin, searchsorted and the generation chain's scatters."""
    T = prog.T
    C = batch_ts.shape[0]
    dev = batch_ts.device
    slot0, slot1 = prog.slots[0], prog.slots[1]
    atom0, atom1 = slot0.atoms[0], slot1.atoms[0]
    _keep, ts_used = prog.capture_keep()
    K, m = atom0.cap, slot0.min_count
    Mx = slot0.max_count if slot0.max_count > 0 else _UNBOUNDED
    i32 = torch.int32
    rows = torch.arange(C, dtype=i32, device=dev)
    qpos = torch.arange(K, dtype=i32, device=dev)
    at0 = tok["active"] & (tok["slot"] == 0)
    n0 = tok["caps"][atom0.ref_idx]["n"]

    mci = Mc.to(i32)
    midx_excl = torch.cumsum(mci, 0, dtype=i32) - mci
    k_total = midx_excl[-1] + mci[-1]
    mrow_c = first_indices(Mc, C, fill=C).clamp(0, C - 1).long()
    mts = batch_ts[mrow_c]

    room = (Mx - n0.clamp(0, Mx)).to(i32)
    thresh = (m - n0.clamp(0, m)).to(i32)
    madv_next = torch.flip(torch.cummin(torch.flip(torch.where(Madv, rows, C), [0]), 0).values,
                           [0]).to(i32)
    b0_t = torch.searchsorted(midx_excl, thresh, side="left").to(i32)
    jt = torch.where(b0_t < C, madv_next[b0_t.clamp(0, C - 1).long()], C)
    has_adv = at0 & (jt < C)
    j = jt.to(i32)
    jc = j.clamp(0, C - 1).long()
    A = torch.where(has_adv, midx_excl[jc], k_total).clamp(min=0)
    A = torch.minimum(A, room)
    A = torch.where(at0, A, 0)

    caps = [dict(c) for c in tok["caps"]]
    src = qpos[None, :] - n0[:, None]
    wmask = at0[:, None] & (src >= 0) & (src < A[:, None])
    srcc = src.clamp(0, C - 1).long()
    cr = caps[atom0.ref_idx]
    cr["n"] = torch.where(at0, n0 + A, n0).to(cr["n"].dtype)
    if ts_used[atom0.ref_idx]:
        cr["ts"] = torch.where(wmask, mts[srcc], cr["ts"])
    if ev0 is not None:
        cr["cols"] = {name: torch.where(wmask, ev0[name][mrow_c][srcc], arr)
                      for name, arr in cr["cols"].items()}
    start_ts = torch.where(at0 & (tok["start_ts"] < 0) & (A > 0), mts[0], tok["start_ts"])

    advD = at0 & has_adv
    if ev1 is not None:
        c1 = caps[atom1.ref_idx]
        c1["n"] = torch.where(advD, torch.ones_like(c1["n"]), c1["n"])
        if ts_used[atom1.ref_idx]:
            c1["ts"] = _with_col0(c1["ts"], torch.where(advD, batch_ts[jc], c1["ts"][:, 0]))
        c1["cols"] = {name: _with_col0(arr, torch.where(advD, ev1[name][jc], arr[:, 0]))
                      for name, arr in c1["cols"].items()}
    entry_row = torch.where(advD, j, -1)
    tok = {
        "active": tok["active"],
        "slot": torch.where(advD, torch.full_like(tok["slot"], 2), tok["slot"]),
        "start_ts": start_ts,
        "entry_ts": torch.where(advD, batch_ts[jc], tok["entry_ts"]),
        "caps": caps,
    }

    if slot0.persistent:
        tail = at0 & (n0 < m)
        tail_exists = tail.any()
        ny = torch.where(tail, n0, m).min().to(i32)
        Gmax = min(C // max(m, 1) + 1, T)
        g = torch.arange(Gmax, dtype=i32, device=dev)
        s_g = (m - ny) + g * m
        valid_g = tail_exists & (s_g <= k_total)
        overflow = overflow | (tail_exists & ((m - ny) + Gmax * m <= k_total))
        b0_g = torch.searchsorted(midx_excl, (s_g + m).to(i32), side="left").to(i32)
        jg_row = torch.where(b0_g < C, madv_next[b0_g.clamp(0, C - 1).long()], C)
        has_advg = valid_g & (jg_row < C)
        jg = jg_row.to(i32)
        jgc = jg.clamp(0, C - 1).long()
        Ag = (torch.where(has_advg, midx_excl[jgc], k_total) - s_g).clamp(0, Mx)
        Ag = torch.where(valid_g, Ag, 0)

        free = ~tok["active"]
        nfree = free.sum()
        free_idx = first_indices(free, Gmax)
        grank = (torch.cumsum(valid_g.to(i32), 0) - 1).to(i32)
        gsel = free_idx[grank.clamp(0, Gmax - 1).long()]
        okg = valid_g & (grank < nfree) & (gsel >= 0)
        overflow = overflow | (valid_g & ~okg).any()
        dst = torch.where(okg, gsel, T)

        src_g = s_g[:, None] + qpos[None, :]
        wm_g = qpos[None, :] < Ag[:, None]
        src_gc = src_g.clamp(0, C - 1).long()
        caps = [dict(c) for c in tok["caps"]]
        cr = caps[atom0.ref_idx]
        cr["n"] = set_at(cr["n"], dst, Ag)
        zero64 = torch.zeros((), dtype=torch.int64, device=dev)
        if ts_used[atom0.ref_idx]:
            cr["ts"] = set_at(cr["ts"], dst, torch.where(wm_g, mts[src_gc], zero64))
        if ev0 is not None:
            types0 = prog.schemas[atom0.stream_id].attr_types
            cr["cols"] = {
                name: set_at(arr, dst, torch.where(wm_g, ev0[name][mrow_c][src_gc],
                                                   _null_of(types0[name], arr)))
                for name, arr in cr["cols"].items()}
        if ev1 is not None:
            c1 = caps[atom1.ref_idx]
            c1["n"] = set_at(c1["n"], dst, has_advg.to(c1["n"].dtype))
            if ts_used[atom1.ref_idx]:
                c1["ts"] = _with_col0(c1["ts"], set_at(
                    c1["ts"][:, 0], dst, torch.where(has_advg, batch_ts[jgc], zero64)))
            types1 = prog.schemas[atom1.stream_id].attr_types
            c1["cols"] = {
                name: _with_col0(arr, set_at(arr[:, 0], dst, torch.where(
                    has_advg, ev1[name][jgc], _null_of(types1[name], arr))))
                for name, arr in c1["cols"].items()}
        written = {atom0.ref_idx} | ({atom1.ref_idx} if ev1 is not None else set())
        for ridx, a in enumerate(prog.refs):
            if ridx in written:
                continue
            c = caps[ridx]
            c["n"] = set_at(c["n"], dst, torch.zeros((), dtype=c["n"].dtype, device=dev))
            if ts_used[ridx]:
                c["ts"] = set_at(c["ts"], dst, torch.zeros(dst.shape + c["ts"].shape[1:],
                                                           dtype=torch.int64, device=dev))
            types = prog.schemas[a.stream_id].attr_types
            c["cols"] = {name: set_at(arr, dst, _null_of(types[name], arr).expand(
                             dst.shape + arr.shape[1:]))
                         for name, arr in c["cols"].items()}
        g_start = torch.where(Ag > 0, mts[s_g.clamp(0, C - 1).long()],
                              torch.full((), -1, dtype=torch.int64, device=dev))
        tok = {
            "active": set_at(tok["active"], dst, torch.ones((), dtype=torch.bool, device=dev)),
            "slot": set_at(tok["slot"], dst, torch.where(has_advg, 2, 0).to(i32)),
            "start_ts": set_at(tok["start_ts"], dst, g_start),
            "entry_ts": set_at(tok["entry_ts"], dst, mts[(s_g - 1).clamp(0, C - 1).long()]),
            "caps": caps,
        }
        entry_row = set_at(entry_row, dst, torch.where(has_advg, jg, -1))
    return tok, entry_row.to(i32), overflow


def _null_of(t: AttrType, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(null_value(t), dtype=like.dtype, device=like.device)


def pattern_count(prog: "PatternProgram", tok: dict, Mc, Madv, batch_ts, ev0, ev1, overflow):
    """The count route's pass over slots 0 and 1 for one chunk (see
    csrc/pattern_count.cu): Mc / Madv [C] bool, slot 0's and slot 1's
    row-only conditions with the valid CURRENT rows; ev0 / ev1 the two
    slots' stream columns (None when this step's stream is not theirs).
    Returns (tok', entry_row [T] int32, overflow')."""
    if batch_ts.device.type == "cpu":
        return pattern_count_ref(prog, tok, Mc, Madv, batch_ts, ev0, ev1, overflow)
    T, C = prog.T, batch_ts.shape[0]
    slot0, slot1 = prog.slots[0], prog.slots[1]
    atom0, atom1 = slot0.atoms[0], slot1.atoms[0]
    _keep, ts_used = prog.capture_keep()
    K, m = atom0.cap, slot0.min_count
    Mx = slot0.max_count if slot0.max_count > 0 else _UNBOUNDED
    c0, c1 = tok["caps"][atom0.ref_idx], tok["caps"][atom1.ref_idx]
    lanes_in = [tok["active"], tok["slot"], tok["start_ts"], tok["entry_ts"], c0["n"], c1["n"]]
    kernels.require_cuda("pattern_count", Mc, Madv, batch_ts, overflow, *lanes_in)
    if Mc.shape != (C,) or Madv.shape != (C,) or any(x.shape != (T,) for x in lanes_in):
        raise ValueError(f"pattern_count: [{T}] token lanes and [{C}] rows expected")
    dev = batch_ts.device
    Gmax = min(C // max(m, 1) + 1, T)
    out = [torch.empty_like(x) for x in lanes_in[:4]]
    entry_row = torch.empty(T, dtype=torch.int32, device=dev)
    n0_o, n1_o = torch.empty_like(c0["n"]), torch.empty_like(c1["n"])
    scratch = torch.empty(3 * C + (K + 7) * T + 3, dtype=torch.int32, device=dev)
    ovf = _flag_out(overflow)

    # (lane key (ref, "n" | "ts" | "col", name), old, source, null bits,
    # index map): map 0 = idx0 per element of [T, K], 1 = idx1 per token,
    # 2 = the generation clear per token
    plan = []
    if ev0 is not None:
        types0 = prog.schemas[atom0.stream_id].attr_types
        if ts_used[atom0.ref_idx]:
            plan.append(((atom0.ref_idx, "ts", None), c0["ts"], batch_ts, 0, 0))
        for name, arr in c0["cols"].items():
            plan.append(((atom0.ref_idx, "col", name), arr, ev0[name],
                         _null_bits(types0[name]), 0))
    if ev1 is not None:
        types1 = prog.schemas[atom1.stream_id].attr_types
        if ts_used[atom1.ref_idx]:
            plan.append(((atom1.ref_idx, "ts", None), c1["ts"], batch_ts, 0, 1))
        for name, arr in c1["cols"].items():
            plan.append(((atom1.ref_idx, "col", name), arr, ev1[name],
                         _null_bits(types1[name]), 1))
    if slot0.persistent:
        written = {atom0.ref_idx} | ({atom1.ref_idx} if ev1 is not None else set())
        for ridx, a in enumerate(prog.refs):
            if ridx in written:
                continue
            c = tok["caps"][ridx]
            plan.append(((ridx, "n", None), c["n"], c["n"], 0, 2))
            if ts_used[ridx]:
                plan.append(((ridx, "ts", None), c["ts"], c["ts"], 0, 2))
            types = prog.schemas[a.stream_id].attr_types
            for name, arr in c["cols"].items():
                plan.append(((ridx, "col", name), arr, arr, _null_bits(types[name]), 2))
    for _k, old, srcl, _nb, _mp in plan:
        if srcl.dtype != old.dtype:
            raise ValueError(f"pattern_count: lane {_k} is {old.dtype}, its source {srcl.dtype}")
    new_lanes = [torch.empty_like(old) for _k, old, _s, _nb, _mp in plan]
    L = _Lanes({
        "old": (ctypes.c_void_p, [old.data_ptr() for _k, old, _s, _nb, _mp in plan]),
        "src": (ctypes.c_void_p, [s.data_ptr() for _k, _o, s, _nb, _mp in plan]),
        "out": (ctypes.c_void_p, [x.data_ptr() for x in new_lanes]),
        "size": (ctypes.c_int, [old.element_size() for _k, old, _s, _nb, _mp in plan]),
        "width": (ctypes.c_int, [old.shape[1] if old.dim() == 2 else 1
                                 for _k, old, _s, _nb, _mp in plan]),
        "map": (ctypes.c_int, [mp for _k, _o, _s, _nb, mp in plan]),
        "null": (ctypes.c_longlong, [nb for _k, _o, _s, nb, _mp in plan]),
    })
    kernels.check(kernels.function("pc_step")(
        Mc.data_ptr(), Madv.data_ptr(), batch_ts.data_ptr(), *[x.data_ptr() for x in lanes_in[:4]],
        c0["n"].data_ptr(), c1["n"].data_ptr(), T, C, K, m, Mx, int(slot0.persistent),
        int(ev1 is not None), Gmax, *[x.data_ptr() for x in out], entry_row.data_ptr(),
        n0_o.data_ptr(), n1_o.data_ptr(), scratch.data_ptr(), overflow.data_ptr(), ovf.data_ptr(),
        L.n, L["old"], L["src"], L["out"], L["size"], L["width"], L["map"], L["null"],
        kernels.stream()), "pattern_count")
    kernels.launches["pattern_count"] += 1
    new_of = {k: x for (k, *_r), x in zip(plan, new_lanes)}
    caps = []
    for ridx, c in enumerate(tok["caps"]):
        n = n0_o if ridx == atom0.ref_idx else (
            n1_o if ridx == atom1.ref_idx and ev1 is not None
            else new_of.get((ridx, "n", None), c["n"]))
        caps.append({"n": n, "ts": new_of.get((ridx, "ts", None), c["ts"]),
                     "cols": {name: new_of.get((ridx, "col", name), arr)
                              for name, arr in c["cols"].items()}})
    new_tok = {**tok, "active": out[0], "slot": out[1], "start_ts": out[2], "entry_ts": out[3],
               "caps": caps}
    return new_tok, entry_row, ovf


# ---------------------------------------------------------------------------
# K15: completions into the emission buffer, and the within purge
# ---------------------------------------------------------------------------


def _emit_lanes(prog: "PatternProgram", tok: dict, out: dict):
    """(token lane, emission lane) pairs the emit copies, per ref."""
    pairs = []
    for a in prog.refs:
        c = tok["caps"][a.ref_idx]
        pairs.append((c["n"], out[f"n{a.ref_idx}"]))
        if f"ts{a.ref_idx}" in out:
            pairs.append((c["ts"], out[f"ts{a.ref_idx}"]))
        for name in c["cols"]:
            pairs.append((c["cols"][name], out[f"c{a.ref_idx}.{name}"]))
    return pairs


def pattern_emit_ref(prog: "PatternProgram", tok: dict, entry_row, batch_ts, v, now, out: dict,
                     out_n, overflow, purge: bool):
    """Plain version of `pattern_emit`, in the JAX package's formulation:
    an argsort of the completion keys, a cumsum rank, scatters into the
    emission lanes (in place here), then the purge."""
    T = tok["active"].shape[0]
    C = batch_ts.shape[0]
    S = len(prog.slots)
    dev = batch_ts.device
    done = tok["active"] & (tok["slot"] == S)
    cap = out["valid"].shape[0]
    toks = torch.arange(T, dtype=torch.int64, device=dev)
    key = torch.where(done, entry_row.to(torch.int64) * T + toks,
                      torch.full((), 1 << 60, dtype=torch.int64, device=dev))
    order = torch.argsort(key, stable=True)
    d_sorted = done[order]
    di = d_sorted.to(torch.int32)
    rank = torch.cumsum(di, 0, dtype=torch.int32) - di
    dest = torch.where(d_sorted & (out_n + rank < cap), out_n + rank, cap)
    overflow = overflow | (d_sorted & (out_n + rank >= cap)).any()
    er = entry_row[order]
    emit_ts = torch.where(er >= 0, batch_ts[er.clamp(0, C - 1).long()], now)
    live = dest < cap
    d = dest[live].long()
    s = order[live]
    out["ts"][d] = emit_ts[live]
    out["valid"][d] = True
    for src, dst in _emit_lanes(prog, tok, out):
        dst[d] = src[s]
    out_n.copy_(torch.clamp(out_n + done.sum(dtype=torch.int32), max=cap))
    active = tok["active"] & ~done
    if purge:
        last_ts = torch.where(v, batch_ts, 0).max()
        win_t = prog.win_by_slot(dev)[tok["slot"].clamp(0, S).long()]
        started = tok["start_ts"] >= 0
        expired = started & (last_ts - tok["start_ts"] > win_t)
        armer = (toks == 0) & bool(prog.slots[0].persistent)
        active = active & ~(expired & ~armer)
    return {**tok, "active": active}, out, out_n, overflow


def pattern_emit(prog: "PatternProgram", tok: dict, entry_row, batch_ts, v, now, out: dict,
                 out_n, overflow, purge: bool):
    """Move the chunk's completed tokens (active at slot S) into the
    emission buffer at out_n + their rank in (completion row, lane) order,
    up to its capacity (the overflow flag past it), and out of the token
    table; with purge (the fast route), drop the tokens whose `within`
    expired by the chunk's last valid row, the arming token kept. `out` and
    out_n (0-d int32) are updated in place; returns (tok', out, out_n,
    overflow'). See csrc/pattern_emit.cu."""
    if batch_ts.device.type == "cpu":
        return pattern_emit_ref(prog, tok, entry_row, batch_ts, v, now, out, out_n, overflow,
                                purge)
    T, C = tok["active"].shape[0], batch_ts.shape[0]
    S = len(prog.slots)
    dev = batch_ts.device
    pairs = _emit_lanes(prog, tok, out)
    kernels.require_cuda("pattern_emit", tok["active"], tok["slot"], tok["start_ts"], entry_row,
                         batch_ts, v, now, out["ts"], out["valid"], out_n, overflow,
                         *[x for pr in pairs for x in pr])
    cap = out["valid"].shape[0]
    for src, dst in pairs:
        if src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:] or dst.shape[0] != cap:
            raise ValueError("pattern_emit: emission lanes do not match the token lanes")
    active = torch.empty_like(tok["active"])
    ovf = _flag_out(overflow)
    scratch = torch.empty(2 * T + 2, dtype=torch.int32, device=dev)
    L = _Lanes({
        "src": (ctypes.c_void_p, [s.data_ptr() for s, _d in pairs]),
        "dst": (ctypes.c_void_p, [d.data_ptr() for _s, d in pairs]),
        "size": (ctypes.c_int, [s.element_size() for s, _d in pairs]),
        "width": (ctypes.c_int, [s.shape[1] if s.dim() == 2 else 1 for s, _d in pairs]),
    })
    kernels.check(kernels.function("pe_emit")(
        tok["active"].data_ptr(), tok["slot"].data_ptr(), tok["start_ts"].data_ptr(),
        entry_row.data_ptr(), T, S, batch_ts.data_ptr(), v.data_ptr(), C, now.data_ptr(),
        out["ts"].data_ptr(), out["valid"].data_ptr(), cap, out_n.data_ptr(), overflow.data_ptr(),
        ovf.data_ptr(), active.data_ptr(), int(purge), prog.win_by_slot(dev).data_ptr(),
        int(prog.slots[0].persistent), scratch.data_ptr(), L.n, L["src"], L["dst"], L["size"],
        L["width"], kernels.stream()), "pattern_emit")
    kernels.launches["pattern_emit"] += 1
    return {**tok, "active": active}, out, out_n, ovf


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class PatternProgram:
    """Compiled NFA: slot chain + per-atom conditions + token-table layout."""

    def __init__(self, state_stream: StateInputStream, schemas: dict[str, StreamSchema],
                 interner: InternTable, device, token_capacity: int = DEFAULT_TOKEN_CAPACITY,
                 count_capacity: int = DEFAULT_COUNT_CAPACITY):
        self.sequence = state_stream.type is StateStreamType.SEQUENCE
        self.within_ms = state_stream.within_ms
        self.T = token_capacity
        self.schemas = schemas
        self.interner = interner
        self.device = torch.device(device)

        self.slots: list[Slot] = []
        self.refs: list[Atom] = []
        self.every_blocks: list[tuple[int, int]] = []
        _flatten_state(state_stream.state, self.slots, self.refs, schemas, count_capacity,
                       self.every_blocks)
        if not self.slots:
            raise SiddhiAppCreationError("empty pattern")

        # name-resolution scope over every ref (reference: each state's
        # MatchingMetaInfoHolder exposes all earlier stream events)
        self.scope = Scope(interner, self.device)
        for a in self.refs:
            self.scope.add_stream(a.ref, schemas[a.stream_id].attr_types)
        self.scope.default_ref = self.refs[0].ref

        # per-atom conditions (the AND of its filters, the current event as
        # the atom's own ref) and the keys each reads
        self._conds = {}
        self._cond_keys: dict[tuple, set] = {}
        for slot in self.slots:
            for atom in slot.atoms:
                conds = []
                keys: set = set()
                for f in atom.filters:
                    s = self.scope.child()
                    s.default_ref = atom.ref
                    s.prefer_default = True
                    c = compile_expression(f, s)
                    if c.type is not AttrType.BOOL:
                        raise SiddhiAppCreationError("pattern filter must be boolean")
                    conds.append(c)
                    keys |= s.used_keys
                self._conds[(slot.index, atom.ref_idx)] = conds
                self._cond_keys[(slot.index, atom.ref_idx)] = keys

        self.stream_ids = sorted({a.stream_id for a in self.refs})
        self.needs_scheduler = any(a.waiting_ms is not None for a in self.refs)
        # keys read from the emission buffer (selector), set by the owning
        # runtime; None keeps every capture lane
        self._capture_readers: Optional[frozenset] = None
        self._keep_cache = None
        self._win_t: dict = {}

    # ---- capture projection ---------------------------------------------

    def set_capture_readers(self, keys: frozenset) -> None:
        """Declare the emission-buffer reader keys (the selector's); must run
        before capture_keep() is first called."""
        if self._keep_cache is not None:
            raise RuntimeError("capture_keep() ran before set_capture_readers()")
        self._capture_readers = frozenset(keys)

    def capture_keep(self):
        """Per-ref projection of the capture lanes: (keep_cols, ts_used) —
        the attributes some expression reads from captures (indexed keys,
        the selector's keys, cross-ref condition reads) and whether the
        ref's captured-timestamp lane is read. Same rule as the JAX
        package's, so both keep the same lanes."""
        if self._keep_cache is not None:
            return self._keep_cache
        used = set(self.scope.root_used_keys())
        by_ref = {a.ref: a for a in self.refs}
        if self._capture_readers is None:
            needed = used
        else:
            cross = set()
            for (_slot_idx, ref_idx), keys in self._cond_keys.items():
                me = self.refs[ref_idx].ref
                cross |= {k for k in keys if k[0] != me}
            needed = {k for k in used if k[1] is not None} | set(self._capture_readers) | cross
        keep_cols = {a.ref_idx: set() for a in self.refs}
        ts_used = {a.ref_idx: bool(a.absent and a.waiting_ms is not None) for a in self.refs}
        for ref, _k, attr in needed:
            a = by_ref.get(ref)
            if a is None:
                continue
            if attr == TS_ATTR:
                ts_used[a.ref_idx] = True
            elif attr in self.schemas[a.stream_id].attr_types:
                keep_cols[a.ref_idx].add(attr)
        self._keep_cache = (keep_cols, ts_used)
        return self._keep_cache

    # ---- token table ----------------------------------------------------

    def init_state(self, now: int = 0) -> dict:
        T = self.T
        dev = self.device
        keep_cols, _ts_used = self.capture_keep()
        caps = []
        for a in self.refs:
            schema = self.schemas[a.stream_id]
            cols = {name: torch.full((T, a.cap), null_value(t), dtype=PHYSICAL_DTYPE[t],
                                     device=dev)
                    for name, t in schema.attrs if name in keep_cols[a.ref_idx]}
            caps.append({"n": torch.zeros(T, dtype=torch.int32, device=dev),
                         "ts": torch.zeros((T, a.cap), dtype=torch.int64, device=dev),
                         "cols": cols})
        active = torch.zeros(T, dtype=torch.bool, device=dev)
        active[0] = True
        entry_ts = torch.zeros(T, dtype=torch.int64, device=dev)
        entry_ts[0] = now
        return {
            "active": active,
            "slot": torch.zeros(T, dtype=torch.int32, device=dev),
            # -1 == virgin (no event captured yet); 0 is a legitimate epoch ts
            "start_ts": torch.full((T,), -1, dtype=torch.int64, device=dev),
            "entry_ts": entry_ts,
            "caps": caps,
        }

    # ---- environments ----------------------------------------------------

    def _synth_capture_cols(self, cols, col_of, ts_of, n_of, expand=None, keys=None):
        """Columns for used capture keys outside the stored range: e1[k] with
        k >= cap reads null, e1[last] / e1[last-i] gather by the live count
        (reference: StateEvent.getStreamEvent(position)). `keys` limits them
        to a subset of the used keys."""
        by_ref = {a.ref: a for a in self.refs}
        for key in self.scope.root_used_keys() if keys is None else keys:
            ref, k, attr = key
            a = by_ref.get(ref)
            if a is None or k is None or key in cols:
                continue
            n = n_of(a)
            if attr == "__arrived__":
                col = (n > k) if k >= 0 else (n >= -k)
            else:
                if attr == TS_ATTR:
                    arr = ts_of(a)
                    nv = null_value(AttrType.LONG)
                else:
                    t = self.schemas[a.stream_id].attr_types.get(attr)
                    if t is None:
                        continue
                    arr = col_of(a, attr)
                    nv = null_value(t)
                if k >= a.cap:
                    col = torch.full(arr.shape[:1], nv, dtype=arr.dtype, device=arr.device)
                elif k >= 0:
                    col = arr[:, k]
                else:
                    idx = n + k  # last == -1 -> n-1, last-i -> n-1-i
                    col = torch.full(arr.shape[:1], nv, dtype=arr.dtype, device=arr.device)
                    for i in range(a.cap):
                        col = torch.where(idx == i, arr[:, i], col)
            cols[key] = expand(col) if expand else col

    def _row_env(self, ev: dict, batch_ts, now, atom: Atom) -> Env:
        """[C]-shaped env exposing only the current event as the atom's ref."""
        cols = {(atom.ref, None, name): v for name, v in ev.items()}
        cols[(atom.ref, None, TS_ATTR)] = batch_ts
        cols[(atom.ref, None, "__arrived__")] = torch.ones(batch_ts.shape, dtype=torch.bool,
                                                           device=batch_ts.device)
        return Env(cols, now=now)

    def _matrix_env(self, tok, row_cols: dict, row_ts, now, override_ref: int,
                    keys=None) -> Env:
        """[T, 1] token columns against [1, C] row columns: a condition that
        reads only the row stays [1, C]. With `keys`, only those columns are
        formed (each is a view or one small op, paid per chunk)."""
        def want(k):
            return keys is None or k in keys

        cols = {}
        for a in self.refs:
            c = tok["caps"][a.ref_idx]
            for k in ((a.ref, None, TS_ATTR), (a.ref, 0, TS_ATTR)):
                if want(k):
                    cols[k] = c["ts"][:, 0][:, None]
            for name in c["cols"]:
                for k in ((a.ref, None, name), (a.ref, 0, name)):
                    if want(k):
                        cols[k] = c["cols"][name][:, 0][:, None]
            if want((a.ref, None, "__arrived__")):
                cols[(a.ref, None, "__arrived__")] = (c["n"] > 0)[:, None]
        self._synth_capture_cols(
            cols,
            lambda a, attr: tok["caps"][a.ref_idx]["cols"][attr],
            lambda a: tok["caps"][a.ref_idx]["ts"],
            lambda a: tok["caps"][a.ref_idx]["n"],
            expand=lambda col: col[:, None],
            keys=keys,
        )
        a = self.refs[override_ref]
        for name, v in row_cols.items():
            cols[(a.ref, None, name)] = v[None, :]
            cols[(a.ref, 0, name)] = v[None, :]
        cols[(a.ref, None, TS_ATTR)] = row_ts[None, :]
        cols[(a.ref, 0, TS_ATTR)] = row_ts[None, :]
        if want((a.ref, None, "__arrived__")):
            cols[(a.ref, None, "__arrived__")] = torch.ones((1, 1), dtype=torch.bool,
                                                            device=row_ts.device)
        return Env(cols, now=now)

    def _slot_cond(self, p: int, tok, ev: dict, batch_ts, now):
        """Slot p's condition over the token table and the chunk's rows: the
        AND of its atom's filters at their own broadcast shape (None when it
        has none)."""
        atom = self.slots[p].atoms[0]
        conds = self._conds[(p, atom.ref_idx)]
        if not conds:
            return None
        env = self._matrix_env(tok, ev, batch_ts, now, atom.ref_idx,
                               self._cond_keys[(p, atom.ref_idx)])
        cond = None
        for c in conds:
            x = c(env)
            cond = x if cond is None else cond & x
        return cond

    # ---- routes ------------------------------------------------------------

    @property
    def fast_path_ok(self) -> bool:
        """Single-atom slots, no counts/absent/logical, `every` only at the
        arming slot, and no multi-stream sequence."""
        if self.every_blocks:
            return False
        for i, s in enumerate(self.slots):
            if len(s.atoms) != 1 or s.is_count or s.is_absent or s.logical:
                return False
            if s.persistent and i != 0:
                return False
            if s.atoms[0].cap != 1:
                return False
        if self.sequence and len({a.stream_id for a in self.refs}) > 1:
            return False
        return True

    @property
    def count_fast_ok(self) -> bool:
        """PATTERN type, slot 0 a count state (min >= 1, optionally `every`),
        simple single-atom tail slots, no within bounds, and row-only
        conditions for slots 0 and 1."""
        if self.sequence or len(self.slots) < 2 or self.within_ms is not None:
            return False
        if self.every_blocks:
            return False
        s0 = self.slots[0]
        if not s0.is_count or s0.min_count < 1 or s0.is_absent or s0.logical:
            return False
        for s in self.slots:
            if s.within_ms is not None:
                return False
        for s in self.slots[1:]:
            if (len(s.atoms) != 1 or s.is_count or s.is_absent or s.logical or s.persistent
                    or s.atoms[0].cap != 1):
                return False
        for p in (0, 1):
            ref = self.slots[p].atoms[0].ref
            keys = self._cond_keys[(p, self.slots[p].atoms[0].ref_idx)]
            if any(k[0] != ref or k[1] is not None for k in keys):
                return False
        return True

    def _pass_kind(self, p: int, tail: bool):
        """(fork, strict, within) of slot p's pass: the `every` fork at slot
        0, sequence strictness, the effective within bound (the count
        route's tail slots have none of them)."""
        if tail:
            return False, False, None
        slot = self.slots[p]
        fork = p == 0 and slot.persistent
        strict = self.sequence and not slot.persistent and p > 0
        return fork, strict, _min_within(slot.within_ms, self.within_ms)

    def win_by_slot(self, dev) -> torch.Tensor:
        """[S + 1] int64: each slot's effective within (int64 max: none)."""
        t = self._win_t.get(dev)
        if t is None:
            S = len(self.slots)
            w = np.full((S + 1,), np.iinfo(np.int64).max, dtype=np.int64)
            for p, slot in enumerate(self.slots):
                bound = _min_within(slot.within_ms, self.within_ms)
                if bound is not None:
                    w[p] = bound
            t = self._win_t[dev] = torch.from_numpy(w).to(dev)
        return t

    def apply_batch_fast(self, tok, batch_ts, batch_kind, batch_valid, stream_cols: dict, out,
                         out_n, overflow, now):
        """One pass per slot over a chunk of one stream's rows, then the
        completions and the within purge. `out` and out_n are updated in
        place."""
        T = self.T
        v = batch_valid & (batch_kind == KIND_CURRENT)
        entry_row = torch.full((T,), -1, dtype=torch.int32, device=batch_ts.device)
        for p, slot in enumerate(self.slots):
            atom = slot.atoms[0]
            ev = stream_cols.get(atom.stream_id)
            if ev is None:
                continue
            cond = self._slot_cond(p, tok, ev, batch_ts, now)
            tok, entry_row, overflow = pattern_advance(self, p, tok, entry_row, v, batch_ts, ev,
                                                       cond, overflow)
        return pattern_emit(self, tok, entry_row, batch_ts, v, now, out, out_n, overflow,
                            purge=True)

    def apply_batch_count(self, tok, batch_ts, batch_kind, batch_valid, stream_cols: dict, out,
                          out_n, overflow, now):
        """The count route over a chunk: slots 0 and 1 in closed form, the
        tail slots by the ordinary pass, then the completions."""
        C = batch_ts.shape[0]
        atom0, atom1 = self.slots[0].atoms[0], self.slots[1].atoms[0]
        v = batch_valid & (batch_kind == KIND_CURRENT)
        masks, evs = [], []
        for p, atom in ((0, atom0), (1, atom1)):
            ev = stream_cols.get(atom.stream_id)
            mask = torch.zeros(C, dtype=torch.bool, device=batch_ts.device)
            if ev is not None:
                env = self._row_env(ev, batch_ts, now, atom)
                mask = v
                for c in self._conds[(p, atom.ref_idx)]:
                    mask = mask & torch.broadcast_to(c(env), (C,))
            masks.append(mask)
            evs.append(ev)
        tok, entry_row, overflow = pattern_count(self, tok, masks[0], masks[1], batch_ts, evs[0],
                                                 evs[1], overflow)
        for p in range(2, len(self.slots)):
            atom = self.slots[p].atoms[0]
            ev = stream_cols.get(atom.stream_id)
            if ev is None:
                continue
            cond = self._slot_cond(p, tok, ev, batch_ts, now)
            tok, entry_row, overflow = pattern_advance(self, p, tok, entry_row, v, batch_ts, ev,
                                                       cond, overflow, tail=True)
        return pattern_emit(self, tok, entry_row, batch_ts, v, now, out, out_n, overflow,
                            purge=False)

    # ---- emission buffer ------------------------------------------------------

    def init_out(self, cap: int) -> dict:
        keep_cols, ts_used = self.capture_keep()
        dev = self.device
        out = {"ts": torch.zeros(cap, dtype=torch.int64, device=dev),
               "valid": torch.zeros(cap, dtype=torch.bool, device=dev)}
        for a in self.refs:
            schema = self.schemas[a.stream_id]
            out[f"n{a.ref_idx}"] = torch.zeros(cap, dtype=torch.int32, device=dev)
            if ts_used[a.ref_idx]:
                out[f"ts{a.ref_idx}"] = torch.zeros((cap, a.cap), dtype=torch.int64, device=dev)
            for name, t in schema.attrs:
                if name in keep_cols[a.ref_idx]:
                    out[f"c{a.ref_idx}.{name}"] = torch.full(
                        (cap, a.cap), null_value(t), dtype=PHYSICAL_DTYPE[t], device=dev)
        return out

    def out_env_cols(self, out: dict) -> dict:
        """VarKeys for the selector over the emission buffer (only the lanes
        capture_keep() kept exist)."""
        cols = {}
        for a in self.refs:
            for name in self.schemas[a.stream_id].attr_names:
                arr = out.get(f"c{a.ref_idx}.{name}")
                if arr is None:
                    continue
                cols[(a.ref, None, name)] = arr[:, 0]
                for k in range(a.cap):
                    cols[(a.ref, k, name)] = arr[:, k]
            tsr = out.get(f"ts{a.ref_idx}")
            if tsr is not None:
                cols[(a.ref, None, TS_ATTR)] = tsr[:, 0]
                for k in range(a.cap):
                    cols[(a.ref, k, TS_ATTR)] = tsr[:, k]
            cols[(a.ref, None, "__arrived__")] = out[f"n{a.ref_idx}"] > 0
        self._synth_capture_cols(
            cols,
            lambda a, attr: out[f"c{a.ref_idx}.{attr}"],
            lambda a: out[f"ts{a.ref_idx}"],
            lambda a: out[f"n{a.ref_idx}"],
        )
        return cols

    def next_timer(self, tok, after=None) -> int:
        """The earliest absent-state deadline: NO_TIMER, a host constant, for
        every pattern the batch routes take (none has a waiting absent
        state), so it costs no device read."""
        return NO_TIMER
