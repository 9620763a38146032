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

Every other pattern (logical and absent states, counts under `within` or
past the first state, multi-stream sequences, every-blocks) takes the
per-event scan route: `apply_event` applies one row to the token table, and
`pattern_scan` (csrc/pattern_scan.cu) runs a whole step's rows, data or one
TIMER row, in one launch. Filters split into row-only masks, evaluated over
the batch by the compiled closures, and token-dependent condition programs
(`CondProgram`), evaluated per token lane inside the scan.

Inside a partition each route runs keyed by partition slot over one [P*T]
token table (K34-K37 below, csrc/partition_pattern.cu and
csrc/pattern_scan.cu's keyed entry point): only the slots with rows, each
on its own lanes and rows, into its own stretch of the emission buffer.

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
from siddhi_tpu_torch.core.event import KIND_CURRENT, KIND_TIMER, StreamSchema
from siddhi_tpu_torch.core.executor import (
    _CMP,
    TS_ATTR,
    Env,
    Scope,
    _cast,
    _int_div,
    _int_rem,
    _notnull,
    compile_expression,
)
from siddhi_tpu_torch.core.types import (
    NUMERIC_TYPES,
    PHYSICAL_DTYPE,
    AttrType,
    InternTable,
    float_arith,
    flush_needed,
    flush_subnormal,
    mod_pow2_divisor,
    null_value,
    promote,
)
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
from siddhi_tpu_torch.query_api.expression import (
    Add,
    And,
    Compare,
    CompareOp,
    Constant,
    Divide,
    IsNull,
    Mod,
    Multiply,
    Not,
    Or,
    Subtract,
    Variable,
)

NO_TIMER = int(np.iinfo(np.int64).max)

DEFAULT_TOKEN_CAPACITY = 128
DEFAULT_COUNT_CAPACITY = 8

_UNBOUNDED = 1 << 30  # a count's max when `<m:>`: counting runs on past the captures

# Test hook: every pattern takes the per-event scan route (the batch routes'
# differential oracle, as the JAX package's FORCE_SCAN). Read when a pattern
# query is created.
FORCE_SCAN = False


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


def _count_plan(prog: "PatternProgram", tok: dict, ts, ev0, ev1) -> list:
    """The count pass's capture lanes (K14 and K35): (lane key (ref, "n" |
    "ts" | "col", name), lane, source, null bits, index map) — map 0: ref
    0's [T, K] captures of its matches, 1: ref 1's capture of its advance
    row, 2: a generation's cleared ref."""
    slot0, slot1 = prog.slots[0], prog.slots[1]
    atom0, atom1 = slot0.atoms[0], slot1.atoms[0]
    _keep, ts_used = prog.capture_keep()
    c0, c1 = tok["caps"][atom0.ref_idx], tok["caps"][atom1.ref_idx]
    plan = []
    if ev0 is not None:
        types0 = prog.schemas[atom0.stream_id].attr_types
        if ts_used[atom0.ref_idx]:
            plan.append(((atom0.ref_idx, "ts", None), c0["ts"], ts, 0, 0))
        for name, arr in c0["cols"].items():
            plan.append(((atom0.ref_idx, "col", name), arr, ev0[name],
                         _null_bits(types0[name]), 0))
    if ev1 is not None:
        types1 = prog.schemas[atom1.stream_id].attr_types
        if ts_used[atom1.ref_idx]:
            plan.append(((atom1.ref_idx, "ts", None), c1["ts"], ts, 0, 1))
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
    for k, old, srcl, _nb, _mp in plan:
        if srcl.dtype != old.dtype:
            raise ValueError(f"pattern_count: lane {k} is {old.dtype}, its source {srcl.dtype}")
    return plan


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

    plan = _count_plan(prog, tok, batch_ts, ev0, ev1)
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
# condition programs: the token-dependent filters of the scan route
# ---------------------------------------------------------------------------

# physical value types on a program's stack (csrc/prog.cuh, same codes)
TY_BOOL, TY_INT, TY_LONG, TY_FLOAT, TY_ID = 0, 1, 2, 3, 4
_TY = {AttrType.BOOL: TY_BOOL, AttrType.INT: TY_INT, AttrType.LONG: TY_LONG,
       AttrType.FLOAT: TY_FLOAT, AttrType.DOUBLE: TY_FLOAT, AttrType.STRING: TY_ID,
       AttrType.OBJECT: TY_ID}
_TY_NULL = {TY_BOOL: 0, TY_INT: int(null_value(AttrType.INT)),
            TY_LONG: int(null_value(AttrType.LONG)), TY_ID: 0}
_TY_DTYPE = {TY_BOOL: torch.bool, TY_INT: torch.int32, TY_LONG: torch.int64,
             TY_FLOAT: torch.float32, TY_ID: torch.int32}
# a type's stand-in logical type (the executor's helpers take logical types)
_TY_LOGICAL = {TY_BOOL: AttrType.BOOL, TY_INT: AttrType.INT, TY_LONG: AttrType.LONG,
               TY_FLOAT: AttrType.FLOAT, TY_ID: AttrType.STRING}

# opcodes: each instruction is (op, a, b, c, d)
# (OP_CAP is csrc/prog.cuh's OP_OPERAND: the token's capture in these programs)
OP_REG, OP_CONST, OP_CAP, OP_ARITH, OP_CMP, OP_AND, OP_OR, OP_NOT, OP_ISNULL = range(1, 10)
_ARITH_CODE = {Add: 0, Subtract: 1, Multiply: 2, Divide: 3, Mod: 4}
_ARITH_NAME = ("add", "sub", "mul", "div", "mod", "mod_pow2")
ARITH_MOD_POW2 = 5  # a float % by a constant power of two >= 1 (core/types.py float_arith)
_CMP_CODE = {CompareOp.LT: 0, CompareOp.LE: 1, CompareOp.GT: 2, CompareOp.GE: 3,
             CompareOp.EQ: 4, CompareOp.NEQ: 5}
_CMP_BY_CODE = {v: k for k, v in _CMP_CODE.items()}
K_NONE = 1 << 20  # an un-indexed capture read (e1.price: occurrence 0)
LANE_ARRIVED = -1  # OP_CAP's lane: the ref's arrival flag, not a capture lane
MAX_STACK = 16  # csrc/prog.cuh kMaxStack


@dataclasses.dataclass
class CondProgram:
    """One token-dependent filter of an atom, in postfix: `code` is a list
    of (op, a, b, c, d) instructions —
    - (OP_REG, r, ty): row register r (a capture-free subtree, evaluated
      over the batch by its compiled closure) at this row;
    - (OP_CONST, ty, bits): a constant (float32 as its bit pattern);
    - (OP_CAP, ref, k, lane, ty): the token's capture of ref — occurrence k
      (K_NONE: the first, -1 - i: `last - i`), capture lane `lane` of
      PatternProgram.cap_lanes() or LANE_ARRIVED — with the null rules of
      `_synth_capture_cols`;
    - (OP_ARITH, op, lt, rt, t): + - * / % in type t (the executor's
      `_arith`: promotion, Java integer division and remainder, fmod, float32
      subnormals as zeros; op ARITH_MOD_POW2: `arith_code`);
    - (OP_CMP, op, lt, rt, t): the six comparisons in common type t (-1:
      equality of two bools or ids), false on a null operand;
    - (OP_AND,), (OP_OR,), (OP_NOT,), (OP_ISNULL, ty)."""

    code: list


def _const_bits(value: torch.Tensor, ty: int) -> int:
    if ty == TY_FLOAT:
        return int(value.to(torch.float32).reshape(1).view(torch.int32)[0])
    return int(value)


def arith_code(expr, t: AttrType) -> int:
    """OP_ARITH's operation code for the arithmetic expr in type t (a float
    % by a constant power of two of at least 1: ARITH_MOD_POW2)."""
    if (isinstance(expr, Mod) and t in (AttrType.FLOAT, AttrType.DOUBLE)
            and isinstance(expr.right, Constant) and mod_pow2_divisor(expr.right.value)):
        return ARITH_MOD_POW2
    return _ARITH_CODE[type(expr)]


def _cmp_consts(code: list, i: int) -> tuple:
    """The values of OP_CMP code[i]'s operands where an OP_CONST pushed
    them (None: not a constant, or not known without a walk): b is
    code[i - 1]'s result, a code[i - 2]'s when code[i - 1] pushed a leaf."""
    def value(ins):
        if ins[0] != OP_CONST:
            return None
        return float(np.int32(ins[2]).view(np.float32)) if ins[1] == TY_FLOAT else ins[2]

    b = value(code[i - 1])
    a = value(code[i - 2]) if i >= 2 and code[i - 1][0] in (OP_REG, OP_CONST, OP_CAP) else None
    return a, b


def run_program(code: list, regs: list, const, operand, what: str = "condition program"):
    """Plain interpreter of a postfix program (csrc/prog.cuh's run_prog),
    with the executor's own operations (`_cast`, `_int_div`, `_int_rem`,
    fmod, `_notnull`, the comparison table) on each instruction: regs[r] is
    row register r, const(ty, bits) a constant, operand(ins) the value of an
    opcode-3 instruction (a token capture here, a table lane in
    ops/table.py's table programs), in any shapes that broadcast. Returns
    the value, broadcast."""
    stack = []
    for i, ins in enumerate(code):
        op = ins[0]
        if op == OP_REG:
            stack.append(regs[ins[1]])
        elif op == OP_CONST:
            stack.append(const(ins[1], ins[2]))
        elif op == OP_CAP:
            stack.append(operand(ins))
        elif op == OP_ARITH:
            _op, code_, _lt, _rt, t = ins
            b, a = stack.pop(), stack.pop()
            lt = _TY_LOGICAL[t]
            a, b = _cast(a, lt), _cast(b, lt)
            name = _ARITH_NAME[code_]
            if t == TY_FLOAT:
                # subnormals as zeros, as in the executor's `_arith`
                v = float_arith(name, a, b)
            elif name == "add":
                v = a + b
            elif name == "sub":
                v = a - b
            elif name == "mul":
                v = a * b
            elif name == "div":
                v = _int_div(a, b)
            else:
                v = _int_rem(a, b)
            stack.append(v)
        elif op == OP_CMP:
            _op, code_, lt, rt, t = ins
            b, a = stack.pop(), stack.pop()
            ok = _notnull(a, _TY_LOGICAL[lt]) & _notnull(b, _TY_LOGICAL[rt])
            if t >= 0:
                a, b = _cast(a, _TY_LOGICAL[t]), _cast(b, _TY_LOGICAL[t])
            # subnormals as zero, as in the executor's `_compare`
            ca, cb = _cmp_consts(code, i)
            a = flush_subnormal(a) if flush_needed(cb) else a
            b = flush_subnormal(b) if flush_needed(ca) else b
            stack.append(_CMP[_CMP_BY_CODE[code_]](a, b) & ok)
        elif op == OP_AND:
            b, a = stack.pop(), stack.pop()
            stack.append(a & b)
        elif op == OP_OR:
            b, a = stack.pop(), stack.pop()
            stack.append(a | b)
        elif op == OP_NOT:
            stack.append(~stack.pop())
        elif op == OP_ISNULL:
            v, ty = stack.pop(), ins[1]
            stack.append(~_notnull(v, _TY_LOGICAL[ty]))
        else:
            raise ValueError(f"{what}: opcode {op}")
    (res,) = stack
    return res


def cond_program_ref(prog: "PatternProgram", cp: CondProgram, tok: dict, regs_row: list):
    """Plain evaluator of a condition program over the [T] token lanes
    (`run_program` with the token's capture reads). regs_row[r] is row
    register r's value at this row (0-d). Returns [T] bool."""
    T = tok["active"].shape[0]
    lanes = prog.cap_lanes()
    dev = tok["active"].device

    def capture(ins):
        _op, r, k, lane, ty = ins
        c = tok["caps"][r]
        n = c["n"]
        if lane == LANE_ARRIVED:
            return n > 0 if k == K_NONE else (n > k) if k >= 0 else (n >= -k)
        _ref, name = lanes[lane]
        arr = c["ts"] if name is None else c["cols"][name]
        cap = arr.shape[1]
        if k == K_NONE or 0 <= k < cap:
            return arr[:, 0 if k == K_NONE else k]
        col = torch.full((T,), float("nan") if ty == TY_FLOAT else _TY_NULL[ty],
                         dtype=arr.dtype, device=arr.device)
        if k < 0:  # last - i: occurrence n - 1 - i
            for i in range(cap):
                col = torch.where(n + k == i, arr[:, i], col)
        return col

    res = run_program(cp.code, regs_row, lambda ty, bits: prog._const(ty, bits, dev), capture)
    return torch.broadcast_to(res, (T,))


# ---------------------------------------------------------------------------
# K16: the per-event scan over one step's rows
# ---------------------------------------------------------------------------


def pattern_scan_ref(prog: "PatternProgram", tok: dict, stream_id: Optional[str], batch_ts,
                     batch_kind, batch_valid, ev: dict, rmask, regs: list, out: dict, out_n,
                     overflow, timer_seen):
    """Plain version of `pattern_scan`: `apply_event` on each valid row in
    order (the JAX package's lax.scan body, pattern_runtime.py:228-266; an
    invalid row changes nothing there and is skipped here). The row scalars
    and the row masks are read to the host once; stream_id is not read (the
    row masks already hold other streams' refs off)."""
    ts_h = batch_ts.tolist()
    kind_h = batch_kind.tolist()
    valid_h = batch_valid.tolist()
    rm = rmask.cpu().numpy()
    seen = int(timer_seen)
    n = out_n.clone()
    for b in range(len(ts_h)):
        if not valid_h[b]:
            continue
        ev_row = {name: col[b] for name, col in ev.items()}
        tok, n, overflow = prog.apply_event(tok, ts_h[b], kind_h[b], ev_row, rm[:, b],
                                            [r[b] for r in regs], out, n, overflow, seen)
    out_n.copy_(n)
    return tok, out, out_n, overflow


def pattern_scan(prog: "PatternProgram", tok: dict, stream_id: Optional[str], batch_ts,
                 batch_kind, batch_valid, ev: dict, rmask, regs: list, out: dict, out_n,
                 overflow, timer_seen):
    """One scan step (see csrc/pattern_scan.cu): every row of the batch
    applied to the token table in order. stream_id: the batch's stream
    (None: a TIMER step); ev: its columns {attr: [B]} ({} on a TIMER step);
    rmask [R, B] bool and regs (each [B]) from `PatternProgram.scan_inputs`;
    out and out_n (0-d int32) the emission buffer, written in place;
    overflow 0-d bool; timer_seen 0-d int64, the max TIMER timestamp
    processed before the step. Returns (tok', out, out_n, overflow')."""
    if batch_ts.device.type == "cpu":
        return pattern_scan_ref(prog, tok, stream_id, batch_ts, batch_kind, batch_valid, ev,
                                rmask, regs, out, out_n, overflow, timer_seen)
    lanes = [tok["active"], tok["slot"], tok["start_ts"], tok["entry_ts"]]
    kernels.require_cuda("pattern_scan", *lanes, batch_ts, batch_kind, batch_valid, rmask,
                         out_n, overflow, timer_seen, *regs, *ev.values(), *out.values(),
                         *[x for c in tok["caps"] for x in (c["n"], c["ts"], *c["cols"].values())])
    tok, ovf = _scan_launch(prog, tok, stream_id, batch_ts, batch_kind, batch_valid, ev, rmask,
                            regs, out, out_n, overflow, timer_seen, kernels.function("ps_scan"),
                            kernels.stream())
    kernels.launches["pattern_scan"] += 1
    return tok, out, out_n, ovf


# the kernel's limits (csrc/pattern_scan.cu)
_SCAN_MAX_REFS, _SCAN_MAX_CAP_LANES, _SCAN_MAX_REGS, _SCAN_MAX_DESC = 16, 32, 16, 1024
_SCAN_SMEM_BYTES = 200 * 1024  # per-lane arrays above this go to global scratch
# K16's and K37's design steps (csrc/pattern_scan.cu OPT_*): 1 the passes
# over the live-lane list, 2 the row group sized to the live count, 4 the
# rows that cannot change the table skipped. Every subset gives the same
# result; all are on, and a timing tool may clear some to time each alone.
SCAN_OPT = 7


def _conjuncts(e):
    """The top-level operands of a chain of `and`s (the expression itself
    when it is no `and`)."""
    if isinstance(e, And):
        yield from _conjuncts(e.left)
        yield from _conjuncts(e.right)
    else:
        yield e


def scan_lane_bytes(T: int, R: int) -> int:
    """Bytes of the kernel's per-lane working arrays (its lane_bytes)."""
    t8 = (T + 7) // 8 * 8
    return t8 * (5 * 8 + (3 + 2 * R) * 4 + 10) + 4 * (3 * ((T + 31) // 32) + 2)


def _scan_launch(prog: "PatternProgram", tok: dict, stream_id: Optional[str], batch_ts, batch_kind,
                 batch_valid, ev: dict, rmask, regs: list, out: dict, out_n, overflow, timer_seen,
                 fn, stream, keyed=None):
    """Lay out K16's arguments and call the entry point `fn`: fresh output
    lanes for the token table, the emission buffer and out_n in place.
    Returns (tok', overflow'). keyed: K37's (P, used, rows, emission, timer
    seen per slot, the output table) for `pps_scan` over a [P*T] table,
    whose overflow flag is updated in place."""
    T, B, R = prog.T, batch_ts.shape[0], len(prog.refs)
    n_tok = T if keyed is None else keyed[0] * T
    dev = batch_ts.device
    desc = prog.scan_desc(dev)
    lanes = prog.cap_lanes()
    if (R > _SCAN_MAX_REFS or len(lanes) > _SCAN_MAX_CAP_LANES or len(regs) > _SCAN_MAX_REGS
            or desc.shape[0] > _SCAN_MAX_DESC):
        raise ValueError(f"pattern_scan: {R} refs, {len(lanes)} capture lanes, {len(regs)} row "
                         f"registers, {desc.shape[0]} descriptor words exceed the kernel's "
                         f"{_SCAN_MAX_REFS}, {_SCAN_MAX_CAP_LANES}, {_SCAN_MAX_REGS}, "
                         f"{_SCAN_MAX_DESC}")
    if rmask.shape != (R, B) or any(x.shape != (n_tok,) for x in
                                    (tok["active"], tok["slot"], tok["start_ts"], tok["entry_ts"])):
        raise ValueError(f"pattern_scan: [{n_tok}] token lanes and an [{R}, {B}] row mask "
                         "expected")
    if keyed is None:
        new = {k: torch.empty_like(tok[k]) for k in ("active", "slot", "start_ts", "entry_ts")}
        if "fwd" in tok:
            new["fwd"] = torch.empty_like(tok["fwd"])
        caps = [{"n": torch.empty_like(c["n"]), "ts": torch.empty_like(c["ts"]),
                 "cols": {k: torch.empty_like(v) for k, v in c["cols"].items()}}
                for c in tok["caps"]]
    else:
        new = {k: v for k, v in keyed[5].items() if k != "caps"}
        caps = keyed[5]["caps"]
    cl = []  # (in, out, ev, emit, stage, null bits, ref, size, is_ts)
    for ref_idx, name in lanes:
        a = prog.refs[ref_idx]
        old = tok["caps"][ref_idx]["ts"] if name is None else tok["caps"][ref_idx]["cols"][name]
        newl = caps[ref_idx]["ts"] if name is None else caps[ref_idx]["cols"][name]
        src = ev[name] if name is not None and a.stream_id == stream_id else None
        if src is not None and src.dtype != old.dtype:
            raise ValueError(f"pattern_scan: capture lane {name} is {old.dtype}, the column "
                             f"{src.dtype}")
        emit = (out.get(f"ts{ref_idx}") if name is None else out[f"c{ref_idx}.{name}"])
        nb = 0 if name is None else _null_bits(prog.schemas[a.stream_id].attr_types[name])
        cl.append((old, newl, src, emit, torch.empty_like(old), nb, ref_idx, old.element_size(),
                   int(name is None)))
    bytes_ = scan_lane_bytes(T, R)
    smem = bytes_ <= _SCAN_SMEM_BYTES
    scratch = torch.empty(1 if smem else bytes_ * (n_tok // T), dtype=torch.uint8, device=dev)
    ovf = _flag_out(overflow) if keyed is None else overflow

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    L = _Lanes({
        "n_in": (ctypes.c_void_p, [c["n"].data_ptr() for c in tok["caps"]]),
        "n_out": (ctypes.c_void_p, [c["n"].data_ptr() for c in caps]),
        "out_nref": (ctypes.c_void_p, [out[f"n{r}"].data_ptr() for r in range(R)]),
    })
    C = _Lanes({
        "in": (ctypes.c_void_p, [ptr(x[0]) for x in cl]),
        "out": (ctypes.c_void_p, [ptr(x[1]) for x in cl]),
        "ev": (ctypes.c_void_p, [ptr(x[2]) for x in cl]),
        "emit": (ctypes.c_void_p, [ptr(x[3]) for x in cl]),
        "stage": (ctypes.c_void_p, [ptr(x[4]) for x in cl]),
        "null": (ctypes.c_longlong, [x[5] for x in cl]),
        "ref": (ctypes.c_int, [x[6] for x in cl]),
        "size": (ctypes.c_int, [x[7] for x in cl]),
        "is_ts": (ctypes.c_int, [x[8] for x in cl]),
    })
    G = _Lanes({"reg": (ctypes.c_void_p, [r.data_ptr() for r in regs])})
    args = (desc.data_ptr(), desc.shape[0], T, B, R,
            tok["active"].data_ptr(), new["active"].data_ptr(), tok["slot"].data_ptr(),
            new["slot"].data_ptr(), tok["start_ts"].data_ptr(), new["start_ts"].data_ptr(),
            tok["entry_ts"].data_ptr(), new["entry_ts"].data_ptr(),
            ptr(tok.get("fwd")), ptr(new.get("fwd")), L["n_in"], L["n_out"], L["out_nref"],
            len(cl), C["in"], C["out"], C["ev"], C["emit"], C["stage"], C["null"], C["ref"],
            C["size"], C["is_ts"], batch_ts.data_ptr(), batch_kind.data_ptr(),
            batch_valid.data_ptr(), rmask.data_ptr(), len(regs), G["reg"],
            out["ts"].data_ptr(), out["valid"].data_ptr())
    if keyed is None:
        kernels.check(fn(*args, out["valid"].shape[0], out_n.data_ptr(), overflow.data_ptr(),
                         ovf.data_ptr(), timer_seen.data_ptr(), scratch.data_ptr(), int(smem),
                         SCAN_OPT, stream), "pattern_scan")
    else:
        p, used, rows, emis, seen, _new = keyed
        kernels.check(fn(*args, emis.out_cap, overflow.data_ptr(), scratch.data_ptr(), int(smem),
                         p, used.data_ptr(), rows.rowlist.data_ptr(), rows.slot_start.data_ptr(),
                         rows.timers.data_ptr(), rows.info.data_ptr(), emis.off.data_ptr(),
                         emis.cap.data_ptr(), emis.n.data_ptr(), seen.data_ptr(), SCAN_OPT,
                         stream),
                      "partition_pattern_scan")
    return {**new, "caps": caps}, ovf


# ---------------------------------------------------------------------------
# K34-K37: the routes keyed by partition slot
# ---------------------------------------------------------------------------
#
# Inside a partition the JAX package runs the whole pattern step once per
# partition lane under jax.vmap (siddhi_tpu/core/partition.py
# PartitionedPatternQueryRuntime._pstep_impl :326): lane p sees the batch
# with only its own rows, and every TIMER row, valid. The port keeps one
# [P*T] token table, slot q's lanes at q*T (`keyed_tok`), and runs only the
# slots that have rows: the batch routes chunk by chunk, a chunk being C
# rows of the whole batch as under the vmap (ops/partition.py
# `PatternChunks`: each chunk's member rows as (slot, rows) segments), the
# scan over each used slot's rows and every slot over the TIMER rows
# (the caller's `used`: the slots it steps). Completions go to
# each slot's own stretch of one emission buffer (`PatternEmission`), which
# ops/partition.py `pattern_place` flattens by (position, slot) after the
# step. The batch-route wrappers update the token table, the entry rows,
# the emission buffer and the overflow flag in place. Each `*_ref` twin
# runs the unpartitioned plain route once per slot with rows on that
# slot's lanes.


def _tok_map(tok: dict, f) -> dict:
    out = {k: f(v) for k, v in tok.items() if k != "caps"}
    out["caps"] = [{"n": f(c["n"]), "ts": f(c["ts"]),
                    "cols": {k: f(v) for k, v in c["cols"].items()}} for c in tok["caps"]]
    return out


def keyed_tok(tok: dict) -> dict:
    """A [P, T]-tiled token table as one [P*T] table (views of its lanes)."""
    return _tok_map(tok, lambda x: x.reshape((-1,) + tuple(x.shape[2:])))


def tiled_tok(tok: dict, p: int) -> dict:
    """A [P*T] token table as the [P, T]-tiled one (views)."""
    return _tok_map(tok, lambda x: x.reshape((p, -1) + tuple(x.shape[1:])))


def _slot_tok(tok: dict, q: int, T: int) -> dict:
    s = slice(q * T, (q + 1) * T)
    return _tok_map(tok, lambda x: x[s])


def _put_slot(tok: dict, q: int, T: int, sub: dict) -> None:
    s = slice(q * T, (q + 1) * T)
    for k, v in tok.items():
        if k != "caps":
            v[s] = sub[k]
    for c, sc in zip(tok["caps"], sub["caps"]):
        c["n"][s] = sc["n"]
        c["ts"][s] = sc["ts"]
        for k, v in c["cols"].items():
            v[s] = sc["cols"][k]


@dataclasses.dataclass
class PatternEmission:
    """One step's emissions inside a partition: slot q's rows, in the order
    of its own emission buffer, at rows [off[q], off[q] + cap[q]) of the
    `init_out` lanes `out`. n[q] counts the slot's emissions up to out_cap
    (the JAX package's per-lane buffer, whose overflow raises the flag);
    cap[q] <= out_cap of them are stored."""

    out: dict
    off: torch.Tensor  # [P] int64
    cap: torch.Tensor  # [P] int32
    n: torch.Tensor  # [P] int32
    out_cap: int

    def stretch(self, q: int):
        """(lanes, n) of slot q: views."""
        lo = int(self.off[q])
        hi = lo + int(self.cap[q])
        return {k: v[lo:hi] for k, v in self.out.items()}, self.n[q]


def keyed_out(prog: "PatternProgram", caps: torch.Tensor, out_cap: int) -> PatternEmission:
    """An emission buffer of caps[q] rows for slot q (one host read: the
    total)."""
    caps = caps.to(torch.int32)
    off = torch.cumsum(caps.to(torch.int64), 0) - caps.to(torch.int64)
    return PatternEmission(prog.init_out(max(int(caps.sum()), 1)), off, caps,
                           torch.zeros_like(caps), out_cap)


def _chunk_slots(ch, i: int):
    """(rows of chunk i, its member mask, their slots, the slots with rows)."""
    s = slice(i * ch.C, (i + 1) * ch.C)
    v, rs = ch.v[s], ch.slot[s]
    return s, v, rs, torch.unique(rs[v]).tolist()


def partition_pattern_advance_ref(prog: "PatternProgram", p: int, tok: dict, entry_row, ch,
                                  i: int, ev: dict, cond, overflow, tail: bool = False):
    """Plain version of `partition_pattern_advance`: `pattern_advance_ref`
    on each slot with rows in chunk i, its lanes and its rows."""
    T = prog.T
    s, v, rs, slots = _chunk_slots(ch, i)
    ts = ch.ts[s]
    evc = {n: a[s] for n, a in ev.items()}
    ovf = overflow.clone()
    for q in slots:
        cq = cond if cond is None or cond.dim() == 0 or cond.shape[0] == 1 else \
            cond[q * T:(q + 1) * T]
        new, er, ovf = pattern_advance_ref(prog, p, _slot_tok(tok, q, T),
                                           entry_row[q * T:(q + 1) * T].clone(), v & (rs == q),
                                           ts, evc, cq, ovf, tail)
        _put_slot(tok, q, T, new)
        entry_row[q * T:(q + 1) * T] = er
    overflow.copy_(ovf)


def partition_pattern_advance(prog: "PatternProgram", p: int, tok: dict, entry_row, ch, i: int,
                              ev: dict, cond, overflow, tail: bool = False) -> None:
    """K34: one NFA slot's pass (`pattern_advance`) over chunk i, for every
    partition slot with rows in it, each over its own [T] lanes and rows
    (csrc/partition_pattern.cu). tok: the [P*T] token table; entry_row
    [P*T] int32, chunk-local; ch: ops/partition.py `PatternChunks`; ev:
    {attr: [k*C]} the slot's stream columns over the whole padded batch;
    cond: the chunk's condition, [1, C] when it reads only the row, else
    [P*T, C] (None: true). tok, entry_row and overflow (0-d bool) are
    updated in place."""
    if ch.ts.device.type == "cpu":
        return partition_pattern_advance_ref(prog, p, tok, entry_row, ch, i, ev, cond, overflow,
                                             tail)
    atom = prog.slots[p].atoms[0]
    _keep, ts_used = prog.capture_keep()
    cr = tok["caps"][atom.ref_idx]
    lanes_in = [tok["active"], tok["slot"], tok["start_ts"], tok["entry_ts"], entry_row, cr["n"]]
    kernels.require_cuda("partition_pattern_advance", *lanes_in, ch.ts, overflow,
                         *[ev[n] for n in cr["cols"]])
    T, C, P = prog.T, ch.C, ch.p
    dev = ch.ts.device
    if any(x.shape != (P * T,) for x in lanes_in):
        raise ValueError(f"partition_pattern_advance: [{P * T}] token lanes expected")
    fork, strict, win = prog._pass_kind(p, tail)
    c, cst, csc = _cond_view(cond, dev)
    if c.dtype != torch.bool or c.shape[0] not in (1, P * T) or c.shape[1] not in (1, C):
        raise ValueError(f"partition_pattern_advance: condition {list(c.shape)} does not "
                         f"broadcast to [{P * T}, {C}]")
    pairs = [(cr["ts"], ch.ts)] if ts_used[atom.ref_idx] else []
    pairs += [(arr, ev[name]) for name, arr in cr["cols"].items()]
    for lane, src in pairs:
        if lane.dtype != src.dtype:
            raise ValueError(f"partition_pattern_advance: capture lane {lane.dtype}, column "
                             f"{src.dtype}")
    scratch = torch.empty(2 * P * T if fork else 1, dtype=torch.int32, device=dev)
    L = _Lanes({
        "lane": (ctypes.c_void_p, [a.data_ptr() for a, _s in pairs]),
        "src": (ctypes.c_void_p, [s.data_ptr() for _a, s in pairs]),
        "size": (ctypes.c_int, [a.element_size() for a, _s in pairs]),
        "width": (ctypes.c_int, [a.shape[1] for a, _s in pairs]),
    })
    kernels.check(kernels.function("pp_advance")(
        *[x.data_ptr() for x in lanes_in], ch.ts.data_ptr(), c.data_ptr(), cst, csc, T, C, i, p,
        int(fork), int(strict), int(not tail), int(win is not None),
        0 if win is None else int(win), ch.srow.data_ptr(), ch.seg_slot.data_ptr(),
        ch.seg_lo.data_ptr(), ch.seg_hi.data_ptr(), ch.nseg.data_ptr(), min(C, P),
        overflow.data_ptr(), scratch.data_ptr(), L.n, L["lane"], L["src"], L["size"],
        L["width"], kernels.stream()), "partition_pattern_advance")
    kernels.launches["partition_pattern_advance"] += 1


def partition_pattern_count_ref(prog: "PatternProgram", tok: dict, entry_row, ch, i: int, Mc,
                                Madv, ev0, ev1, overflow) -> None:
    """Plain version of `partition_pattern_count`: `pattern_count_ref` on
    each slot with rows in chunk i, with its lanes and its rows' masks (C
    the whole chunk's, as the vmap's)."""
    T = prog.T
    s, v, rs, slots = _chunk_slots(ch, i)
    ts = ch.ts[s]
    ev0c = None if ev0 is None else {n: a[s] for n, a in ev0.items()}
    ev1c = None if ev1 is None else {n: a[s] for n, a in ev1.items()}
    ovf = overflow.clone()
    for q in slots:
        mine = rs == q
        new, er, ovf = pattern_count_ref(prog, _slot_tok(tok, q, T), Mc[s] & mine,
                                         Madv[s] & mine, ts, ev0c, ev1c, ovf)
        _put_slot(tok, q, T, new)
        entry_row[q * T:(q + 1) * T] = er
    overflow.copy_(ovf)


def partition_pattern_count(prog: "PatternProgram", tok: dict, entry_row, ch, i: int, Mc, Madv,
                            ev0, ev1, overflow) -> None:
    """K35: the count route's closed-form pass over slots 0 and 1
    (`pattern_count`) in chunk i, for every partition slot with rows in it
    (csrc/partition_pattern.cu). Mc / Madv [k*C] bool: slot 0's and slot
    1's row-only conditions with the member rows over the padded batch;
    ev0 / ev1: the two slots' stream columns over it (None when this
    step's stream is not theirs). The chain cap Gmax = min(C // m + 1, T)
    takes the whole chunk's C, as the vmap's. tok, entry_row (every lane
    of a slot with rows: its chunk-local advance row, or -1) and overflow
    are updated in place."""
    if ch.ts.device.type == "cpu":
        return partition_pattern_count_ref(prog, tok, entry_row, ch, i, Mc, Madv, ev0, ev1,
                                           overflow)
    T, C, P = prog.T, ch.C, ch.p
    slot0, slot1 = prog.slots[0], prog.slots[1]
    atom0, atom1 = slot0.atoms[0], slot1.atoms[0]
    K, m = atom0.cap, slot0.min_count
    Mx = slot0.max_count if slot0.max_count > 0 else _UNBOUNDED
    c0, c1 = tok["caps"][atom0.ref_idx], tok["caps"][atom1.ref_idx]
    lanes = [tok["active"], tok["slot"], tok["start_ts"], tok["entry_ts"], entry_row, c0["n"],
             c1["n"]]
    kernels.require_cuda("partition_pattern_count", Mc, Madv, ch.ts, overflow, *lanes)
    if any(x.shape != (P * T,) for x in lanes):
        raise ValueError(f"partition_pattern_count: [{P * T}] token lanes expected")
    dev = ch.ts.device
    plan = _count_plan(prog, tok, ch.ts, ev0, ev1)
    scratch = torch.empty(3 * C + P * T + 8, dtype=torch.int32, device=dev)
    L = _Lanes({
        "lane": (ctypes.c_void_p, [old.data_ptr() for _k, old, _s, _nb, _mp in plan]),
        "src": (ctypes.c_void_p, [s.data_ptr() for _k, _o, s, _nb, _mp in plan]),
        "size": (ctypes.c_int, [old.element_size() for _k, old, _s, _nb, _mp in plan]),
        "width": (ctypes.c_int, [old.shape[1] if old.dim() == 2 else 1
                                 for _k, old, _s, _nb, _mp in plan]),
        "map": (ctypes.c_int, [mp for _k, _o, _s, _nb, mp in plan]),
        "null": (ctypes.c_longlong, [nb for _k, _o, _s, nb, _mp in plan]),
    })
    kernels.check(kernels.function("pp_count")(
        Mc.data_ptr(), Madv.data_ptr(), ch.ts.data_ptr(), *[x.data_ptr() for x in lanes], T, C, i,
        K, m, Mx, int(slot0.persistent), int(ev1 is not None), min(C // max(m, 1) + 1, T),
        ch.srow.data_ptr(), ch.seg_slot.data_ptr(), ch.seg_lo.data_ptr(), ch.seg_hi.data_ptr(),
        ch.nseg.data_ptr(), min(C, P), overflow.data_ptr(), scratch.data_ptr(), L.n, L["lane"],
        L["src"], L["size"], L["width"], L["map"], L["null"], kernels.stream()),
        "partition_pattern_count")
    kernels.launches["partition_pattern_count"] += 1


def partition_pattern_emit_ref(prog: "PatternProgram", tok: dict, entry_row, ch, i: int, now,
                               emis: PatternEmission, overflow, purge: bool) -> None:
    """Plain version of `partition_pattern_emit`: `pattern_emit_ref` on
    each slot with rows in chunk i into its own stretch, then its entry
    rows back to -1."""
    T = prog.T
    s, v, rs, slots = _chunk_slots(ch, i)
    ts = ch.ts[s]
    ovf = overflow.clone()
    for q in slots:
        out_q, n_q = emis.stretch(q)
        er = entry_row[q * T:(q + 1) * T]
        new, _o, _n, ovf = pattern_emit_ref(prog, _slot_tok(tok, q, T), er, ts, v & (rs == q),
                                            now, out_q, n_q, ovf, purge)
        tok["active"][q * T:(q + 1) * T] = new["active"]
        er.fill_(-1)
    overflow.copy_(ovf)


def partition_pattern_emit(prog: "PatternProgram", tok: dict, entry_row, ch, i: int, now,
                           emis: PatternEmission, overflow, purge: bool) -> None:
    """K36: the completions of chunk i (`pattern_emit`) for every partition
    slot with rows in it (csrc/partition_pattern.cu): each slot's tokens
    at its last NFA slot go to its emission stretch at emis.n[q] + their
    rank in (completion row, lane) order, up to the stretch (the overflow
    flag past it), and leave the table; with purge (the fast route) the
    tokens whose `within` expired by the slot's last row in the chunk are
    dropped, the arming token kept; the slot's entry rows go back to -1.
    Everything in place."""
    if ch.ts.device.type == "cpu":
        return partition_pattern_emit_ref(prog, tok, entry_row, ch, i, now, emis, overflow,
                                          purge)
    T, C, P = prog.T, ch.C, ch.p
    S = len(prog.slots)
    dev = ch.ts.device
    out = emis.out
    pairs = _emit_lanes(prog, tok, out)
    kernels.require_cuda("partition_pattern_emit", tok["active"], tok["slot"], tok["start_ts"],
                         entry_row, ch.ts, now, out["ts"], out["valid"], emis.n, overflow,
                         *[x for pr in pairs for x in pr])
    for src, dst in pairs:
        if src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:]:
            raise ValueError("partition_pattern_emit: emission lanes do not match the token lanes")
    scratch = torch.empty(2 * P * T, dtype=torch.int32, device=dev)
    L = _Lanes({
        "src": (ctypes.c_void_p, [s.data_ptr() for s, _d in pairs]),
        "dst": (ctypes.c_void_p, [d.data_ptr() for _s, d in pairs]),
        "size": (ctypes.c_int, [s.element_size() for s, _d in pairs]),
        "width": (ctypes.c_int, [s.shape[1] if s.dim() == 2 else 1 for s, _d in pairs]),
    })
    kernels.check(kernels.function("pp_emit")(
        tok["active"].data_ptr(), tok["slot"].data_ptr(), tok["start_ts"].data_ptr(),
        entry_row.data_ptr(), T, S, ch.ts.data_ptr(), C, i, now.data_ptr(), out["ts"].data_ptr(),
        out["valid"].data_ptr(), emis.off.data_ptr(), emis.cap.data_ptr(), emis.n.data_ptr(),
        overflow.data_ptr(), int(purge), prog.win_by_slot(dev).data_ptr(),
        int(prog.slots[0].persistent), ch.srow.data_ptr(), ch.seg_slot.data_ptr(),
        ch.seg_lo.data_ptr(), ch.seg_hi.data_ptr(), ch.nseg.data_ptr(), min(C, P),
        scratch.data_ptr(), L.n, L["src"], L["dst"], L["size"], L["width"], kernels.stream()),
        "partition_pattern_emit")
    kernels.launches["partition_pattern_emit"] += 1


def partition_pattern_scan_ref(prog: "PatternProgram", tok: dict, stream_id: Optional[str],
                               batch_ts, batch_kind, batch_valid, ev: dict, rmask, regs: list,
                               rows, used, emis: PatternEmission, overflow, timer_seen) -> dict:
    """Plain version of `partition_pattern_scan`: `pattern_scan_ref` on each
    used slot over its member rows and the TIMER rows (row order), into an
    emission buffer of out_cap rows, of which the stretch keeps the
    first."""
    T = prog.T
    new = _tok_map(tok, torch.clone)
    rowlist, slot_start, timers = rows.rowlist, rows.slot_start.tolist(), rows.timers
    ovf = overflow.clone()
    for q in torch.nonzero(used).flatten().tolist():
        rq = rowlist[slot_start[q]:slot_start[q + 1]].long()
        if timers.numel():
            rq = torch.sort(torch.cat([rq, timers.long()])).values
        if not rq.numel():
            continue
        out_t = prog.init_out(emis.out_cap)
        n_t = torch.zeros((), dtype=torch.int32, device=batch_ts.device)
        sub, out_t, n_t, ovf = pattern_scan_ref(
            prog, _slot_tok(new, q, T), stream_id, batch_ts[rq], batch_kind[rq], batch_valid[rq],
            {n: c[rq] for n, c in ev.items()}, rmask[:, rq], [r[rq] for r in regs], out_t, n_t,
            ovf, timer_seen[q])
        _put_slot(new, q, T, sub)
        st, n_q = emis.stretch(q)
        k = min(int(n_t), st["valid"].shape[0])
        for name, lane in st.items():
            lane[:k] = out_t[name][:k]
        n_q.copy_(n_t)
    overflow.copy_(ovf)
    return new


def partition_pattern_scan(prog: "PatternProgram", tok: dict, stream_id: Optional[str], batch_ts,
                           batch_kind, batch_valid, ev: dict, rmask, regs: list, rows, used,
                           emis: PatternEmission, overflow, timer_seen) -> dict:
    """K37: one scan step (`pattern_scan`) of the `used` partition slots at
    once, each over its member rows and every TIMER row, in row order
    (csrc/pattern_scan.cu `pps_scan`, one block a slot). tok: the [P*T]
    token table (read; the new table is returned); rows: ops/partition.py
    `PartitionRows` of the batch; used [P] bool the slots stepped;
    timer_seen [P] int64 each slot's max TIMER timestamp before the step.
    Slot q's emissions go to its stretch of `emis` (emis.n[q] counts them
    up to out_cap, past its stretch too: the caller runs the step again
    with larger stretches); overflow (0-d bool) is updated in place."""
    if batch_ts.device.type == "cpu":
        return partition_pattern_scan_ref(prog, tok, stream_id, batch_ts, batch_kind, batch_valid,
                                          ev, rmask, regs, rows, used, emis, overflow, timer_seen)
    P, T = used.shape[0], prog.T
    kernels.require_cuda("partition_pattern_scan", tok["active"], batch_ts, batch_kind,
                         batch_valid, rmask, overflow, timer_seen, used, rows.rowlist, *regs,
                         *ev.values(), *emis.out.values())
    new = _tok_map(tok, torch.clone)  # slots the step does not run keep their lanes
    emis.n.zero_()
    _scan_launch(prog, tok, stream_id, batch_ts, batch_kind, batch_valid, ev, rmask, regs,
                 emis.out, None, overflow, None, kernels.function("pps_scan"), kernels.stream(),
                 keyed=(P, used, rows, emis, timer_seen, new))
    kernels.launches["partition_pattern_scan"] += 1
    return new


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
        # a sequence with count slots carries an explicit forwarding lane
        # (reference: SEQUENCE addState accepts one new state per event)
        self._use_fwd = self.sequence and any(s.is_count for s in self.slots)
        # the scan route's split filters (compile_scan) and capture lanes
        self._cap_lanes: Optional[list] = None
        self._row_conds: Optional[dict] = None
        self._progs: dict = {}
        self._regs: list = []
        self._scan_descs: dict = {}
        self._consts: dict = {}

    # ---- capture projection ---------------------------------------------

    def set_capture_readers(self, keys: frozenset) -> None:
        """Declare the emission-buffer reader keys (the selector's); must run
        before capture_keep() is first called."""
        if self._keep_cache is not None:
            raise RuntimeError("capture_keep() ran before set_capture_readers()")
        self._capture_readers = frozenset(keys)

    def widen_capture_readers(self, keys: frozenset) -> None:
        """Add reader keys after the projection was computed (pattern
        lineage keeps every ref's timestamp lane): the projection and the scan
        route's compiled inputs are dropped and re-formed. Only before the
        first step."""
        self._capture_readers = frozenset(keys)
        self._keep_cache = None
        self._cap_lanes = None
        if self._row_conds is not None:
            self._row_conds = None
            self._progs, self._regs, self._scan_descs, self._consts = {}, [], {}, {}
            self.compile_scan()

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
        tok = {
            "active": active,
            "slot": torch.zeros(T, dtype=torch.int32, device=dev),
            # -1 == virgin (no event captured yet); 0 is a legitimate epoch ts
            "start_ts": torch.full((T,), -1, dtype=torch.int64, device=dev),
            "entry_ts": entry_ts,
            "caps": caps,
        }
        if self._use_fwd:
            # a min-0 count start state forwards its virgin at once
            fwd = torch.zeros(T, dtype=torch.bool, device=dev)
            fwd[0] = self.slots[0].is_count and self.slots[0].min_count == 0
            tok["fwd"] = fwd
        return tok

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

    def row_mask(self, p: int, ev: dict, batch_ts, now, v):
        """v AND slot p's conditions evaluated on each row alone (the
        count route's slots 0 and 1, or any slot whose conditions read only
        the row)."""
        atom = self.slots[p].atoms[0]
        env = self._row_env(ev, batch_ts, now, atom)
        mask = v
        for c in self._conds[(p, atom.ref_idx)]:
            mask = mask & torch.broadcast_to(c(env), v.shape)
        return mask

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
            masks.append(torch.zeros(C, dtype=torch.bool, device=batch_ts.device) if ev is None
                         else self.row_mask(p, ev, batch_ts, now, v))
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

    # ---- the scan route: inputs ---------------------------------------------

    def cap_lanes(self) -> list:
        """The capture lanes in the scan's order: per ref, its timestamps
        (name None) then its kept columns in schema order."""
        if self._cap_lanes is None:
            keep_cols, _ts_used = self.capture_keep()
            lanes = []
            for a in self.refs:
                lanes.append((a.ref_idx, None))
                lanes += [(a.ref_idx, name) for name, _t in self.schemas[a.stream_id].attrs
                          if name in keep_cols[a.ref_idx]]
            self._cap_lanes = lanes
        return self._cap_lanes

    def compile_scan(self) -> None:
        """Split every atom's filters for the scan route: each top-level
        conjunct of a filter that reads only the atom's own un-indexed keys
        (its event) is row-only and stays a compiled closure, so it lands in
        the ref's row mask (exact: a false conjunct, a null comparison
        among them, makes the whole filter false); any other becomes a
        CondProgram whose capture-free subtrees are row registers. A
        token-dependent subtree outside the program's operations raises
        here, at app creation."""
        if self._row_conds is not None:
            return
        self._row_conds, self._progs, self._regs = {}, {}, []
        self.cap_lanes()
        for slot in self.slots:
            for atom in slot.atoms:
                rows, progs = [], []
                for f in (part for f in atom.filters for part in _conjuncts(f)):
                    c, free = self._compile_at(f, atom)
                    if free:
                        rows.append(c)
                    else:
                        code: list = []
                        self._emit_cond(f, atom, code)
                        if _stack_depth(code) > MAX_STACK:
                            raise SiddhiAppCreationError(
                                f"a pattern condition deeper than {MAX_STACK} operands is not "
                                "ported yet")
                        progs.append(CondProgram(code))
                self._row_conds[(slot.index, atom.ref_idx)] = rows
                self._progs[(slot.index, atom.ref_idx)] = progs

    def _atom_scope(self, atom: Atom) -> Scope:
        """The scope a filter of `atom` compiles in (its event unqualified)."""
        s = self.scope.child()
        s.default_ref = atom.ref
        s.prefer_default = True
        return s

    def _compile_at(self, expr, atom: Atom):
        """(closure, capture-free) of `expr` in the atom's filter scope."""
        s = self._atom_scope(atom)
        c = compile_expression(expr, s)
        return c, all(k[0] == atom.ref and k[1] is None for k in s.used_keys)

    def _emit_cond(self, expr, atom: Atom, code: list) -> AttrType:
        """Append `expr`'s postfix code; returns its logical type."""
        c, free = self._compile_at(expr, atom)
        if free:
            if isinstance(expr, Constant):
                code.append((OP_CONST, _TY[c.type], _const_bits(c(Env({})), _TY[c.type])))
            else:
                code.append((OP_REG, len(self._regs), _TY[c.type]))
                self._regs.append((atom.ref_idx, c))
            return c.type
        if isinstance(expr, Variable):
            (ref, k, attr), t = self._atom_scope(atom).resolve(expr)
            self._emit_cap(ref, k, attr, t, code)
            return t
        if isinstance(expr, IsNull) and expr.expression is None:
            # `e1 is null`: the ref's arrival flag, negated
            self._emit_cap(expr.stream_id, expr.stream_index, "__arrived__", AttrType.BOOL, code)
            code.append((OP_NOT,))
            return AttrType.BOOL
        if type(expr) in _ARITH_CODE:
            lt = self._emit_cond(expr.left, atom, code)
            rt = self._emit_cond(expr.right, atom, code)
            t = promote(lt, rt)
            code.append((OP_ARITH, arith_code(expr, t), _TY[lt], _TY[rt], _TY[t]))
            return t
        if isinstance(expr, Compare):
            lt = self._emit_cond(expr.left, atom, code)
            rt = self._emit_cond(expr.right, atom, code)
            t = _TY[promote(lt, rt)] if lt in NUMERIC_TYPES and rt in NUMERIC_TYPES else -1
            code.append((OP_CMP, _CMP_CODE[expr.op], _TY[lt], _TY[rt], t))
            return AttrType.BOOL
        if isinstance(expr, (And, Or)):
            self._emit_cond(expr.left, atom, code)
            self._emit_cond(expr.right, atom, code)
            code.append((OP_AND,) if isinstance(expr, And) else (OP_OR,))
            return AttrType.BOOL
        if isinstance(expr, Not):
            self._emit_cond(expr.expression, atom, code)
            code.append((OP_NOT,))
            return AttrType.BOOL
        if isinstance(expr, IsNull):
            t = self._emit_cond(expr.expression, atom, code)
            code.append((OP_ISNULL, _TY[t]))
            return AttrType.BOOL
        raise SiddhiAppCreationError(
            f"a {type(expr).__name__} over captured events in a pattern condition is not "
            "ported yet")

    def _emit_cap(self, ref: str, k: Optional[int], attr: str, t: AttrType, code: list) -> None:
        """Append the capture read of key (ref, k, attr)."""
        a = next((a for a in self.refs if a.ref == ref), None)
        if a is None:
            raise SiddhiAppCreationError(f"a pattern condition reading '{ref}' is not ported yet")
        if attr == "__arrived__":
            lane = LANE_ARRIVED
        else:
            lane = self.cap_lanes().index((a.ref_idx, None if attr == TS_ATTR else attr))
        code.append((OP_CAP, a.ref_idx, K_NONE if k is None else k, lane, _TY[t]))

    def scan_inputs(self, stream_id: Optional[str], batch):
        """A scan step's per-row inputs: (ev, rmask, regs) — the step's
        stream columns, the [R, B] row-only mask of each ref (false for refs
        of other streams and on a TIMER step) and the row registers, each
        [B] (a zero lane for those of other streams)."""
        B = batch.ts.shape[0]
        dev = batch.ts.device
        R = len(self.refs)
        ev = dict(batch.cols) if stream_id is not None else {}
        slot_of = {a.ref_idx: s.index for s in self.slots for a in s.atoms}
        masks = []
        for a in self.refs:
            if a.stream_id != stream_id:
                masks.append(torch.zeros(B, dtype=torch.bool, device=dev))
                continue
            env = self._row_env(ev, batch.ts, None, a)
            m = torch.ones(B, dtype=torch.bool, device=dev)
            for c in self._row_conds[(slot_of[a.ref_idx], a.ref_idx)]:
                m = m & torch.broadcast_to(c(env), (B,))
            masks.append(m)
        rmask = torch.stack(masks) if R else torch.zeros((0, B), dtype=torch.bool, device=dev)
        regs = []
        for ref_idx, c in self._regs:
            a = self.refs[ref_idx]
            dtype = PHYSICAL_DTYPE[c.type]
            if a.stream_id != stream_id:
                regs.append(torch.zeros(B, dtype=dtype, device=dev))
                continue
            v = c(self._row_env(ev, batch.ts, None, a))
            regs.append(torch.broadcast_to(v.to(dtype), (B,)).contiguous())
        return ev, rmask.contiguous(), regs

    def _const(self, ty: int, bits: int, dev) -> torch.Tensor:
        """A condition program's constant as a 0-d tensor on `dev` (cached)."""
        key = (ty, bits, dev)
        v = self._consts.get(key)
        if v is None:
            if ty == TY_FLOAT:
                v = torch.tensor([bits], dtype=torch.int32).view(torch.float32)[0]
            else:
                v = torch.tensor(bits, dtype=_TY_DTYPE[ty])
            v = self._consts[key] = v.to(dev)
        return v

    def scan_desc(self, dev) -> torch.Tensor:
        """K16's descriptor table (int64, on `dev`, built once): a header
        [S, R, sequence, fwd lane, within or -1]; per slot [atoms, atom
        refs (2), logical (0 / 1 AND / 2 OR), min, max, every, count,
        within or -1, first slot of the every-block it ends or -1, deadline
        kind (0 none, 1 absent, 2 both sides absent, 3 one absent side),
        the waiting absent ref or -1, both sides absent, a trailing min-0
        count]; per ref [slot, absent, waiting or -1, capture capacity,
        programs, word offset of its programs]; then each program as its
        length and its 5-word instructions (csrc/pattern_scan.cu)."""
        t = self._scan_descs.get(dev)
        if t is not None:
            return t
        S, R = len(self.slots), len(self.refs)
        head = [S, R, int(self.sequence), int(self._use_fwd),
                -1 if self.within_ms is None else self.within_ms]
        slots, refs, progs = [], [None] * R, []
        base = len(head) + 14 * S + 6 * R
        for slot in self.slots:
            p = slot.index
            waits = [a for a in slot.atoms if a.absent and a.waiting_ms is not None]
            if slot.is_absent and slot.atoms[0].waiting_ms is not None:
                dkind = 1
            elif slot.logical is not None and len(waits) == len(slot.atoms):
                dkind = 2
            elif slot.logical is not None and waits:
                dkind = 3
            else:
                dkind = 0
            blk = next((b for b in self.every_blocks if b[1] == p), None)
            logical = {None: 0, LogicalType.AND: 1, LogicalType.OR: 2}[slot.logical]
            slots += [len(slot.atoms), slot.atoms[0].ref_idx,
                      slot.atoms[1].ref_idx if len(slot.atoms) > 1 else -1, logical,
                      slot.min_count, slot.max_count, int(slot.persistent), int(slot.is_count),
                      -1 if slot.within_ms is None else slot.within_ms,
                      -1 if blk is None else blk[0], dkind,
                      waits[0].ref_idx if slot.logical is not None and waits else -1,
                      int(slot.logical is not None and all(a.absent for a in slot.atoms)),
                      int(slot.is_count and slot.min_count == 0 and p == S - 1)]
            for a in slot.atoms:
                code = self._progs[(p, a.ref_idx)]
                refs[a.ref_idx] = [p, int(a.absent), -1 if a.waiting_ms is None else a.waiting_ms,
                                   a.cap, len(code), base + len(progs)]
                for cp in code:
                    progs.append(len(cp.code))
                    for ins in cp.code:
                        progs += list(ins) + [0] * (5 - len(ins))
        words = head + slots + [w for r in refs for w in r] + progs
        t = self._scan_descs[dev] = torch.tensor(words, dtype=torch.int64, device=dev)
        return t

    # ---- the scan route: one row (JAX apply_event, line for line) ---------------

    def _eligible(self, tok, p: int) -> torch.Tensor:
        """Tokens that may match slot p: at p, or parked at preceding count
        slots whose min is satisfied (count-skip); a sequence with counts
        keeps only the forwarded token (the fwd lane)."""
        active, slot = tok["active"], tok["slot"]
        elig = active & (slot == p)
        skip = torch.zeros_like(elig)
        q = p - 1
        while q >= 0 and self.slots[q].is_count:
            sat = tok["caps"][self.slots[q].atoms[0].ref_idx]["n"] >= max(
                self.slots[q].min_count, 0)
            skip = skip | (active & (slot == q) & sat)
            if self.slots[q].min_count > 0:
                break
            q -= 1
        if self._use_fwd:
            skip = skip & tok["fwd"]
        return elig | skip

    def _capture(self, caps_r, atom: Atom, match, ts: int, ev_row: dict):
        """Write the current event into ref r's next occurrence slot."""
        n = caps_r["n"]
        pos = n.clamp(0, atom.cap - 1)
        write = match & (n < atom.cap)
        at = (torch.arange(atom.cap, device=n.device)[None, :] == pos[:, None]) & write[:, None]
        new_cols = {name: torch.where(at, ev_row[name].to(arr.dtype), arr)
                    for name, arr in caps_r["cols"].items()}
        return {"n": torch.where(match, n + 1, n), "ts": torch.where(at, ts, caps_r["ts"]),
                "cols": new_cols}

    def apply_event(self, tok, ts: int, kind: int, ev_row: dict, rmask, regs_row: list, out,
                    out_n, overflow, timer_seen: int):
        """One valid row of the scan (JAX PatternProgram.apply_event,
        pattern.py:566-1059): within kills, the sequence start re-init, the
        deadline blocks, matching in descending slot order, sequence
        strictness and the fwd contest. ev_row: the step's stream columns at
        this row (0-d); rmask: [R] the row-only masks at this row; regs_row:
        the row registers at this row; timer_seen: the max TIMER timestamp
        already processed. `out` is written in place; returns (tok', out_n',
        overflow')."""
        T = self.T
        dev = tok["active"].device
        is_cur = kind == KIND_CURRENT
        eff_now = max(ts, timer_seen)
        can_fire = kind == KIND_TIMER or is_cur

        # within expiry (reference: StreamPreStateProcessor.isExpired)
        started = tok["start_ts"] >= 0
        dead = None
        if self.within_ms is not None:
            dead = started & (ts - tok["start_ts"] > self.within_ms)
        for slot in self.slots:
            if slot.within_ms is not None:
                k = (tok["slot"] == slot.index) & started & (ts - tok["start_ts"] > slot.within_ms)
                dead = k if dead is None else dead | k
        if dead is not None:
            tok = {**tok, "active": tok["active"] & ~dead}

        touched = torch.zeros(T, dtype=torch.bool, device=dev)
        last = len(self.slots) - 1

        # sequence start-state re-init: a fresh virgin whenever no slot-0
        # token is still pending there (reference: resetAndUpdate -> init)
        if self.sequence and self.slots[0].persistent and is_cur:
            s0 = self.slots[0]
            n0 = tok["caps"][s0.atoms[0].ref_idx]["n"]
            pend = tok["active"] & (tok["slot"] == 0) & (tok["start_ts"] < 0)
            if s0.is_count:
                mx0 = s0.max_count if s0.max_count > 0 else _UNBOUNDED
                pend = pend | (tok["active"] & (tok["slot"] == 0) & (n0 < mx0))
            mask0 = (torch.arange(T, device=dev) == 0) & ~pend.any()
            tok, overflow = self._arm_virgins(tok, mask0, 0, ts, overflow)

        # deadline blocks: absent deadlines emit or advance
        for slot in self.slots if can_fire else ():
            atom = slot.atoms[0]
            p = slot.index
            if slot.is_absent and atom.waiting_ms is not None:
                at_p = tok["active"] & (tok["slot"] == p)
                deadline = tok["entry_ts"] + atom.waiting_ms
                fire = at_p & (eff_now >= deadline)
                if not bool(fire.any()):
                    continue  # no deadline due: nothing changes
                # the deadline starts the within clock of an absence-first match
                tok = {**tok, "start_ts": torch.where(fire & (tok["start_ts"] < 0), deadline,
                                                      tok["start_ts"])}
                if p == last:
                    out_n, overflow = self._write_emits(out, out_n, overflow, fire, tok,
                                                        deadline)
                    if slot.persistent:  # `every not X for t` re-arms at the deadline
                        tok = self._clear_slot_caps(tok, fire, slot, ts=deadline)
                    else:
                        tok = self._consume(tok, fire, slot)
                elif slot.persistent:
                    tok, overflow, _dest = self._fork(tok, tok, fire, p + 1, deadline, overflow)
                    tok = self._clear_slot_caps(tok, fire, slot, ts=deadline)
                else:
                    tok = self._advance_rows(tok, fire, slot, deadline)
                touched = touched | fire
            elif slot.logical is not None and all(
                    a.absent and a.waiting_ms is not None for a in slot.atoms):
                # both sides absent: AND at the later deadline iff neither
                # arrived; OR at each side's own deadline iff it never arrived
                a1, a2 = slot.atoms[0], slot.atoms[1]
                at_p = tok["active"] & (tok["slot"] == p)
                arr1 = tok["caps"][a1.ref_idx]["n"] > 0
                arr2 = tok["caps"][a2.ref_idx]["n"] > 0
                if p == 0:
                    # an arrival re-arms that side's window (the marker ts lane)
                    last1 = tok["caps"][a1.ref_idx]["ts"][:, 0]
                    last2 = tok["caps"][a2.ref_idx]["ts"][:, 0]
                    dl1 = torch.maximum(tok["entry_ts"], last1) + a1.waiting_ms
                    dl2 = torch.maximum(tok["entry_ts"], last2) + a2.waiting_ms
                    arr1 = torch.zeros_like(arr1)
                    arr2 = torch.zeros_like(arr2)
                else:
                    dl1 = tok["entry_ts"] + a1.waiting_ms
                    dl2 = tok["entry_ts"] + a2.waiting_ms
                if slot.logical is LogicalType.AND:
                    both_dl = torch.maximum(dl1, dl2)
                    fires = [(at_p & ~arr1 & ~arr2 & (eff_now >= both_dl), both_dl)]
                else:
                    f1 = at_p & ~arr1 & (eff_now >= dl1)
                    f2 = at_p & ~arr2 & (eff_now >= dl2)
                    if slot.persistent:
                        fires = [(f1, dl1), (f2, dl2)]
                    else:
                        fires = [(f1 | f2, torch.where(f1, dl1, dl2))]
                for fire, dts in fires:
                    if p == last:
                        out_n, overflow = self._write_emits(out, out_n, overflow, fire, tok, dts)
                        if slot.persistent:
                            tok = self._clear_slot_caps(tok, fire, slot, ts=dts)
                        else:
                            tok = self._consume(tok, fire, slot)
                    elif slot.persistent:
                        tok, overflow, _dest = self._fork(tok, tok, fire, p + 1, dts, overflow)
                        tok = self._clear_slot_caps(tok, fire, slot, ts=dts)
                    else:
                        tok = self._advance_rows(tok, fire, slot, dts)
                    touched = touched | fire
            elif slot.logical is not None:
                # one absent side: `A and not B for t` completes at the deadline
                # once every present side arrived; `A or not B for t` at the
                # deadline iff B never arrived
                ab = next((a for a in slot.atoms if a.absent and a.waiting_ms is not None), None)
                if ab is None:
                    continue
                at_p = tok["active"] & (tok["slot"] == p)
                deadline = tok["entry_ts"] + ab.waiting_ms
                if slot.logical is LogicalType.OR:
                    b_arrived = tok["caps"][ab.ref_idx]["n"] > 0
                    fire = at_p & ~b_arrived & (eff_now >= deadline)
                else:
                    arrived = torch.ones(T, dtype=torch.bool, device=dev)
                    for a2 in slot.atoms:
                        if not a2.absent:
                            arrived = arrived & (tok["caps"][a2.ref_idx]["n"] > 0)
                    fire = at_p & arrived & (eff_now >= deadline)
                if p == last:
                    out_n, overflow = self._write_emits(out, out_n, overflow, fire, tok, deadline)
                    tok = self._consume(tok, fire, slot)
                    if slot.persistent:
                        # re-arm at the deadline, not at a late row's timestamp
                        tok = self._clear_slot_caps(tok, fire, slot, ts=deadline)
                elif slot.persistent:
                    tok, overflow, _dest = self._fork(tok, tok, fire, p + 1, deadline, overflow)
                    tok = self._clear_slot_caps(tok, fire, slot, ts=deadline)
                else:
                    tok = self._advance_rows(tok, fire, slot, deadline)
                touched = touched | fire

        # event matching, descending slot order: one event moves a token
        # at most one hop
        for slot in reversed(self.slots) if is_cur else ():
            p = slot.index
            # touched accumulates per slot: both sides of a logical element
            # may consume the same event
            slot_touch = torch.zeros(T, dtype=torch.bool, device=dev)
            for atom in slot.atoms:
                if not rmask[atom.ref_idx]:
                    continue  # another stream's atom, or no row filter passed
                elig = self._eligible(tok, p) & ~touched
                if slot.is_count and atom.cap:
                    mx = slot.max_count
                    if mx > 0:  # only tokens AT p absorb, up to max
                        n_here = tok["caps"][atom.ref_idx]["n"]
                        elig = elig & ~((tok["slot"] == p) & (n_here >= mx))
                match = elig
                for cp in self._progs[(p, atom.ref_idx)]:
                    match = match & cond_program_ref(self, cp, tok, regs_row)
                if not bool(match.any()):
                    continue  # nothing below changes the table without a match
                if atom.absent:
                    both_absent = slot.logical is not None and all(a2.absent for a2 in slot.atoms)
                    if atom.waiting_ms is not None and (slot.logical is LogicalType.OR
                                                        or both_absent):
                        # an arrival inside the window is recorded as a capture
                        # marker, not a kill (the other side may still complete)
                        mark = match & (ts <= tok["entry_ts"] + atom.waiting_ms)
                        caps = list(tok["caps"])
                        if p == 0 and both_absent:
                            # start-of-pattern both-absent: the arrival re-arms
                            # this side's window (latest arrival in ts[:, 0])
                            c = dict(caps[atom.ref_idx])
                            c["n"] = torch.where(mark, 1, c["n"]).to(c["n"].dtype)
                            col0 = torch.where(mark, torch.clamp(c["ts"][:, 0], min=ts),
                                               c["ts"][:, 0])
                            c["ts"] = _with_col0(c["ts"], col0)
                            caps[atom.ref_idx] = c
                        else:
                            caps[atom.ref_idx] = self._capture(caps[atom.ref_idx], atom, mark, ts,
                                                               ev_row)
                        tok = {**tok, "caps": caps}
                        slot_touch = slot_touch | mark
                        continue
                    # an arrival on an absent stream kills the token; with a
                    # waiting time, only arrivals inside the window
                    if atom.waiting_ms is not None:
                        match = match & (ts <= tok["entry_ts"] + atom.waiting_ms)
                    if p == 0 and atom.waiting_ms is not None:
                        # start-of-pattern absent: the virgin re-arms instead
                        rearm = match & (tok["start_ts"] < 0)
                        kill = match & ~rearm
                        tok = {**tok, "active": tok["active"] & ~kill}
                        tok = self._clear_slot_caps(tok, rearm, slot, ts=ts)
                    else:
                        tok = {**tok, "active": tok["active"] & ~match}
                    slot_touch = slot_touch | match
                    continue

                # capture the event into the atom's ref
                new_caps = list(tok["caps"])
                new_caps[atom.ref_idx] = self._capture(tok["caps"][atom.ref_idx], atom, match, ts,
                                                       ev_row)
                adv_tok = {**tok, "caps": new_caps,
                           "slot": torch.where(match, p, tok["slot"]).to(torch.int32),
                           "start_ts": torch.where(match & (tok["start_ts"] < 0), ts,
                                                   tok["start_ts"])}

                count_armed = None
                if slot.logical is not None:
                    if slot.logical is LogicalType.OR:
                        complete = match
                    else:
                        complete = match
                        for a2 in slot.atoms:
                            if not a2.absent:
                                complete = complete & (new_caps[a2.ref_idx]["n"] > 0)
                        wait_ab = next((a for a in slot.atoms
                                        if a.absent and a.waiting_ms is not None), None)
                        if wait_ab is not None:
                            # completion defers to the absent deadline
                            complete = complete & (eff_now >= tok["entry_ts"] + wait_ab.waiting_ms)
                    advance = complete
                elif slot.is_count:
                    # absorb in place; a trailing count emits (and dies) at min
                    n_after = new_caps[atom.ref_idx]["n"]
                    if slot.min_count >= 1:
                        count_armed = match & (n_after == slot.min_count)
                    else:
                        count_armed = torch.zeros_like(match)
                    if p == last and slot.min_count >= 1:
                        advance = count_armed
                    else:
                        advance = torch.zeros_like(match)
                else:
                    advance = match

                stay = match & ~advance
                blk = next((b for b in self.every_blocks if b[1] == p), None)
                if p == last:
                    out_n, overflow = self._write_emits(out, out_n, overflow, advance, adv_tok, ts)
                    tok = self._merge(tok, adv_tok, stay)
                    tok = self._consume(tok, advance, slot, force=slot.is_count)
                    if blk is not None:
                        tok, overflow, rearmed = self._rearm_block(tok, adv_tok, advance, blk, ts,
                                                                   overflow)
                        touched = touched | rearmed
                elif slot.persistent and not slot.is_count:
                    # fork: the advanced copy goes to a free lane, the
                    # generator stays armed
                    tok, overflow, dest_mask = self._fork(tok, adv_tok, advance, p + 1, ts,
                                                          overflow)
                    tok = self._merge(tok, adv_tok, stay)
                    touched = touched | dest_mask
                    tok, out_n, overflow = self._arrival_effects(tok, dest_mask, p + 1, ts, out,
                                                                 out_n, overflow)
                else:
                    moved = self._merge(tok, adv_tok, match)
                    tok = {**moved,
                           "slot": torch.where(advance, p + 1, moved["slot"]).to(torch.int32),
                           "entry_ts": torch.where(advance, ts, moved["entry_ts"])}
                    tok, out_n, overflow = self._arrival_effects(tok, advance, p + 1, ts, out,
                                                                 out_n, overflow)
                    if blk is not None:
                        tok, overflow, rearmed = self._rearm_block(tok, tok, advance, blk, ts,
                                                                   overflow)
                        touched = touched | rearmed
                slot_touch = slot_touch | match

                if slot.persistent and slot.logical is not None:
                    # the surviving generator re-arms fresh
                    tok = self._clear_slot_caps(tok, advance, slot, ts=ts)
                if slot.persistent and slot.is_count and slot.min_count >= 1 and not self.sequence:
                    # `every` over a count: a fresh virgin when a count reaches min
                    tok, overflow = self._arm_virgins(tok, count_armed, p, ts, overflow)
            touched = touched | slot_touch

        # sequence strictness: an unconsumed CURRENT event kills the
        # non-virgin tokens
        if self.sequence and is_cur:
            kill = tok["active"] & ~touched & ~(tok["start_ts"] < 0)
            tok = {**tok, "active": tok["active"] & ~kill}

        if self._use_fwd and is_cur:
            # end-of-event forwarding: per count slot, the oldest chain with
            # min satisfied wins the one pending spot at the next slot
            lanes64 = torch.arange(T, dtype=torch.int64, device=dev)
            new_fwd = tok["fwd"] & tok["active"] & (tok["start_ts"] < 0)
            for q, cslot in enumerate(self.slots):
                if not cslot.is_count:
                    continue
                n_q = tok["caps"][cslot.atoms[0].ref_idx]["n"]
                cand = (tok["active"] & (tok["slot"] == q) & touched
                        & (n_q >= max(cslot.min_count, 0)) & (tok["start_ts"] >= 0))
                key = torch.where(cand, tok["start_ts"] * T + lanes64,
                                  torch.full((), 1 << 62, dtype=torch.int64, device=dev))
                winner = cand & (lanes64 == torch.argmin(key))
                new_fwd = new_fwd | winner
            tok = {**tok, "fwd": new_fwd}
        return tok, out_n, overflow

    # ---- the scan route: token-table updates -----------------------------------

    @staticmethod
    def _merge(old, new, mask):
        """Per-lane select between two token tables."""

        def sel(a, b):
            return torch.where(mask if a.dim() == 1 else mask[:, None], b, a)

        caps = [{"n": sel(o["n"], n_["n"]), "ts": sel(o["ts"], n_["ts"]),
                 "cols": {k: sel(o["cols"][k], n_["cols"][k]) for k in o["cols"]}}
                for o, n_ in zip(old["caps"], new["caps"])]
        merged = {k: sel(old[k], new[k]) for k in ("active", "slot", "start_ts", "entry_ts")}
        merged["caps"] = caps
        if "fwd" in old:
            merged["fwd"] = sel(old["fwd"], new["fwd"])
        return merged

    def _consume(self, tok, mask, slot: Slot, force: bool = False):
        """Tokens that emitted die, unless at a persistent slot (trailing
        count slots force it: their re-arm is the virgin armed at min)."""
        if slot.persistent and not force:
            return tok
        return {**tok, "active": tok["active"] & ~mask}

    def _arrival_effects(self, tok, arrived, q: int, ts: int, out, out_n, overflow):
        """Tokens arriving at a trailing min-0 count emit at once with empty
        captures and are consumed."""
        if q >= len(self.slots):
            return tok, out_n, overflow
        nxt = self.slots[q]
        if not (nxt.is_count and nxt.min_count == 0 and q == len(self.slots) - 1):
            return tok, out_n, overflow
        out_n, overflow = self._write_emits(out, out_n, overflow, arrived, tok, ts)
        return {**tok, "active": tok["active"] & ~arrived}, out_n, overflow

    def _null_caps(self, a: Atom, c: dict, mask) -> dict:
        """Ref a's capture entry with `mask` lanes cleared (count 0,
        timestamps 0, columns null)."""
        types = self.schemas[a.stream_id].attr_types
        return {"n": torch.where(mask, 0, c["n"]).to(c["n"].dtype),
                "ts": torch.where(mask[:, None], 0, c["ts"]),
                "cols": {name: torch.where(mask[:, None], _null_of(types[name], arr), arr)
                         for name, arr in c["cols"].items()}}

    def _clear_slot_caps(self, tok, mask, slot: Slot, ts=None):
        """Reset a slot's captures on `mask` lanes; `ts` restarts the slot
        clock; at slot 0 the token becomes virgin again."""
        caps = list(tok["caps"])
        for a in slot.atoms:
            caps[a.ref_idx] = self._null_caps(a, caps[a.ref_idx], mask)
        out = {**tok, "caps": caps}
        if ts is not None:
            out["entry_ts"] = torch.where(mask, ts, out["entry_ts"])
        if slot.index == 0:
            out["start_ts"] = torch.where(mask, -1, out["start_ts"])
        return out

    def _alloc_lanes(self, tok, mask, overflow):
        """One free lane per set lane of `mask`, the rank-th free lane in
        ascending order; lanes that do not fit get T (dropped) and raise
        the overflow flag."""
        T = self.T
        free = ~tok["active"]
        order = torch.argsort((~free).to(torch.int8), stable=True)  # free lanes first
        nfree = free.sum()
        rank = torch.cumsum(mask.to(torch.int32), 0) - 1
        ok = mask & (rank < nfree)
        dest = torch.where(ok, order[rank.clamp(0, T - 1)], T)
        return dest, overflow | (mask & ~ok).any()

    def _scatter_tok(self, tok, dest, fields: dict, caps: list):
        """tok with lane dest[i] set from lane i of each given field (dest
        T: dropped); caps: per ref a capture entry to scatter, or None to
        clear the destination lanes."""
        T = self.T
        res = dict(tok)
        for k, v in fields.items():
            res[k] = set_at(tok[k], dest, v if v.dim() else v.expand(T))
        new_caps = []
        for a, c, src in zip(self.refs, tok["caps"], caps):
            if src is None:
                hit = torch.zeros(T + 1, dtype=torch.bool, device=dest.device)
                hit[dest.long()] = True
                new_caps.append(self._null_caps(a, c, hit[:T]))
            else:
                new_caps.append({"n": set_at(c["n"], dest, src["n"]),
                                 "ts": set_at(c["ts"], dest, src["ts"]),
                                 "cols": {k: set_at(arr, dest, src["cols"][k])
                                          for k, arr in c["cols"].items()}})
        res["caps"] = new_caps
        return res

    def _fork(self, tok, adv_tok, mask, next_slot: int, ts, overflow):
        """Advanced copies of `mask` lanes into free lanes (the `every`
        generator stays armed); returns (tok', overflow', dest mask)."""
        dest, overflow = self._alloc_lanes(tok, mask, overflow)
        dev = dest.device
        fields = {"active": torch.ones((), dtype=torch.bool, device=dev),
                  "slot": torch.full((), next_slot, dtype=torch.int32, device=dev),
                  "start_ts": adv_tok["start_ts"],
                  "entry_ts": torch.as_tensor(ts, dtype=torch.int64, device=dev)}
        if "fwd" in tok:
            fields["fwd"] = torch.zeros((), dtype=torch.bool, device=dev)
        res = self._scatter_tok(tok, dest, fields, adv_tok["caps"])
        return res, overflow, self._dest_mask(dest)

    def _dest_mask(self, dest):
        hit = torch.zeros(self.T + 1, dtype=torch.bool, device=dest.device)
        hit[dest.long()] = True
        return hit[:self.T]

    def _arm_virgins(self, tok, mask, p: int, ts: int, overflow):
        """Fresh virgin tokens (slot p, no captures) in free lanes."""
        dest, overflow = self._alloc_lanes(tok, mask, overflow)
        dev = dest.device
        fields = {"active": torch.ones((), dtype=torch.bool, device=dev),
                  "slot": torch.full((), p, dtype=torch.int32, device=dev),
                  "start_ts": torch.full((), -1, dtype=torch.int64, device=dev),
                  "entry_ts": torch.full((), ts, dtype=torch.int64, device=dev)}
        if "fwd" in tok:
            fwd0 = self.slots[p].is_count and self.slots[p].min_count == 0
            fields["fwd"] = torch.full((), fwd0, dtype=torch.bool, device=dev)
        return self._scatter_tok(tok, dest, fields, [None] * len(self.refs)), overflow

    def _rearm_block(self, tok, src_tok, mask, block, ts: int, overflow):
        """Re-armed copies at a completed every-block's first slot: the
        block's captures cleared, the others kept from src_tok; a
        whole-pattern block is virgin again, a mid-pattern one keeps its
        start."""
        first, last = block
        dest, overflow = self._alloc_lanes(tok, mask, overflow)
        dev = dest.device
        block_refs = {a.ref_idx for s in self.slots[first:last + 1] for a in s.atoms}
        caps = [None if a.ref_idx in block_refs else src_tok["caps"][a.ref_idx]
                for a in self.refs]
        fields = {"active": torch.ones((), dtype=torch.bool, device=dev),
                  "slot": torch.full((), first, dtype=torch.int32, device=dev),
                  "start_ts": (src_tok["start_ts"] if first > 0
                               else torch.full((), -1, dtype=torch.int64, device=dev)),
                  "entry_ts": torch.full((), ts, dtype=torch.int64, device=dev)}
        if "fwd" in tok:
            fields["fwd"] = torch.zeros((), dtype=torch.bool, device=dev)
        return self._scatter_tok(tok, dest, fields, caps), overflow, self._dest_mask(dest)

    def _advance_rows(self, tok, mask, slot: Slot, ts):
        return {**tok, "slot": torch.where(mask, slot.index + 1, tok["slot"]).to(torch.int32),
                "entry_ts": torch.where(mask, ts, tok["entry_ts"])}

    def _write_emits(self, out: dict, out_n, overflow, emit, tok, ts):
        """Append the `emit` lanes, in lane order, at out_n (in place), up
        to the buffer's capacity (the overflow flag past it); ts: the
        emission timestamp, per lane or one. Returns (out_n', overflow')."""
        cap = out["valid"].shape[0]
        rank = torch.cumsum(emit.to(torch.int32), 0) - 1
        dest = out_n + rank
        ok = emit & (dest < cap)
        overflow = overflow | (emit & ~ok).any()
        d = dest[ok].long()
        out["ts"][d] = torch.as_tensor(ts, dtype=torch.int64, device=d.device).expand(
            self.T)[ok]
        out["valid"][d] = True
        for a in self.refs:
            c = tok["caps"][a.ref_idx]
            out[f"n{a.ref_idx}"][d] = c["n"][ok]
            if f"ts{a.ref_idx}" in out:
                out[f"ts{a.ref_idx}"][d] = c["ts"][ok]
            for name in c["cols"]:
                out[f"c{a.ref_idx}.{name}"][d] = c["cols"][name][ok]
        return torch.clamp(out_n + emit.sum(dtype=torch.int32), max=cap).to(torch.int32), overflow


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

    def next_timer(self, tok, after=None, live=None):
        """The earliest absent-state deadline over active tokens, deadlines
        at or before `after` (the max TIMER timestamp processed; one value
        or one per token) excluded: a 0-d int64 on the token table's
        device, NO_TIMER when none. `live` [T] bool limits it to some
        tokens. A pattern without a waiting absent state returns the host
        constant NO_TIMER, at no device read."""
        if not self.needs_scheduler:
            return NO_TIMER
        t = None
        for slot in self.slots:
            absents = [a for a in slot.atoms if a.absent and a.waiting_ms is not None]
            if not absents or (len(slot.atoms) == 1 and not slot.is_absent):
                continue
            both_absent = len(absents) == len(slot.atoms) >= 2
            at_p = tok["active"] & (tok["slot"] == slot.index)
            if live is not None:
                at_p = at_p & live
            for a in absents:  # both-absent elements wait per side
                base = tok["entry_ts"]
                if slot.index == 0 and both_absent:  # arrivals re-arm that side's window
                    base = torch.maximum(base, tok["caps"][a.ref_idx]["ts"][:, 0])
                dl = torch.where(at_p, base + a.waiting_ms, NO_TIMER)
                if after is not None:
                    dl = torch.where(dl > after, dl, NO_TIMER)
                m = dl.min()
                t = m if t is None else torch.minimum(t, m)
        return t


def _stack_depth(code: list) -> int:
    """The largest stack a condition program builds."""
    depth = top = 0
    for ins in code:
        op = ins[0]
        if op in (OP_REG, OP_CONST, OP_CAP):
            top += 1
        elif op in (OP_ARITH, OP_CMP, OP_AND, OP_OR):
            top -= 1
        depth = max(depth, top)
    return depth
