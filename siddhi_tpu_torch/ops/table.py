"""The in-memory table's device routines: K21-K24, each a hand-written CUDA
kernel on the card beside its plain PyTorch version, which the wrapper takes
only for tensors on the CPU (a CUDA tensor launches the kernel or raises).

A table is a fixed-capacity columnar arena (`core/table.py`): per slot c the
column lanes `cols[name][c]`, `ts`, `valid` and `seq` (insertion order,
int64 max when empty), the 0-d `next` sequence number, and per indexed
column `ix_order` (a stable sort of the slots, valid first, then by key),
`ix_sorted` (the keys in that order, the column's largest value for an
empty slot) and the 0-d duplicate flag `ix_dups`.

- K21 `table_write` (csrc/table_write.cu): an insert. Primary-key rules
  (a row whose key a stored row holds is dropped, and so is any later row of
  the batch with the key of an earlier one), then the kept rows in order
  into the first free slots, `next` advanced by their number, and the
  overflow and dropped-duplicate flags. The stored-key test binary-searches
  the key column's sorted index when there is one and scans the table
  otherwise; it never builds the JAX package's [B, C] compare.
- K22 `table_index_build` / `table_index_probe` (csrc/table_index.cu): the
  sorted index of one column (`csrc/radix_sort.cuh`'s stable radix sort of
  the slots by (empty, key), floats in the sort's total order: -0.0 equal
  to 0.0, NaN last) and the indexed update's probe (a binary search per
  probe row, the hit test under numeric promotion, the last hitting probe
  row per slot as its writer, through a per-slot scratch kept all -1
  between calls).
- K23 `table_match` (csrc/table_match.cu): the on-condition per (probe row,
  slot) cell, as a program (below), reduced without the [B, C] mask: the
  last matching probe row per slot (the dense update's writer), any match
  per slot (delete), any match per probe row (`in`).
- K24 `table_update_scan` / `table_upsert_scan` (csrc/table_scan.cu): the
  two routines sequential over probe rows, the update with its primary-key
  rekey guard and the update-or-insert, each row seeing the earlier rows'
  writes.

**Table programs.** A condition or set value that reads the table is a
postfix program in the format of the pattern scan's condition programs
(`core/pattern.py` `CondProgram`): (op, a, b, c, d) instructions, with
OP_TAB = (3, lane, type) reading table lane `lane` at the slot instead of a
token capture. Subtrees that do not read the table are row registers,
evaluated over the probe batch by their compiled closures. `program_ref`
is the plain interpreter, over any broadcast of registers and lanes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.pattern import (
    _TY_DTYPE,
    OP_CMP,
    OP_REG,
    TY_BOOL,
    TY_FLOAT,
    TY_ID,
    TY_INT,
    TY_LONG,
    run_program,
)
from siddhi_tpu_torch.core.types import convert_to, flush_subnormal
from siddhi_tpu_torch.ops.prefix import first_indices

OP_TAB = 3  # (OP_TAB, lane, ty): table lane `lane` at the slot (prog.cuh OP_OPERAND)
MAX_STACK = 16  # csrc/prog.cuh kMaxStack
MAX_LANES = 32  # csrc/prog.cuh kMaxLanes
MAX_REGS = 32
MODE_WRITER, MODE_DELETE, MODE_IN = 0, 1, 2
_CELLS = 1 << 22  # plain K23: probe rows per chunk = _CELLS // C


@dataclasses.dataclass
class TableProgram:
    """A compiled table program: `code` (postfix), `regs` (closures over the
    probe env, each [B] or 0-d), `lanes` (table lane names; None = ts) and
    the result type code (TY_*)."""

    code: list
    regs: list
    lanes: list
    ty: int
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def code_tensor(self, device) -> torch.Tensor:
        """The instructions as an int64 [n, 5] tensor on `device` (cached)."""
        t = self._dev.get(device)
        if t is None:
            rows = [list(ins) + [0] * (5 - len(ins)) for ins in self.code]
            t = self._dev[device] = torch.tensor(rows, dtype=torch.int64).to(device)
        return t


def _ty_of(dtype: torch.dtype) -> int:
    return {torch.bool: TY_BOOL, torch.int32: TY_INT, torch.int64: TY_LONG,
            torch.float32: TY_FLOAT}[dtype]


def _const_value(ty: int, bits: int, dev) -> torch.Tensor:
    if ty == TY_FLOAT:
        return torch.tensor([bits], dtype=torch.int32).view(torch.float32)[0].to(dev)
    return torch.tensor(bits, dtype=_TY_DTYPE[ty]).to(dev)


def program_ref(code: list, regs: list, lanes: list) -> torch.Tensor:
    """Plain interpreter of a table program (core/pattern.py `run_program`
    with OP_TAB reading lanes[l]): regs[r] is row register r and lanes[l]
    table lane l, in any shapes that broadcast. Returns the value,
    broadcast."""
    dev = lanes[0].device if lanes else regs[0].device if regs else torch.device("cpu")
    return run_program(code, regs, lambda ty, bits: _const_value(ty, bits, dev),
                       lambda ins: lanes[ins[1]], "table program")


def lane_tensors(prog: TableProgram, cols: dict, ts: torch.Tensor) -> list:
    return [ts if n is None else cols[n] for n in prog.lanes]


class _Args:
    """ctypes arrays for one C call (kept alive until it returns)."""

    def __init__(self):
        self._keep = []

    def ptrs(self, tensors) -> int:
        arr = (ctypes.c_void_p * max(1, len(tensors)))(*[t.data_ptr() for t in tensors])
        self._keep.append(arr)
        return ctypes.addressof(arr)

    def ints(self, vals) -> int:
        arr = (ctypes.c_int * max(1, len(vals)))(*vals)
        self._keep.append(arr)
        return ctypes.addressof(arr)


def _check_prog(what: str, prog: TableProgram, regs: list, lanes: list) -> None:
    if len(prog.lanes) > MAX_LANES or len(regs) > MAX_REGS:
        raise ValueError(f"{what}: {len(prog.lanes)} table lanes / {len(regs)} registers "
                         f"(max {MAX_LANES} / {MAX_REGS})")


# ---------------------------------------------------------------------------
# K21: the insert
# ---------------------------------------------------------------------------


def table_write_ref(state: dict, cols: dict, ts, rows, pk_cols: list):
    """Plain version of `table_write`, in the JAX package's formulation
    (InMemoryTable.insert + _append): the [B, C] key compare (in chunks of
    probe rows) and the [B, B] earlier-duplicate compare, first_indices of
    the free slots, a cumsum rank and the scatters."""
    valid = state["valid"]
    b = rows.shape[0]
    c = valid.shape[0]
    dev = rows.device
    pk_dup = torch.zeros((), dtype=torch.bool, device=dev)
    if pk_cols:
        stored = torch.zeros(b, dtype=torch.bool, device=dev)
        step = max(1, _CELLS // max(c, 1))
        keys = {k: flush_subnormal(cols[k]) for k in pk_cols}  # compared as JAX compares
        held = {k: flush_subnormal(state["cols"][k]) for k in pk_cols}
        for lo in range(0, b, step):
            hi = min(b, lo + step)
            m = rows[lo:hi, None] & valid[None, :]
            for k in pk_cols:
                m = m & (keys[k][lo:hi, None] == held[k][None, :])
            stored[lo:hi] = m.any(dim=1)
        same = torch.ones((b, b), dtype=torch.bool, device=dev)
        for k in pk_cols:
            same = same & (keys[k][:, None] == keys[k][None, :])
        ar = torch.arange(b, device=dev)
        earlier = same & rows[None, :] & (ar[None, :] < ar[:, None])
        fresh = rows & ~earlier.any(dim=1) & ~stored
        pk_dup = (rows & ~fresh).any()
        rows = fresh
    free = ~valid
    n_free = free.sum()
    n_rows = rows.sum()
    overflow = n_rows > n_free
    free_idx = first_indices(free, b)
    rank = torch.cumsum(rows.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(rows, free_idx[rank.clamp(0, b - 1).long()], -1)
    ok = rows & (slot >= 0)
    dst = torch.where(ok, slot, c).long()[ok]

    def put(lane, src):
        out = lane.clone()
        out[dst] = convert_to(src[ok], lane.dtype)
        return out

    new_seq = state["next"] + rank.to(torch.int64)
    out = {**state,
           "cols": {n: put(v, cols[n]) for n, v in state["cols"].items()},
           "ts": put(state["ts"], ts),
           "valid": put(valid, torch.ones(b, dtype=torch.bool, device=dev)),
           "seq": put(state["seq"], new_seq),
           "next": state["next"] + n_rows.to(torch.int64)}
    return out, overflow, pk_dup


def table_write(state: dict, cols: dict, ts, rows, pk_cols: list, index=None):
    """Insert the rows of a batch where `rows` holds into the table `state`.

    cols: {table column: [B]} in the table's dtypes; ts [B] int64; rows [B]
    bool; pk_cols: the primary-key columns ([] for none); index: (ix_order,
    ix_sorted) of the single key column when it carries a sorted index
    (the card probes it instead of scanning the table). Returns (state',
    overflow, pk_dup): the new state (`next` advanced by the kept rows,
    overflowed ones included), whether kept rows found no free slot, and
    whether any row was dropped as a primary-key duplicate (0-d bools)."""
    if rows.device.type == "cpu":
        return table_write_ref(state, cols, ts, rows, pk_cols)
    lanes = list(state["cols"].values())
    kernels.require_cuda("table_write", rows, ts, state["valid"], state["ts"], state["seq"],
                         state["next"], *lanes, *[cols[n] for n in state["cols"]])
    b = rows.shape[0]
    c = state["valid"].shape[0]
    if len(lanes) + 3 > MAX_LANES or len(pk_cols) > 8 or b >= 2**30 or c >= 2**30:
        raise ValueError(f"table_write: {len(lanes)} columns, {len(pk_cols)} key columns, "
                         f"B={b}, C={c} out of range")
    dev = rows.device
    names = list(state["cols"])
    new = {n: v.clone() for n, v in state["cols"].items()}
    new_ts, new_valid, new_seq = state["ts"].clone(), state["valid"].clone(), \
        state["seq"].clone()
    new_next = torch.empty_like(state["next"])
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    pk_dup = torch.empty((), dtype=torch.bool, device=dev)
    tiles = -(-c // 1024)
    scratch = torch.empty(2 * b + 2 * tiles + 4, dtype=torch.int32, device=dev)
    A = _Args()
    dst = [new[n] for n in names] + [new_ts, new_valid]
    src = [cols[n] for n in names] + [ts]
    ix_order = index[0] if index is not None else None
    ix_sorted = index[1] if index is not None else None
    kernels.check(kernels.function("tw_insert")(
        rows.data_ptr(), b, c, state["valid"].data_ptr(), len(pk_cols),
        A.ptrs([cols[k] for k in pk_cols]), A.ptrs([state["cols"][k] for k in pk_cols]),
        A.ints([cols[k].element_size() for k in pk_cols]),
        A.ints([_ty_of(cols[k].dtype) for k in pk_cols]),
        ix_order.data_ptr() if ix_order is not None else None,
        ix_sorted.data_ptr() if ix_sorted is not None else None,
        len(names), A.ptrs(src), A.ptrs(dst), A.ints([x.element_size() for x in dst]),
        state["next"].data_ptr(), new_seq.data_ptr(), new_next.data_ptr(),
        overflow.data_ptr(), pk_dup.data_ptr(), scratch.data_ptr(), kernels.stream()),
        "table_write")
    kernels.launches["table_write"] += 1
    out = {**state, "cols": new, "ts": new_ts, "valid": new_valid, "seq": new_seq,
           "next": new_next}
    return out, overflow, pk_dup


# ---------------------------------------------------------------------------
# K22: the sorted index and its probe
# ---------------------------------------------------------------------------


def sort_sentinel(dtype: torch.dtype):
    """The largest value of a column dtype (an empty slot's sorted key)."""
    if dtype == torch.float32:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def table_index_build_ref(keys: torch.Tensor, valid: torch.Tensor):
    """Plain version of `table_index_build`, in the JAX package's
    formulation (_rebuild_index): a stable lexsort by (empty, key), the
    sentinel fill and the adjacent-duplicate test. Float keys sort and
    compare with their subnormals as zeros, as XLA's do."""
    o1 = torch.sort(keys.to(torch.uint8) if keys.dtype == torch.bool else flush_subnormal(keys),
                    stable=True).indices
    o2 = torch.sort((~valid[o1]).to(torch.uint8), stable=True).indices
    order = o1[o2]
    svalid = valid[order]
    sk = torch.where(svalid, keys[order],
                     torch.tensor(sort_sentinel(keys.dtype), dtype=keys.dtype,
                                  device=keys.device))
    fk = flush_subnormal(sk)
    dups = ((fk[1:] == fk[:-1]) & svalid[1:] & svalid[:-1]).any()
    return order.to(torch.int32), sk, dups


def table_index_build(keys: torch.Tensor, valid: torch.Tensor):
    """The sorted index of one key column: (ix_order int32 [C], ix_sorted
    [C], ix_dups 0-d bool) — the slots sorted stably by (empty, key), the
    keys in that order with the column's largest value for an empty slot,
    and whether two valid slots hold equal keys."""
    if keys.device.type == "cpu":
        return table_index_build_ref(keys, valid)
    kernels.require_cuda("table_index_build", keys, valid)
    c = keys.shape[0]
    if c >= 2**30:
        raise ValueError(f"table_index_build: C={c} out of range")
    dev = keys.device
    order = torch.empty(c, dtype=torch.int32, device=dev)
    sk = torch.empty_like(keys)
    dups = torch.empty((), dtype=torch.bool, device=dev)
    # one workspace, carved by the kernel's own layout (ti_build_workspace)
    work = torch.empty(kernels.function("ti_build_workspace")(c), dtype=torch.uint8, device=dev)
    kernels.check(kernels.function("ti_build")(
        keys.data_ptr(), _ty_of(keys.dtype), valid.data_ptr(), c, order.data_ptr(),
        sk.data_ptr(), dups.data_ptr(), work.data_ptr(), kernels.stream()),
        "table_index_build")
    kernels.launches["table_index_build"] += 1
    return order, sk, dups


def total_order(x: torch.Tensor) -> torch.Tensor:
    """Keys whose integer order is the JAX sort's total order: a float's
    -0.0, 0.0 and subnormals one value, every NaN one value after +inf (an
    int's order is its own; a bool is 0/1)."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if x.dtype != torch.float32:
        return x
    x = flush_subnormal(x)
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u + 0x80000000)


def table_index_probe_ref(keys, valid, order, sk, probe_raw, probe_ok):
    """Plain version of `table_index_probe`, in the JAX package's
    formulation (_update_indexed): searchsorted of the probe cast to the key
    dtype (in the sort's total order, as jnp.searchsorted compares), the hit
    test under promotion, and the lexsort by (candidate, hit, row) whose
    segment ends are the writers."""
    b = probe_raw.shape[0]
    c = keys.shape[0]
    probe = probe_raw.to(keys.dtype)
    pos = torch.searchsorted(total_order(sk), total_order(probe), side="left").clamp(0, c - 1)
    cand = order[pos].long()
    t = _promoted(keys.dtype, probe_raw.dtype)
    hit = probe_ok & (flush_subnormal(keys[cand].to(t)) == flush_subnormal(probe_raw.to(t))) \
        & valid[cand]
    idx = torch.arange(b, device=keys.device)
    perm = idx
    for k in (idx, hit.to(torch.int32), cand):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    sc = cand[perm]
    seg_end = torch.cat([sc[1:] != sc[:-1], torch.ones(1, dtype=torch.bool, device=keys.device)])
    win = torch.zeros(b, dtype=torch.bool, device=keys.device)
    win[perm] = hit[perm] & seg_end
    return torch.where(win, cand, c).to(torch.int32)


def winner_scratch(device, c: int) -> torch.Tensor:
    """A new per-slot writer scratch for `table_index_probe`: int32 [C] all
    -1. The probe leaves it all -1 (each slot's writer puts it back,
    csrc/table_index.cu target_kernel), so its owner fills it once and
    passes it to every probe of one index, in stream order: a table keeps
    one a column and probes under its lock."""
    return torch.full((max(c, 1),), -1, dtype=torch.int32, device=device)


def _promoted(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    return torch.promote_types(a, b)


def table_index_probe(keys, valid, order, sk, probe_raw, probe_ok, winner):
    """The indexed update's probe: per probe row, the slot it writes, or C.

    keys/valid [C] the key column and occupancy; order/sk the column's
    sorted index; probe_raw [B] the probe values in their own dtype;
    probe_ok [B] bool (a live CURRENT row whose probe is not null); winner
    the index's writer scratch from `winner_scratch`, all -1, left so
    (None on the CPU, where it is not used). A row
    locates its candidate with its probe cast to the key dtype, hits when
    the candidate is valid and equal under numeric promotion, and writes
    when it is the last hitting row of its candidate. Returns int32 [B]."""
    if keys.device.type == "cpu":
        return table_index_probe_ref(keys, valid, order, sk, probe_raw, probe_ok)
    kernels.require_cuda("table_index_probe", keys, valid, order, sk, probe_raw, probe_ok,
                         winner)
    b, c = probe_raw.shape[0], keys.shape[0]
    if b >= 2**30 or c >= 2**30:
        raise ValueError(f"table_index_probe: B={b}, C={c} out of range")
    if winner.dtype != torch.int32 or winner.shape != (max(c, 1),):
        raise ValueError(f"table_index_probe: winner must be int32 [{max(c, 1)}]")
    cmp_dtype = _promoted(keys.dtype, probe_raw.dtype)
    probe = probe_raw.to(keys.dtype)
    probe_cmp = probe_raw.to(cmp_dtype)
    target = torch.empty(b, dtype=torch.int32, device=keys.device)
    err = kernels.function("ti_probe")(
        keys.data_ptr(), _ty_of(keys.dtype), valid.data_ptr(), order.data_ptr(),
        sk.data_ptr(), c, probe.data_ptr(), probe_cmp.data_ptr(), _ty_of(cmp_dtype),
        probe_ok.data_ptr(), b, winner.data_ptr(), target.data_ptr(), kernels.stream())
    if err != 0:  # the scratch may hold writers
        winner.fill_(-1)
    kernels.check(err, "table_index_probe")
    kernels.launches["table_index_probe"] += 1
    return target


# ---------------------------------------------------------------------------
# K23: the condition match
# ---------------------------------------------------------------------------


def table_match_ref(prog: TableProgram, regs: list, lanes: list, valid, rows, mode: int,
                    gate=None):
    """Plain version of `table_match`, in the JAX package's formulation
    (InMemoryTable.match and its reductions, `In`): the program over
    [rows, 1] registers and [1, C] lanes, in chunks of probe rows, then
    max / any over the chunk."""
    if gate is not None:
        valid = valid & gate
    c = valid.shape[0]
    b = regs[0].shape[0] if regs else rows.shape[0]
    dev = valid.device
    step = max(1, _CELLS // max(c, 1))
    lanes2 = [x[None, :] for x in lanes]
    if mode == MODE_WRITER:
        out = torch.full((c,), -1, dtype=torch.int32, device=dev)
    elif mode == MODE_DELETE:
        out = torch.zeros(c, dtype=torch.bool, device=dev)
    else:
        out = torch.zeros(b, dtype=torch.bool, device=dev)
    if not bool(valid.any()):  # an empty table, or the gate off
        return out
    for lo in range(0, b, step):
        hi = min(b, lo + step)
        pair = program_ref(prog.code, [r[lo:hi, None] for r in regs], lanes2)
        pair = torch.broadcast_to(pair, (hi - lo, c)) & valid[None, :]
        if mode == MODE_IN:
            out[lo:hi] = pair.any(dim=1)
            continue
        pair = pair & rows[lo:hi, None]
        if mode == MODE_WRITER:
            idx = torch.arange(lo, hi, dtype=torch.int32, device=dev)[:, None]
            out = torch.maximum(out, torch.where(pair, idx, -1).amax(dim=0))
        else:
            out = out | pair.any(dim=0)
    return out


def table_match(prog: TableProgram, regs: list, lanes: list, valid, rows, mode: int,
                gate=None):
    """The on-condition `prog` over every (probe row, slot) cell, reduced
    by `mode`: MODE_WRITER, per slot the last valid probe row (rows) that
    matches it, or -1 (int32 [C]); MODE_DELETE, per slot whether any probe
    row matches it (bool [C]); MODE_IN, per probe row whether it matches
    any slot (bool [B], rows unused). regs: the program's row registers,
    each [B]; lanes: its table lanes, each [C]; valid [C]. gate: an
    optional 0-d bool on the device; while it is false nothing matches
    (the choice stays on the device: no host read)."""
    if valid.device.type == "cpu":
        return table_match_ref(prog, regs, lanes, valid, rows, mode, gate)
    kernels.require_cuda("table_match", valid, rows, *regs, *lanes,
                         *([] if gate is None else [gate]))
    _check_prog("table_match", prog, regs, lanes)
    c = valid.shape[0]
    b = rows.shape[0]
    if b >= 2**30 or c >= 2**30:
        raise ValueError(f"table_match: B={b}, C={c} out of range")
    dev = valid.device
    if mode == MODE_WRITER:
        out = torch.empty(c, dtype=torch.int32, device=dev)
    else:
        out = torch.empty(c if mode == MODE_DELETE else b, dtype=torch.bool, device=dev)
    code = prog.code_tensor(dev)
    A = _Args()
    kernels.check(kernels.function("tm_match")(
        code.data_ptr(), code.shape[0], len(regs), A.ptrs(regs),
        A.ints([_ty_of(r.dtype) for r in regs]), len(lanes), A.ptrs(lanes),
        A.ints([_ty_of(x.dtype) for x in lanes]), valid.data_ptr(), rows.data_ptr(),
        None if gate is None else gate.data_ptr(), b, c, mode, out.data_ptr(), kernels.stream()),
        "table_match")
    kernels.launches["table_match"] += 1
    return out


# ---------------------------------------------------------------------------
# K24: the sequential update and the update-or-insert
# ---------------------------------------------------------------------------


def _row(regs: list, b: int) -> list:
    return [r[b] for r in regs]


class ScanPrograms:
    """The programs of one sequential table op for K24: the on-condition
    `on`, the set values `sets` ([(column, program)]) and `guard` (the index
    in `sets` of the primary-key column's value when the update may rekey
    it, else None), laid back to back with their table lanes renumbered
    into the kernel's lane list: the table's columns in state order, then
    ts. Built once per op, at app creation."""

    def __init__(self, on: TableProgram, sets: list, guard: Optional[int], names: list):
        self.on, self.sets, self.guard, self.names = on, sets, guard, list(names)
        progs = [on] + [sp for _n, sp in sets]
        self.lens = [len(p.code) for p in progs]
        self.starts = [sum(self.lens[:i]) for i in range(len(progs))]
        self.tys = [p.ty for p in progs]
        rows = []
        for p in progs:
            idx = [len(self.names) if n is None else self.names.index(n) for n in p.lanes]
            for ins in p.code:
                ins = list(ins) + [0] * (5 - len(ins))
                if ins[0] == OP_TAB:
                    ins[1] = idx[ins[1]]
                rows.append(ins)
        self._rows = rows
        self.set_lane = [self.names.index(n) for n, _sp in sets]
        # the condition `T.col == register` in one type: K24 compares that
        # lane directly (eq = (lane, register, type), or None)
        self.eq = None
        code = rows[:len(on.code)]
        if len(code) == 3 and code[2][0] == OP_CMP and code[2][1] == 4:
            (o1, a1, t1, *_r1), (o2, a2, t2, *_r2), (_op, _eq, lt, rt, t) = code
            same = lt == rt and (t == lt or (t == -1 and lt in (TY_ID, TY_BOOL)))
            if same and {o1, o2} == {OP_TAB, OP_REG}:
                lane, reg = (a1, a2) if o1 == OP_TAB else (a2, a1)
                self.eq = (lane, reg, lt)
        self._dev: dict = {}

    def code(self, device) -> torch.Tensor:
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = torch.tensor(self._rows, dtype=torch.int64).to(device)
        return t


def table_update_scan_ref(scan: ScanPrograms, regs: list, state: dict, rows):
    """Plain version of `table_update_scan`, in the JAX package's
    formulation (the lax.scan body of InMemoryTable.update): per valid probe
    row in order, the match over the [C] lanes, the rekey guard, and every
    set value evaluated before any is written."""
    on, sets, guard = scan.on, scan.sets, scan.guard
    cols = dict(state["cols"])
    valid, ts = state["valid"], state["ts"]
    c = valid.shape[0]
    dev = valid.device
    conflict = torch.zeros((), dtype=torch.bool, device=dev)
    arange = torch.arange(c, device=dev)
    for b in torch.nonzero(rows).flatten().tolist():
        rv = _row(regs, b)
        m = torch.broadcast_to(program_ref(on.code, rv, lane_tensors(on, cols, ts)), (c,)) \
            & valid
        vals = {}
        for name, sp in sets:
            vals[name] = convert_to(torch.broadcast_to(
                program_ref(sp.code, rv, lane_tensors(sp, cols, ts)), (c,)), cols[name].dtype)
        if guard is not None:
            name = sets[guard][0]
            kcol = cols[name]
            v = vals[name]
            v, kcol = flush_subnormal(v), flush_subnormal(kcol)
            changed = m & (v != kcol)
            n_changed = changed.sum()
            i0 = int(torch.argmax(changed.to(torch.uint8)))
            exists_other = (valid & (kcol == v[i0]) & (arange != i0)).any()
            fail = (n_changed >= 2) | ((n_changed == 1) & exists_other)
            m = m & ~fail
            conflict = conflict | fail
        for name, _sp in sets:
            cols[name] = torch.where(m, vals[name], cols[name])
    return {**state, "cols": cols}, conflict


def table_update_scan(scan: ScanPrograms, regs: list, state: dict, rows):
    """The update's sequential form: each valid probe row in order matches
    the slots with `scan.on` against the table as the earlier rows left it
    and writes the set values (each evaluated at the slot before any is
    written). With a guard, a row that would change two keys, or one onto a
    key another valid slot holds, writes nothing and sets the conflict
    flag. regs: the row registers of all the programs (one numbering),
    each [B]. Returns (state', conflict)."""
    if rows.device.type == "cpu":
        return table_update_scan_ref(scan, regs, state, rows)
    return _scan_launch(scan, regs, state, rows, upsert=False)


def table_upsert_scan_ref(scan: ScanPrograms, regs: list, state: dict, rows, ins_cols: dict,
                          ts):
    """Plain version of `table_upsert_scan`, in the JAX package's
    formulation (the lax.scan body of InMemoryTable.update_or_insert)."""
    on, sets = scan.on, scan.sets
    cols = dict(state["cols"])
    lts, valid, seq, nxt = state["ts"], state["valid"], state["seq"], state["next"]
    c = valid.shape[0]
    dev = valid.device
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for b in torch.nonzero(rows).flatten().tolist():
        rv = _row(regs, b)
        m = torch.broadcast_to(program_ref(on.code, rv, lane_tensors(on, cols, lts)), (c,)) \
            & valid
        if bool(m.any()):
            vals = {name: convert_to(torch.broadcast_to(
                program_ref(sp.code, rv, lane_tensors(sp, cols, lts)), (c,)), cols[name].dtype)
                for name, sp in sets}
            for name, _sp in sets:
                cols[name] = torch.where(m, vals[name], cols[name])
            continue
        free = ~valid
        if not bool(free.any()):
            ovf = torch.ones((), dtype=torch.bool, device=dev)
            continue
        slot = int(torch.argmax(free.to(torch.uint8)))
        for n in cols:
            cols[n] = cols[n].clone()
            cols[n][slot] = ins_cols[n][b]
        lts, valid, seq = lts.clone(), valid.clone(), seq.clone()
        lts[slot] = ts[b]
        valid[slot] = True
        seq[slot] = nxt
        nxt = nxt + 1
    return {**state, "cols": cols, "ts": lts, "valid": valid, "seq": seq, "next": nxt}, ovf


def _key_of(x: torch.Tensor, ty: int):
    """(key, matchable) of a key lane as K24's groups read it: a float
    flushed with -0.0 as 0.0, as raw_eq compares; a null (NaN) key matches
    nothing."""
    if ty == TY_FLOAT:
        return (flush_subnormal(x) + 0.0).view(torch.int32).to(torch.int64), ~torch.isnan(x)
    if ty == TY_BOOL:
        return x.to(torch.int64), torch.ones_like(x, dtype=torch.bool)
    null = 0 if ty == TY_ID else torch.iinfo(x.dtype).min
    return x.to(torch.int64), x != null


def table_upsert_groups_ref(scan: ScanPrograms, regs: list, state: dict, rows, ins_cols: dict,
                            ts):
    """The update-or-insert by key groups, as K24 decomposes it on the card
    (csrc/table_scan.cu tg_*), in plain PyTorch: a test aid that the CPU
    tests hold against the JAX package (`table_upsert_scan_ref` stays the
    plain version the kernel is held against). The rows are grouped by key
    in row order; each slot held at step start walks its group's rows; the
    first row of each group with no such slot inserts (rank k in row order
    takes the k-th free slot in ascending order, seq = next + k; a rank at
    or past the free count sets the overflow flag) and its slot walks the
    group's later rows. Only for the equality form with no set clause
    writing the key lane; where a row's insert does not hold its own key,
    the serial walk's result."""
    lane, reg, ty = scan.eq
    name = scan.names[lane]
    x, v = regs[reg], ins_cols[name]
    kx, mx = _key_of(x, ty)
    kv, mv = _key_of(v, ty)
    bad = (mx != mv) | (mx & (kx != kv))
    key_reg = key_set_reg(scan)
    if key_reg is None:
        raise ValueError("the key groups need the equality form, its key lane written by "
                         "no set clause or by the row's own key")
    if key_reg >= 0:
        kr, mr = _key_of(regs[key_reg], ty)
        bad = bad | (mx & ~(mr & (kr == kx)))
    if bool((rows & bad).any()):
        return table_upsert_scan_ref(scan, regs, state, rows, ins_cols, ts)
    cols = {n: c.clone() for n, c in state["cols"].items()}
    lts, valid, seq = state["ts"].clone(), state["valid"].clone(), state["seq"].clone()
    c = valid.shape[0]
    sel = torch.nonzero(rows).flatten().tolist()
    groups: dict = {}
    for b in sel:
        if bool(mx[b]):
            groups.setdefault(int(kx[b]), []).append(b)

    def walk(slots, group_rows):
        for b in group_rows:
            rv = _row(regs, b)
            vals = {n: convert_to(torch.broadcast_to(
                program_ref(sp.code, rv, lane_tensors(sp, cols, lts)), (c,)), cols[n].dtype)
                for n, sp in scan.sets}
            for n, _sp in scan.sets:
                cols[n] = torch.where(slots, vals[n], cols[n])

    kc, mc = _key_of(cols[name], ty)
    held = valid & mc
    has = set()
    for k, group_rows in groups.items():
        slots = held & (kc == k)
        if bool(slots.any()):
            has.add(k)
            walk(slots, group_rows)
    free = torch.nonzero(~valid).flatten().tolist()
    nxt = int(state["next"])
    inserting = [b for b in sel if not bool(mx[b])
                 or (groups[int(kx[b])][0] == b and int(kx[b]) not in has)]
    for k, b in enumerate(inserting[:len(free)]):
        s = free[k]
        for n in cols:
            cols[n][s] = ins_cols[n][b]
        lts[s] = ts[b]
        valid[s] = True
        seq[s] = nxt + k
        if bool(mx[b]):
            one = torch.zeros(c, dtype=torch.bool, device=valid.device)
            one[s] = True
            walk(one, groups[int(kx[b])][1:])
    ovf = torch.tensor(len(inserting) > len(free), device=valid.device)
    n_ins = min(len(inserting), len(free))
    return {**state, "cols": cols, "ts": lts, "valid": valid, "seq": seq,
            "next": state["next"] + n_ins}, ovf


def table_upsert_scan(scan: ScanPrograms, regs: list, state: dict, rows, ins_cols: dict, ts):
    """The update-or-insert: each valid probe row in order updates the
    slots `scan.on` matches (as the earlier rows left the table) with the
    set values, or else takes the first free slot (`ins_cols[column][row]`
    in the table's dtypes, its ts and the next sequence number) or, with no
    free slot, sets the overflow flag. Returns (state', overflow)."""
    if rows.device.type == "cpu":
        return table_upsert_scan_ref(scan, regs, state, rows, ins_cols, ts)
    return _scan_launch(scan, regs, state, rows, upsert=True, ins_cols=ins_cols, ts=ts)


# rows a step of the key-group update-or-insert may hold (csrc/table_scan.cu
# kGroupMaxRows)
GROUP_MAX_ROWS = 1 << 14


def key_set_reg(scan: ScanPrograms) -> Optional[int]:
    """For the equality form (`scan.eq`): -1 when no set clause writes the
    key lane, the register when one writes a register of the lane's type
    into it unchanged (the row's own key, which the kernel checks), else
    None (and with no equality form)."""
    if scan.eq is None:
        return None
    lane, _reg, ty = scan.eq
    if lane not in scan.set_lane:
        return -1
    k = 1 + scan.set_lane.index(lane)
    code = scan._rows[scan.starts[k]:scan.starts[k] + scan.lens[k]]
    if len(code) == 1 and code[0][0] == OP_REG and code[0][2] == ty and scan.tys[k] == ty:
        return code[0][1]
    return None


def by_key_groups(scan: ScanPrograms, b: int, c: int) -> bool:
    """Whether K24 runs an update-or-insert of b rows into c slots by key
    groups (its condition one equality of a table lane and a row register,
    no set clause writing that lane but with the row's own key), else as
    the one-block walk."""
    return key_set_reg(scan) is not None and 1 <= b <= GROUP_MAX_ROWS and c >= 1


def _scan_launch(scan: ScanPrograms, regs, state, rows, upsert: bool, ins_cols=None, ts=None):
    names = scan.names
    lanes = [state["cols"][n] for n in names] + [state["ts"]]
    kernels.require_cuda("table_scan", rows, state["valid"], state["seq"], state["next"],
                         *regs, *lanes, *(ins_cols.values() if upsert else ()),
                         *((ts,) if upsert else ()))
    b = rows.shape[0]
    c = state["valid"].shape[0]
    if len(lanes) > MAX_LANES or len(regs) > MAX_REGS or b >= 2**30 or c >= 2**30:
        raise ValueError(f"table_scan: {len(lanes)} lanes, {len(regs)} registers, B={b}, "
                         f"C={c} out of range")
    dev = rows.device
    new = [x.clone() for x in lanes]
    valid = state["valid"].clone() if upsert else state["valid"]
    seq = state["seq"].clone() if upsert else state["seq"]
    nxt = state["next"].clone()
    flag = torch.empty((), dtype=torch.bool, device=dev)
    code = scan.code(dev)
    A = _Args()
    scratch = torch.empty(max(c, 1), dtype=torch.uint8, device=dev)
    ins = [ins_cols[n] for n in names] if upsert else []
    work = None
    if upsert and by_key_groups(scan, b, c):
        work = torch.empty(kernels.function("tsc_workspace")(b, c), dtype=torch.uint8,
                           device=dev)
    kernels.check(kernels.function("tsc_scan")(
        int(upsert), code.data_ptr(), A.ints(scan.starts), A.ints(scan.lens), A.ints(scan.tys),
        len(scan.lens), len(regs), A.ptrs(regs), A.ints([_ty_of(r.dtype) for r in regs]),
        len(lanes), A.ptrs(new), A.ints([_ty_of(x.dtype) for x in lanes]),
        A.ints(scan.set_lane), -1 if scan.guard is None else scan.guard,
        *(scan.eq if scan.eq is not None else (-1, -1, -1)), rows.data_ptr(), b, c, valid.data_ptr(), seq.data_ptr(), nxt.data_ptr(),
        A.ptrs(ins) if upsert else None, ts.data_ptr() if upsert else None,
        scratch.data_ptr(), flag.data_ptr(), None if work is None else work.data_ptr(),
        -1 if work is None else key_set_reg(scan), kernels.stream()), "table_scan")
    kernels.launches["table_scan"] += 1
    out = {**state, "cols": dict(zip(names, new[:-1]))}
    if upsert:
        out.update(ts=new[-1], valid=valid, seq=seq, next=nxt)
    return out, flag
