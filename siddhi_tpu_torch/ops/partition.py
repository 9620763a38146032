"""The keyed partition steps: the partitioned length window (K29), the
windowed min/max of a partition (K30), the partitioned sliding time window
(K31) and the partitioned batch window (K32); what the keyed pattern
routes (core/pattern.py K34-K37) share: each chunk's member rows by slot
(`pattern_chunks`), each slot's rows and the TIMER rows
(`partition_rows`), and the (position, slot) placement of each slot's
emissions (`pattern_place`); and the join slice's keyed ring view (K38),
keyed probe compaction (K39) and keyed sort and frequent windows (K40,
K41, which take `partition_rows` and `pattern_place` around their walk).

The JAX package runs a partitioned query step under `jax.vmap` over P
partition states (siddhi_tpu/core/partition.py `_vmapped`): every partition
sees the whole batch under a mask and emits a `[P, K]` output, which
`_flatten` orders by output position first and partition slot second. The
port keeps the same rows in a keyed form: each row carries its partition
slot (P = no partition), per-partition state is indexed by slot, and the
output comes out already flattened, ordered by (position within its
partition, slot). For a windowless step the position is the row, so the
order is the arrival order; after a window it is the row's place in its
partition's own output, which is not the arrival order. A TIMER row takes
part in every partition (the vmap's `(active & slot == p) | is_timer`), so
it moves the clock of every slot, used or not.

On the card each step is hand-written CUDA (csrc/partition_window.cu,
csrc/partition_time.cu, csrc/partition_batch.cu, csrc/partition_join.cu,
csrc/special_window.cu, sharing the placement of csrc/partition.cuh);
each `*_ref` beside a wrapper is its plain version,
which the wrapper takes only for tensors on the CPU. Each plain step runs
the unpartitioned plain step (`length_window_step_ref`,
`time_window_step_ref`, `batch_window_step_ref`, `time_batch_step_ref`)
once per slot on that slot's rows and the TIMER rows (the vmap's
semantics) and flattens by (position, slot), so it checks its kernel
independently of the kernel's closed forms.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.event import EventBatch, KIND_CURRENT, KIND_TIMER
from siddhi_tpu_torch.core.join import JoinRows
from siddhi_tpu_torch.core.types import AttrType, flush_subnormal, null_value
from siddhi_tpu_torch.core.windows import (
    BIG,
    NO_TIMER,
    batch_window_step_ref,
    length_window_step_ref,
    time_batch_step_ref,
    time_window_step_ref,
)
from siddhi_tpu_torch.ops.prefix import extreme_identity
from siddhi_tpu_torch.ops.special_window import (
    _KEY_TYPE,
    MAX_SORT_KEYS,
    _gather,
    _lanes_out,
    cron_rows,
    cron_window_step_ref,
    frequent_window_step_ref,
    lossy_frequent_window_step_ref,
    lossy_rows,
    lossy_threshold,
    sort_window_step_ref,
)
from siddhi_tpu_torch.ops.table import _Args


@dataclasses.dataclass
class PartitionMembers:
    """A partitioned window step's index lanes, beside its birth/death
    membership. The elements are P*W per-slot slots, slot-major, then the B
    batch rows: a sliding window's ring (W its size), or a batch window's
    open bucket then previous bucket of each slot (W = 2w).

    slot:       [2B] int32, each output row's partition slot (P: padding)
    first:      [2B] int32, the first output row of the row's slot (the
                row itself for padding): the segment id of the keyed
                running reductions (ops/group.py `Groups.first`)
    rowlist:    [B] int32, the batch's member rows ordered by (slot, rank),
                then -1
    slot_start: [P + 1] int32, where each slot's rows begin in `rowlist`
    elem_slot:  [P*W + B] int64, each element's slot (P: not a member)
    w:          the per-slot element count W
    """

    slot: torch.Tensor
    first: torch.Tensor
    rowlist: torch.Tensor
    slot_start: torch.Tensor
    elem_slot: torch.Tensor
    w: int


def _member_rows(batch: EventBatch, slot: torch.Tensor, p: int):
    """(active [B], rowlist [B], slot_start [P + 1]): the valid CURRENT rows
    of a slot in [0, P), listed by (slot, row)."""
    dev = batch.ts.device
    bsz = batch.capacity
    active = batch.valid & (batch.kind == KIND_CURRENT) & (slot >= 0) & (slot < p)
    key = torch.where(active, slot, p).to(torch.int64)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = torch.bincount(key, minlength=p + 1)[:p].to(torch.int32)
    slot_start = torch.zeros(p + 1, dtype=torch.int32, device=dev)
    slot_start[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    n = int(slot_start[-1])
    rowlist = torch.full((bsz,), -1, dtype=torch.int32, device=dev)
    rowlist[:n] = order[:n]
    return active, rowlist, slot_start


def partition_length_window_step_ref(state: dict, batch: EventBatch, slot: torch.Tensor,
                                     w: int, p: int):
    """Plain version of `partition_length_window_step`: for each slot with
    member rows, `length_window_step_ref` on that slot's ring and rows (in
    row order), then every slot's output rows ordered by (position, slot)."""
    dev = batch.ts.device
    bsz = batch.capacity
    active, rowlist, slot_start = _member_rows(batch, slot, p)
    starts = slot_start.tolist()
    new_state = {
        "cols": {n: c.clone() for n, c in state["cols"].items()},
        "ts": state["ts"].clone(), "wts": state["wts"].clone(), "seq": state["seq"].clone(),
        "total": state["total"] + (slot_start[1:] - slot_start[:-1]).to(torch.int64),
    }
    n_elem = p * w + bsz
    birth = torch.full((n_elem,), -1, dtype=torch.int32, device=dev)
    death = torch.where(state["seq"].reshape(-1) >= 0, BIG, -1).to(torch.int32)
    death = torch.cat([death, torch.full((bsz,), -1, dtype=torch.int32, device=dev)])
    # each live slot's step, in its own position space
    parts = []  # (slot, out rows [n], birth/death positions, element ids)
    for q in range(p):
        lo, hi = starts[q], starts[q + 1]
        if hi == lo:
            continue
        rows = rowlist[lo:hi].long()
        c = hi - lo
        sub = EventBatch(ts=batch.ts[rows], kind=torch.zeros(c, dtype=torch.int8, device=dev),
                         valid=torch.ones(c, dtype=torch.bool, device=dev),
                         cols={n: a[rows] for n, a in batch.cols.items()})
        st = {"cols": {n: a[q] for n, a in state["cols"].items()}, "ts": state["ts"][q],
              "wts": state["wts"][q], "seq": state["seq"][q], "total": state["total"][q]}
        out, b_pos, d_pos, nst = length_window_step_ref(st, sub, w)
        n_out = int(out.valid.sum())
        for n in nst["cols"]:
            new_state["cols"][n][q] = nst["cols"][n]
        for lane in ("ts", "wts", "seq"):
            new_state[lane][q] = nst[lane]
        elems = torch.cat([torch.arange(q * w, (q + 1) * w, device=dev), p * w + rows])
        parts.append((q, out, n_out, b_pos, d_pos, elems))
    # flatten: (position, slot) order over every live slot's rows
    n_rows = sum(x[2] for x in parts)
    if parts:
        pos = torch.cat([torch.arange(x[2], device=dev) for x in parts])
        sl = torch.cat([torch.full((x[2],), x[0], device=dev) for x in parts])
        order = torch.sort(pos * (p + 1) + sl, stable=True).indices
        flat_of = torch.empty_like(order)
        flat_of[order] = torch.arange(n_rows, device=dev)
    n_out = 2 * bsz
    out_ts = torch.zeros(n_out, dtype=torch.int64, device=dev)
    out_kind = torch.zeros(n_out, dtype=torch.int8, device=dev)
    out_valid = torch.zeros(n_out, dtype=torch.bool, device=dev)
    out_cols = {n: torch.zeros(n_out, dtype=a.dtype, device=dev) for n, a in batch.cols.items()}
    out_slot = torch.full((n_out,), p, dtype=torch.int32, device=dev)
    out_first = torch.arange(n_out, dtype=torch.int32, device=dev)
    base = 0
    for q, out, n_q, b_pos, d_pos, elems in parts:
        dst = flat_of[base:base + n_q]
        out_ts[dst] = out.ts[:n_q]
        out_kind[dst] = out.kind[:n_q]
        out_valid[dst] = True
        for n in out_cols:
            out_cols[n][dst] = out.cols[n][:n_q]
        out_slot[dst] = q
        out_first[dst] = dst[0].to(torch.int32)

        def to_flat(x, _dst=dst):
            return torch.where((x >= 0) & (x < BIG), _dst[x.clamp(0, n_q - 1).long()], x).to(
                torch.int32)

        birth[elems] = to_flat(b_pos)
        death[elems] = to_flat(d_pos)
        base += n_q
    elem_slot = torch.cat([torch.arange(p * w, device=dev) // w,
                           torch.where(active, slot, p).to(torch.int64)])
    members = PartitionMembers(slot=out_slot, first=out_first, rowlist=rowlist,
                               slot_start=slot_start, elem_slot=elem_slot, w=w)
    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid, cols=out_cols)
    return out, birth, death, new_state, members


def partition_length_window_step(state: dict, batch: EventBatch, slot: torch.Tensor, w: int,
                                 p: int):
    """One length(w) window step of every partition at once, over a batch of
    B rows that each carry their partition slot.

    state:  the ring of each partition, `length_window_step`'s lanes with a
            leading [P] axis: {"cols": {name: [P, w]}, "ts", "wts", "seq":
            [P, w] int64 (seq -1 = empty), "total": [P] int64}
    slot:   [B] int32, each row's slot; a row takes part when it is valid,
            CURRENT and its slot lies in [0, P) (TIMER and other rows change
            no ring)
    returns (out, birth_pos, death_pos, new_state, members):
      out        [2B] EventBatch: every partition's EXPIRED/CURRENT rows
                 ordered by (position within the partition, slot), the
                 positions those of `length_window_step` on the partition's
                 rows alone; then zeroed padding rows with valid False
      birth_pos / death_pos  [P*w + B] int32: element e (ring slot j of
                 partition q at q*w + j, then batch rows) is in its
                 partition's window at output rows birth <= r < death
                 (absent elements: death -1)
      new_state  the rings after the batch (new tensors)
      members    `PartitionMembers`, the slot and segment lanes of the rows
    """
    if batch.ts.device.type == "cpu":
        return partition_length_window_step_ref(state, batch, slot, w, p)
    lanes = [batch.ts, batch.kind, batch.valid, slot, *batch.cols.values(), state["ts"],
             state["wts"], state["seq"], state["total"], *state["cols"].values()]
    kernels.require_cuda("partition_length_window_step", *lanes)
    bsz = batch.capacity
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, slot,
                                       *batch.cols.values())) or any(
        x.shape != (p, w) for x in (state["ts"], state["wts"], state["seq"],
                                    *state["cols"].values())) or state["total"].shape != (p,):
        raise ValueError(f"partition_length_window_step: lanes must be [{bsz}], ring lanes "
                         f"[{p}, {w}] and totals [{p}]")
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype, slot.dtype, state["seq"].dtype,
            state["total"].dtype) != (torch.int64, torch.int8, torch.bool, torch.int32,
                                      torch.int64, torch.int64) or any(
            state["cols"][n].dtype != a.dtype for n, a in batch.cols.items()):
        raise ValueError("partition_length_window_step: lane dtypes must be int64 ts/seq/total, "
                         "int8 kind, bool valid, int32 slot, and each ring column the batch's")
    if w < 1 or p < 1 or bsz < 1 or p * w + 2 * bsz >= 2**31:
        raise ValueError(f"partition_length_window_step: P {p} x W {w} and B {bsz} out of range")
    dev = batch.ts.device
    n_out, n_elem = 2 * bsz, p * w + bsz

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    rank, rowlist, slot_start = i32(bsz), i32(bsz), i32(p + 1)
    n_slot, n_start, oidx, info = i32(p), i32(p + 1), i32(n_out), i32(4)
    pos_base = i32(n_out + 1)
    counters = i32(max(p, n_out) + 1)
    new_total = torch.empty(p, dtype=torch.int64, device=dev)
    stream = kernels.stream()
    kernels.check(kernels.function("pw_rank")(
        batch.kind.data_ptr(), batch.valid.data_ptr(), slot.data_ptr(),
        state["total"].data_ptr(), bsz, w, p, rank.data_ptr(), rowlist.data_ptr(),
        slot_start.data_ptr(), n_slot.data_ptr(), n_start.data_ptr(), pos_base.data_ptr(),
        oidx.data_ptr(), counters.data_ptr(), new_total.data_ptr(), info.data_ptr(), stream),
        "partition_length_window_step")
    out_ts = torch.empty(n_out, dtype=torch.int64, device=dev)
    out_kind = torch.empty(n_out, dtype=torch.int8, device=dev)
    out_valid = torch.empty(n_out, dtype=torch.bool, device=dev)
    out_slot, out_first, out_src = i32(n_out), i32(n_out), i32(n_out)
    birth, death, ring_src = i32(n_elem), i32(n_elem), i32(p * w)
    elem_slot = torch.empty(n_elem, dtype=torch.int64, device=dev)
    new_seq = torch.empty((p, w), dtype=torch.int64, device=dev)
    kernels.check(kernels.function("pw_emit")(
        batch.ts.data_ptr(), slot.data_ptr(), state["seq"].data_ptr(),
        state["total"].data_ptr(), bsz, w, p, rank.data_ptr(), rowlist.data_ptr(),
        slot_start.data_ptr(), n_start.data_ptr(), oidx.data_ptr(), info.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(), out_slot.data_ptr(),
        out_first.data_ptr(), out_src.data_ptr(), birth.data_ptr(), death.data_ptr(),
        elem_slot.data_ptr(), ring_src.data_ptr(), new_seq.data_ptr(), stream),
        "partition_length_window_step")

    def gather(ring_lane, batch_lane, idx):
        out = torch.empty(idx.shape[0], dtype=ring_lane.dtype, device=dev)
        fn = kernels.function(f"pw_gather_{ring_lane.element_size()}")
        kernels.check(fn(ring_lane.data_ptr(), batch_lane.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), idx.shape[0], p * w, stream),
                      "partition_length_window_step")
        return out

    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid,
                     cols={n: gather(state["cols"][n], a, out_src)
                           for n, a in batch.cols.items()})
    new_state = {
        "cols": {n: gather(state["cols"][n], a, ring_src).view(p, w)
                 for n, a in batch.cols.items()},
        "ts": gather(state["ts"], batch.ts, ring_src).view(p, w),
        "wts": gather(state["wts"], batch.ts, ring_src).view(p, w),
        "seq": new_seq,
        "total": new_total,
    }
    members = PartitionMembers(slot=out_slot, first=out_first, rowlist=rowlist,
                               slot_start=slot_start, elem_slot=elem_slot, w=w)
    kernels.launches["partition_length_window_step"] += 1
    return out, birth, death, new_state, members


def _flat_order(parts, p: int, dev):
    """The flattened row of each part's rows, parts listed slot by slot as
    (slot, n rows): (position within the slot, slot) order, as the JAX
    package's `_flatten` of a [P, K] output, compacted."""
    n_rows = sum(n for _q, n in parts)
    if not n_rows:
        return torch.zeros(0, dtype=torch.int64, device=dev), 0
    pos = torch.cat([torch.arange(n, device=dev) for _q, n in parts])
    sl = torch.cat([torch.full((n,), q, device=dev) for q, n in parts])
    order = torch.sort(pos * (p + 1) + sl, stable=True).indices
    flat_of = torch.empty_like(order)
    flat_of[order] = torch.arange(n_rows, device=dev)
    return flat_of, n_rows


def _sub_batch(batch: EventBatch, rows: torch.Tensor) -> EventBatch:
    """The given rows of a batch, in order, each valid."""
    return EventBatch(ts=batch.ts[rows], kind=batch.kind[rows],
                      valid=torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device),
                      cols={n: a[rows] for n, a in batch.cols.items()})


def _flatten_out(batch: EventBatch, parts, p: int):
    """The flattened output batch of per-slot outputs `parts` [(slot, out,
    n rows)], at least one row, with each row's slot and segment head (the
    slot's first row); returns (out, out_slot, out_first, flat_of per part)."""
    dev = batch.ts.device
    flat_of, n_rows = _flat_order([(q, n) for q, _o, n in parts], p, dev)
    n_out = max(n_rows, 1)
    out_ts = torch.zeros(n_out, dtype=torch.int64, device=dev)
    out_kind = torch.zeros(n_out, dtype=torch.int8, device=dev)
    out_valid = torch.zeros(n_out, dtype=torch.bool, device=dev)
    out_cols = {n: torch.zeros(n_out, dtype=a.dtype, device=dev) for n, a in batch.cols.items()}
    out_slot = torch.full((n_out,), p, dtype=torch.int32, device=dev)
    out_first = torch.arange(n_out, dtype=torch.int32, device=dev)
    dsts = []
    base = 0
    for q, out, n_q in parts:
        dst = flat_of[base:base + n_q]
        out_ts[dst] = out.ts[:n_q]
        out_kind[dst] = out.kind[:n_q]
        out_valid[dst] = True
        for n in out_cols:
            out_cols[n][dst] = out.cols[n][:n_q]
        out_slot[dst] = q
        if n_q:
            out_first[dst] = dst[0].to(torch.int32)
        dsts.append(dst)
        base += n_q
    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid, cols=out_cols)
    return out, out_slot, out_first, dsts


def _to_flat(x: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Positions within a slot's output -> flattened rows (-1 and BIG kept)."""
    n_q = dst.shape[0]
    if n_q == 0:
        return x.to(torch.int32)
    return torch.where((x >= 0) & (x < BIG), dst[x.clamp(0, n_q - 1).long()], x).to(torch.int32)


def _merged_rows(rowlist, lo: int, hi: int, timer_rows: torch.Tensor) -> torch.Tensor:
    """A slot's member rows and the TIMER rows, in row order."""
    rows = rowlist[lo:hi].long()
    if timer_rows.numel():
        rows = torch.sort(torch.cat([rows, timer_rows])).values
    return rows


def partition_time_window_step_ref(state: dict, batch: EventBatch, bwts: torch.Tensor,
                                   slot: torch.Tensor, w: int, t: int, p: int):
    """Plain version of `partition_time_window_step`: for each slot with
    member rows, or with an element a TIMER row of the batch expires,
    `time_window_step_ref` on that slot's ring over its rows and the TIMER
    rows (in row order), then every slot's rows ordered by (position,
    slot). (On any other slot the step changes nothing.)"""
    dev = batch.ts.device
    bsz = batch.capacity
    active, rowlist, slot_start = _member_rows(batch, slot, p)
    timer_rows = torch.nonzero(batch.valid & (batch.kind == KIND_TIMER)).flatten()
    starts = slot_start.tolist()
    new_state = {
        "cols": {n: c.clone() for n, c in state["cols"].items()},
        "ts": state["ts"].clone(), "wts": state["wts"].clone(), "seq": state["seq"].clone(),
        "total": state["total"] + (slot_start[1:] - slot_start[:-1]).to(torch.int64),
    }
    n_elem = p * w + bsz
    birth = torch.full((n_elem,), -1, dtype=torch.int32, device=dev)
    death = torch.where(state["seq"].reshape(-1) >= 0, BIG, -1).to(torch.int32)
    death = torch.cat([death, torch.full((bsz,), -1, dtype=torch.int32, device=dev)])
    # a slot with no rows is a no-op unless a TIMER row reaches the expiry of
    # one of its elements
    reach = bwts[timer_rows].max() if timer_rows.numel() else None
    live_min = torch.where(state["seq"] >= 0, state["wts"], NO_TIMER - t).amin(1).tolist()
    parts, lanes = [], []
    for q in range(p):
        lo, hi = starts[q], starts[q + 1]
        if hi == lo and (reach is None or live_min[q] + t > reach):
            continue
        rows = _merged_rows(rowlist, lo, hi, timer_rows)
        st = {"cols": {n: a[q] for n, a in state["cols"].items()}, "ts": state["ts"][q],
              "wts": state["wts"][q], "seq": state["seq"][q], "total": state["total"][q]}
        out, b_pos, d_pos, nst, _nt = time_window_step_ref(st, _sub_batch(batch, rows),
                                                           bwts[rows], w, t)
        for n in nst["cols"]:
            new_state["cols"][n][q] = nst["cols"][n]
        for lane in ("ts", "wts", "seq"):
            new_state[lane][q] = nst[lane]
        elems = torch.cat([torch.arange(q * w, (q + 1) * w, device=dev), p * w + rows])
        parts.append((q, out, int(out.valid.sum())))
        lanes.append((elems, b_pos, d_pos))
    out, out_slot, out_first, dsts = _flatten_out(batch, parts, p)
    for (elems, b_pos, d_pos), dst in zip(lanes, dsts):
        birth[elems] = _to_flat(b_pos, dst)
        death[elems] = _to_flat(d_pos, dst)
    live_wts = torch.where(new_state["seq"] >= 0, new_state["wts"], NO_TIMER - t)
    next_timer = live_wts.min() + t
    elem_slot = torch.cat([torch.arange(p * w, device=dev) // w,
                           torch.where(active, slot, p).to(torch.int64)])
    members = PartitionMembers(slot=out_slot, first=out_first, rowlist=rowlist,
                               slot_start=slot_start, elem_slot=elem_slot, w=w)
    return out, birth, death, new_state, next_timer, members


def _i32(n, dev):
    return torch.empty(n, dtype=torch.int32, device=dev)


def partition_time_window_step(state: dict, batch: EventBatch, bwts: torch.Tensor,
                               slot: torch.Tensor, w: int, t: int, p: int):
    """One sliding time window step (time, timeLength, externalTime) of
    every partition at once, over a batch of B rows that each carry their
    partition slot.

    state:  each partition's ring, `time_window_step`'s lanes with a leading
            [P] axis: {"cols": {name: [P, w]}, "ts", "wts", "seq": [P, w]
            int64 (seq -1 = empty), "total": [P] int64}
    bwts:   [B] int64, each row's window time
    slot:   [B] int32, each row's slot; a valid CURRENT row with a slot in
            [0, P) is an arrival of its slot, and a valid TIMER row reaches
            every slot (it expires, never inserts)
    returns (out, birth_pos, death_pos, new_state, next_timer, members):
      out        EventBatch of every partition's EXPIRED/CURRENT rows, at
                 least one row, ordered by (position within the partition,
                 slot), the positions those of `time_window_step` on the
                 partition's rows and the TIMER rows alone
      birth_pos / death_pos  [P*w + B] int32 lazy membership of the
                 elements (ring slot j of partition q at q*w + j, then batch
                 rows) in the flattened row space
      new_state  the rings after the batch (new tensors)
      next_timer 0-d int64: the earliest live window time + t of any slot
                 (NO_TIMER when every ring is empty)
      members    `PartitionMembers`
    The output's row count is read back once (one sync a step).
    """
    if batch.ts.device.type == "cpu":
        return partition_time_window_step_ref(state, batch, bwts, slot, w, t, p)
    lanes = [batch.ts, batch.kind, batch.valid, slot, bwts, *batch.cols.values(), state["ts"],
             state["wts"], state["seq"], state["total"], *state["cols"].values()]
    kernels.require_cuda("partition_time_window_step", *lanes)
    bsz = batch.capacity
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, slot, bwts,
                                       *batch.cols.values())) or any(
        x.shape != (p, w) for x in (state["ts"], state["wts"], state["seq"],
                                    *state["cols"].values())) or state["total"].shape != (p,):
        raise ValueError(f"partition_time_window_step: lanes must be [{bsz}], ring lanes "
                         f"[{p}, {w}] and totals [{p}]")
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype, slot.dtype, bwts.dtype,
            state["seq"].dtype, state["wts"].dtype, state["total"].dtype) != (
            torch.int64, torch.int8, torch.bool, torch.int32, torch.int64, torch.int64,
            torch.int64, torch.int64) or any(
            state["cols"][n].dtype != a.dtype for n, a in batch.cols.items()):
        raise ValueError("partition_time_window_step: lane dtypes must be int64 ts/wts/seq/"
                         "total, int8 kind, bool valid, int32 slot, and each ring column the "
                         "batch's")
    if w < 1 or p < 1 or bsz < 1 or p * w + 2 * bsz >= 2**31:
        raise ValueError(f"partition_time_window_step: P {p} x W {w} and B {bsz} out of range")
    dev = batch.ts.device
    stream = kernels.stream()
    cap, n_elem = p * w + 2 * bsz, p * w + bsz
    rows = partition_rows(batch, slot, p, counters=max(p, cap) + 1)
    rank, rowlist, slot_start, timers = rows.rank, rows.rowlist, rows.slot_start, rows.timers
    counters, info = rows.counters, rows.info
    trig, lbirth, ldeath = _i32(n_elem, dev), _i32(n_elem, dev), _i32(n_elem, dev)
    eseq = torch.empty(n_elem, dtype=torch.int64, device=dev)
    loc_src, loc_row = _i32(cap, dev), _i32(cap, dev)
    loc_kind = torch.empty(cap, dtype=torch.int8, device=dev)
    n_slot, ring_src = _i32(p, dev), _i32(p * w, dev)
    new_seq = torch.empty((p, w), dtype=torch.int64, device=dev)
    new_total = torch.empty(p, dtype=torch.int64, device=dev)
    next_timer = torch.full((), NO_TIMER, dtype=torch.int64, device=dev)
    kernels.check(kernels.function("pt_step")(
        bwts.data_ptr(), state["seq"].data_ptr(), state["wts"].data_ptr(),
        state["total"].data_ptr(), bsz, w, p, int(t), rowlist.data_ptr(), slot_start.data_ptr(),
        timers.data_ptr(), info.data_ptr(), trig.data_ptr(), eseq.data_ptr(), loc_src.data_ptr(),
        loc_row.data_ptr(), loc_kind.data_ptr(), n_slot.data_ptr(), lbirth.data_ptr(),
        ldeath.data_ptr(), ring_src.data_ptr(), new_seq.data_ptr(), new_total.data_ptr(),
        next_timer.data_ptr(), stream), "partition_time_window_step")
    n_start, pos_base, oidx = _i32(p + 1, dev), _i32(cap + 1, dev), _i32(cap, dev)
    kernels.check(kernels.function("pt_place")(
        p, n_slot.data_ptr(), n_start.data_ptr(), pos_base.data_ptr(), oidx.data_ptr(),
        counters.data_ptr(), info.data_ptr(), stream), "partition_time_window_step")
    n_out = max(int(info[0]), 1)  # the rows out, read back to size the output
    out_ts = torch.empty(n_out, dtype=torch.int64, device=dev)
    out_kind = torch.empty(n_out, dtype=torch.int8, device=dev)
    out_valid = torch.empty(n_out, dtype=torch.bool, device=dev)
    out_slot, out_first, out_src = _i32(n_out, dev), _i32(n_out, dev), _i32(n_out, dev)
    birth, death = _i32(n_elem, dev), _i32(n_elem, dev)
    elem_slot = torch.empty(n_elem, dtype=torch.int64, device=dev)
    kernels.check(kernels.function("pt_emit")(
        batch.ts.data_ptr(), slot.data_ptr(), bsz, w, p, n_out, rank.data_ptr(),
        slot_start.data_ptr(), n_start.data_ptr(), oidx.data_ptr(), info.data_ptr(),
        loc_src.data_ptr(), loc_row.data_ptr(), loc_kind.data_ptr(), lbirth.data_ptr(),
        ldeath.data_ptr(), out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(),
        out_slot.data_ptr(), out_first.data_ptr(), out_src.data_ptr(), birth.data_ptr(),
        death.data_ptr(), elem_slot.data_ptr(), stream), "partition_time_window_step")

    def gather(ring_lane, batch_lane, idx):
        out = torch.empty(idx.shape[0], dtype=ring_lane.dtype, device=dev)
        fn = kernels.function(f"pt_gather_{ring_lane.element_size()}")
        kernels.check(fn(ring_lane.data_ptr(), batch_lane.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), idx.shape[0], p * w, stream),
                      "partition_time_window_step")
        return out

    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid,
                     cols={n: gather(state["cols"][n], a, out_src)
                           for n, a in batch.cols.items()})
    new_state = {
        "cols": {n: gather(state["cols"][n], a, ring_src).view(p, w)
                 for n, a in batch.cols.items()},
        "ts": gather(state["ts"], batch.ts, ring_src).view(p, w),
        "wts": gather(state["wts"], bwts, ring_src).view(p, w),
        "seq": new_seq,
        "total": new_total,
    }
    members = PartitionMembers(slot=out_slot, first=out_first, rowlist=rowlist,
                               slot_start=slot_start, elem_slot=elem_slot, w=w)
    kernels.launches["partition_time_window_step"] += 1
    return out, birth, death, new_state, next_timer, members


_BATCH_STATE = ("cur_cols", "cur_ts", "cur_n", "prev_cols", "prev_ts", "prev_n", "bucket_start",
                "timeout_deadline")


def _slot_state(state: dict, q: int) -> dict:
    return {k: ({n: a[q] for n, a in v.items()} if isinstance(v, dict) else v[q])
            for k, v in state.items()}


def _batch_elem_slot(slot, rank_member, p: int, w: int):
    """The slot of each batch-window element ([P, 2w] bucket slots, then the
    batch rows; P for a row of no slot)."""
    dev = slot.device
    return torch.cat([torch.arange(2 * p * w, device=dev) // (2 * w),
                      torch.where(rank_member, slot, p).to(torch.int64)])


def partition_batch_window_step_ref(state: dict, batch: EventBatch, wts: torch.Tensor,
                                    now: torch.Tensor, slot: torch.Tensor, p: int, w: int,
                                    n, t, start_time, timeout_ms, timer_mode: int,
                                    emit_expired: bool):
    """Plain version of `partition_batch_window_step`: for each slot with
    member rows (lengthBatch), or every slot (the time branch: a TIMER row
    reaches every slot, and a grid with a start time starts in every slot),
    `batch_window_step_ref` / `time_batch_step_ref` on that slot's buffers
    over its rows and the TIMER rows (in row order; a slot with no rows
    gets one invalid row, as the vmap masks every row), then every slot's
    rows ordered by (position, slot)."""
    dev = batch.ts.device
    bsz = batch.capacity
    timed = n is None
    active, rowlist, slot_start = _member_rows(batch, slot, p)
    timer_rows = (torch.nonzero(batch.valid & (batch.kind == KIND_TIMER)).flatten() if timed
                  else torch.zeros(0, dtype=torch.int64, device=dev))
    starts = slot_start.tolist()
    new_state = {k: ({n_: a.clone() for n_, a in v.items()} if isinstance(v, dict)
                     else v.clone()) for k, v in state.items()}
    n_elem = 2 * p * w + bsz
    birth = death = None
    if emit_expired:
        birth = torch.full((n_elem,), BIG, dtype=torch.int32, device=dev)
        death = torch.full((n_elem,), BIG, dtype=torch.int32, device=dev)
        death[:2 * p * w].view(p, 2 * w)[:, w:] = -1
    next_timer = torch.full((), NO_TIMER, dtype=torch.int64, device=dev)
    parts, lanes = [], []
    for q in range(p):
        lo, hi = starts[q], starts[q + 1]
        if not timed and hi == lo:
            continue
        rows = _merged_rows(rowlist, lo, hi, timer_rows)
        if rows.numel():
            sub = _sub_batch(batch, rows)
        else:  # a slot with no rows sees every row masked
            rows = torch.zeros(1, dtype=torch.int64, device=dev)
            sub = dataclasses.replace(_sub_batch(batch, rows),
                                      valid=torch.zeros(1, dtype=torch.bool, device=dev))
        st = _slot_state(state, q)
        if timed:
            out, b_pos, d_pos, nst, nt = time_batch_step_ref(
                st, sub, wts[rows], now, w, t, start_time, timeout_ms, timer_mode, emit_expired)
            next_timer = torch.minimum(next_timer, nt)
        else:
            out, b_pos, d_pos, nst = batch_window_step_ref(st, sub, n, emit_expired)
        for k in _BATCH_STATE:
            if isinstance(nst[k], dict):
                for n_, a in nst[k].items():
                    new_state[k][n_][q] = a
            else:
                new_state[k][q] = nst[k]
        parts.append((q, out, int(out.valid.sum())))
        if emit_expired:
            real = sub.valid & (sub.kind == KIND_CURRENT)
            elems = torch.cat([torch.arange(2 * q * w, 2 * (q + 1) * w, device=dev),
                               2 * p * w + rows[real]])
            sel = torch.cat([torch.ones(2 * w, dtype=torch.bool, device=dev), real])
            lanes.append((elems, b_pos[sel], d_pos[sel]))
        else:
            lanes.append(None)
    out, out_slot, out_first, dsts = _flatten_out(batch, parts, p)
    if emit_expired:
        for (elems, b_pos, d_pos), dst in zip(lanes, dsts):
            birth[elems] = _to_flat(b_pos, dst)
            death[elems] = _to_flat(d_pos, dst)
    members = PartitionMembers(slot=out_slot, first=out_first, rowlist=rowlist,
                               slot_start=slot_start,
                               elem_slot=_batch_elem_slot(slot, active, p, w), w=2 * w)
    return out, birth, death, new_state, next_timer, members


def partition_batch_window_step(state: dict, batch: EventBatch, wts: torch.Tensor,
                                now: torch.Tensor, slot: torch.Tensor, p: int, w: int, n, t,
                                start_time, timeout_ms, timer_mode: int, emit_expired: bool):
    """One batch window step (lengthBatch(n) when `n` is given, else the
    time branch of timeBatch / externalTimeBatch with duration t) of every
    partition at once, over a batch of B rows that each carry their
    partition slot.

    state:  each partition's buffers, `batch_window_step`'s lanes with a
            leading [P] axis: {"cur_cols": {name: [P, w]}, "cur_ts": [P, w],
            "cur_n": [P] int32, "prev_cols", "prev_ts", "prev_n",
            "bucket_start", "timeout_deadline": [P] int64}
    wts:    [B] int64 window time of each row (the time branch); now: 0-d
            int64 clock; start_time, timeout_ms, timer_mode as
            `time_batch_step`'s
    slot:   [B] int32; a valid CURRENT row with a slot in [0, P) is an
            arrival of its slot; a valid TIMER row reaches every slot (the
            time branch)
    returns (out, birth_pos, death_pos, new_state, next_timer, members):
      out        EventBatch of every partition's flushes (EXPIRED, RESET,
                 CURRENT rows), at least one row, ordered by (position
                 within the partition, slot)
      birth_pos / death_pos  [2*P*w + B] int32 lazy membership of the
                 elements (slot q's open bucket slot j at 2qw + j, its
                 previous bucket slot j at 2qw + w + j, then batch rows) in
                 the flattened row space; None without the EXPIRED lanes
      new_state  the buffers, counts, bucket starts and idle deadlines
      next_timer 0-d int64: the earliest timer of any slot (NO_TIMER: none)
      members    `PartitionMembers` (per-slot elements 2w)
    The TIMER row count and the output's row count are read back (two
    syncs a step).
    """
    if batch.ts.device.type == "cpu":
        return partition_batch_window_step_ref(state, batch, wts, now, slot, p, w, n, t,
                                               start_time, timeout_ms, timer_mode, emit_expired)
    bufs = [state["cur_ts"], state["prev_ts"], *state["cur_cols"].values(),
            *state["prev_cols"].values()]
    scalars = [state[k] for k in ("cur_n", "prev_n", "bucket_start", "timeout_deadline")]
    kernels.require_cuda("partition_batch_window_step", batch.ts, batch.kind, batch.valid, slot,
                         wts, now, *batch.cols.values(), *bufs, *scalars)
    bsz = batch.capacity
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, slot, wts,
                                       *batch.cols.values())) or any(
            x.shape != (p, w) for x in bufs) or any(x.shape != (p,) for x in scalars):
        raise ValueError(f"partition_batch_window_step: lanes must be [{bsz}], buffers "
                         f"[{p}, {w}] and counts [{p}]")
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype, slot.dtype, wts.dtype, now.dtype,
            *(x.dtype for x in scalars)) != (
            torch.int64, torch.int8, torch.bool, torch.int32, torch.int64, torch.int64,
            torch.int32, torch.int32, torch.int64, torch.int64) or any(
            state["cur_cols"][c].dtype != a.dtype or state["prev_cols"][c].dtype != a.dtype
            for c, a in batch.cols.items()) or now.shape != ():
        raise ValueError("partition_batch_window_step: lane dtypes must be int64 ts/times, int8 "
                         "kind, bool valid, int32 slot and counts, a 0-d int64 clock, and each "
                         "buffer column the batch's")
    timed = n is None
    if w < 1 or p < 1 or bsz < 1 or (timed and t < 1) or (not timed and n != w):
        raise ValueError(f"partition_batch_window_step: P {p}, w {w}, n {n}, t {t} out of range")
    dev = batch.ts.device
    stream = kernels.stream()
    lists = _row_lists("partition_batch_window_step", batch, slot, p, 0)
    rank, rowlist, slot_start, timers = lists.rank, lists.rowlist, lists.slot_start, lists.timers
    info = lists.info
    n_timers = int(info[3]) if timed else 0  # a TIMER row flushes in every slot
    stride = (3 * w if emit_expired else w) + n_timers + 1
    cap = p * stride + (3 if emit_expired else 2) * bsz
    n_elem = 2 * p * w + bsz
    if cap >= 2**31 or n_elem >= 2**31:
        raise ValueError(f"partition_batch_window_step: P {p} x w {w} and B {bsz} out of range")
    loc_src, loc_row = _i32(cap, dev), _i32(cap, dev)
    loc_kind = torch.empty(cap, dtype=torch.int8, device=dev)
    n_slot = _i32(p, dev)
    lbirth, ldeath = (_i32(n_elem, dev), _i32(n_elem, dev)) if emit_expired else (n_slot, n_slot)
    cur_src, prev_src = _i32(p * w, dev), _i32(p * w, dev)
    new_cur_n, new_prev_n = _i32(p, dev), _i32(p, dev)
    new_bs = torch.empty(p, dtype=torch.int64, device=dev)
    new_dl = torch.empty(p, dtype=torch.int64, device=dev)
    next_timer = torch.full((), NO_TIMER, dtype=torch.int64, device=dev)
    kernels.check(kernels.function("pb_step")(
        bsz, w, p, int(n or 0), int(timed), int(emit_expired), int(start_time is not None),
        int(timer_mode), int(t or 0), int(start_time or 0), int(timeout_ms or 0), wts.data_ptr(),
        rowlist.data_ptr(), slot_start.data_ptr(), timers.data_ptr(), info.data_ptr(),
        state["cur_n"].data_ptr(), state["prev_n"].data_ptr(), state["bucket_start"].data_ptr(),
        state["timeout_deadline"].data_ptr(), now.data_ptr(), loc_src.data_ptr(),
        loc_row.data_ptr(), loc_kind.data_ptr(), n_slot.data_ptr(), lbirth.data_ptr(),
        ldeath.data_ptr(), cur_src.data_ptr(), prev_src.data_ptr(), new_cur_n.data_ptr(),
        new_prev_n.data_ptr(), new_bs.data_ptr(), new_dl.data_ptr(), next_timer.data_ptr(),
        stream), "partition_batch_window_step")
    n_start, pos_base, oidx = _i32(p + 1, dev), _i32(cap + 1, dev), _i32(cap, dev)
    counters = _i32(max(p, cap) + 1, dev)
    kernels.check(kernels.function("pb_place")(
        p, n_slot.data_ptr(), n_start.data_ptr(), pos_base.data_ptr(), oidx.data_ptr(),
        counters.data_ptr(), info.data_ptr(), stream), "partition_batch_window_step")
    n_out = max(int(info[0]), 1)  # the rows out, read back to size the output
    out_ts = torch.empty(n_out, dtype=torch.int64, device=dev)
    out_kind = torch.empty(n_out, dtype=torch.int8, device=dev)
    out_valid = torch.empty(n_out, dtype=torch.bool, device=dev)
    out_slot, out_first, out_src = _i32(n_out, dev), _i32(n_out, dev), _i32(n_out, dev)
    birth = death = None
    if emit_expired:
        birth, death = _i32(n_elem, dev), _i32(n_elem, dev)
    kernels.check(kernels.function("pb_emit")(
        batch.ts.data_ptr(), state["cur_ts"].data_ptr(), state["prev_ts"].data_ptr(),
        slot.data_ptr(), bsz, w, p, n_out, stride, int(emit_expired), rank.data_ptr(),
        slot_start.data_ptr(), n_start.data_ptr(), oidx.data_ptr(), info.data_ptr(),
        loc_src.data_ptr(), loc_row.data_ptr(), loc_kind.data_ptr(), lbirth.data_ptr(),
        ldeath.data_ptr(), out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(),
        out_slot.data_ptr(), out_first.data_ptr(), out_src.data_ptr(),
        birth.data_ptr() if emit_expired else None, death.data_ptr() if emit_expired else None,
        stream), "partition_batch_window_step")

    def gather(cur, prev, bat, idx):
        out = torch.empty(idx.shape[0], dtype=cur.dtype, device=dev)
        fn = kernels.function(f"pb_gather_{cur.element_size()}")
        kernels.check(fn(cur.data_ptr(), prev.data_ptr(), bat.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), idx.shape[0], w, p, stream),
                      "partition_batch_window_step")
        return out

    sc, sp = state["cur_cols"], state["prev_cols"]
    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid,
                     cols={c: gather(sc[c], sp[c], a, out_src) for c, a in batch.cols.items()})
    new_state = {
        "cur_cols": {c: gather(sc[c], sp[c], a, cur_src).view(p, w)
                     for c, a in batch.cols.items()},
        "cur_ts": gather(state["cur_ts"], state["prev_ts"], batch.ts, cur_src).view(p, w),
        "cur_n": new_cur_n,
        "prev_cols": {c: gather(sc[c], sp[c], a, prev_src).view(p, w)
                      for c, a in batch.cols.items()},
        "prev_ts": gather(state["cur_ts"], state["prev_ts"], batch.ts, prev_src).view(p, w),
        "prev_n": new_prev_n,
        "bucket_start": new_bs,
        "timeout_deadline": new_dl,
    }
    members = PartitionMembers(slot=out_slot, first=out_first, rowlist=rowlist,
                               slot_start=slot_start,
                               elem_slot=_batch_elem_slot(slot, rank >= 0, p, w), w=2 * w)
    kernels.launches["partition_batch_window_step"] += 1
    return out, birth, death, new_state, next_timer, members


def _fold_extreme(red, v, member, is_min: bool):
    """One step of the kernel's fold: a NaN member sticks; otherwise a
    strictly smaller (larger) member replaces the running value."""
    if v.dtype.is_floating_point:
        take = torch.isnan(v) | (v < red if is_min else v > red)
        take = take & ~torch.isnan(red)
    else:
        take = v < red if is_min else v > red
    return torch.where(member & take, v, red)


def partition_window_extreme_ref(vals, birth_pos, death_pos, row_slot, rowlist, slot_start,
                                 w: int, is_min: bool, t: AttrType, chunk: int = 8192):
    """Plain version of `partition_window_extreme`: the masked reduction of
    each row over its slot's elements (the slot's W ring slots, then its
    batch rows in rank order), gathered as a [rows, W + max rows] matrix,
    `chunk` rows at a time, folded column by column in that order (a NaN
    member sticks, ties keep the first: the kernel's order, so -0.0 and 0.0
    come out bit for bit)."""
    dev = vals.device
    p = slot_start.shape[0] - 1
    n_rows = row_slot.shape[0]
    ident = extreme_identity(vals.dtype, is_min).to(dev)
    null = torch.tensor(null_value(t), dtype=vals.dtype, device=dev)
    vals = flush_subnormal(vals)  # a float32 subnormal as a zero (XLA's CPU code)
    counts = (slot_start[1:] - slot_start[:-1]).long()
    maxc = int(counts.max()) if p else 0
    k = torch.arange(maxc, device=dev)
    idx = (slot_start[:-1, None].long() + k[None, :]).clamp(max=max(rowlist.shape[0] - 1, 0))
    batch_e = torch.where(k[None, :] < counts[:, None], p * w + rowlist[idx].long(), -1)
    elems = torch.cat([torch.arange(p * w, device=dev).view(p, w), batch_e], 1)  # [P, W + maxc]
    out = []
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        rs = row_slot[lo:hi].long()
        live = (rs >= 0) & (rs < p)
        e = elems[rs.clamp(0, p - 1)]
        ok = live[:, None] & (e >= 0)
        e = e.clamp(min=0)
        r = torch.arange(lo, hi, device=dev)[:, None]
        member = ok & (birth_pos[e] <= r) & (r < death_pos[e])
        v = vals[e]
        red = ident.expand(hi - lo).clone()
        for j in range(e.shape[1]):
            red = _fold_extreme(red, v[:, j], member[:, j], is_min)
        out.append(torch.where(red == ident, null, red))
    return torch.cat(out) if out else torch.empty(0, dtype=vals.dtype, device=dev)


def partition_window_extreme(vals, birth_pos, death_pos, row_slot, rowlist, slot_start,
                             w: int, is_min: bool, t: AttrType):
    """Per output row r of a partitioned length-window step, the min/max of
    vals[e] over the elements of the row's own slot alive at r
    (birth_pos[e] <= r < death_pos[e]); the null sentinel of logical type
    `t` where none is, and on rows whose slot is not in [0, P).

    vals: [P*W + B] float32/int32/int64 (ring slots slot-major, then batch
    rows); birth_pos, death_pos: [P*W + B] int32; row_slot: [rows] int32;
    rowlist [B] and slot_start [P + 1] int32: `PartitionMembers`' lanes.
    A row reads only its slot's W ring slots and member rows.
    """
    if vals.device.type == "cpu":
        return partition_window_extreme_ref(vals, birth_pos, death_pos, row_slot, rowlist,
                                            slot_start, w, is_min, t)
    kernels.require_cuda("partition_window_extreme", vals, birth_pos, death_pos, row_slot,
                         rowlist, slot_start)
    from siddhi_tpu_torch.core.aggregators import _null_bits
    from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE

    suffix = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64"}.get(vals.dtype)
    p = slot_start.shape[0] - 1
    bsz = rowlist.shape[0]
    k = vals.shape[0]
    n_rows = row_slot.shape[0]
    if (suffix is None or PHYSICAL_DTYPE[t] != vals.dtype or p < 1 or k != p * w + bsz
            or birth_pos.shape != (k,) or death_pos.shape != (k,)
            or any(x.dtype != torch.int32 for x in (birth_pos, death_pos, row_slot, rowlist,
                                                    slot_start))):
        raise ValueError(
            "partition_window_extreme takes [P*W + B] float32/int32/int64 vals of type "
            f"{t!r}, [P*W + B] int32 birth/death and int32 slot lanes; got "
            f"{vals.dtype}{list(vals.shape)} with P={p}, W={w}, B={bsz}")
    out = torch.empty(n_rows, dtype=vals.dtype, device=vals.device)
    kernels.check(kernels.function(f"pw_extreme_{suffix}")(
        vals.data_ptr(), birth_pos.data_ptr(), death_pos.data_ptr(), row_slot.data_ptr(),
        rowlist.data_ptr(), slot_start.data_ptr(), out.data_ptr(), n_rows, p, w,
        int(is_min), _null_bits(t), kernels.stream()), "partition_window_extreme")
    kernels.launches["partition_window_extreme"] += 1
    return out


# ---------------------------------------------------------------------------
# the keyed pattern routes' row lists and emission placement (K34-K37)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PatternChunks:
    """A step's batch cut into k chunks of C rows (the JAX package's chunks
    of the whole batch, padded with rows of no partition), for the keyed
    batch routes of core/pattern.py.

    ts:       [k*C] int64 row timestamps
    v:        [k*C] bool, the member rows (valid, CURRENT, slot in [0, P))
    slot:     [k*C] int32, each row's slot (P: none)
    rows:     [P] int32, each slot's member rows in the batch
    srow:     [k*C] int32, chunk i's member rows by (slot, row) at i*C, then
              -1
    seg_slot, seg_lo, seg_hi: [k*C] int32, chunk i's segment s at i*C + s:
              its slot and its rows srow[lo:hi] (absolute)
    nseg:     [k] int32, each chunk's segments
    """

    C: int
    k: int
    p: int
    ts: torch.Tensor
    v: torch.Tensor
    slot: torch.Tensor
    rows: torch.Tensor
    srow: torch.Tensor
    seg_slot: torch.Tensor
    seg_lo: torch.Tensor
    seg_hi: torch.Tensor
    nseg: torch.Tensor


def pattern_chunks_ref(ts: torch.Tensor, v: torch.Tensor, slot: torch.Tensor, C: int,
                       p: int) -> PatternChunks:
    """Plain version of `pattern_chunks`: a stable sort by (chunk, slot)."""
    dev = ts.device
    n = ts.shape[0]
    k = n // C
    idx = torch.arange(n, device=dev)
    chunk = idx // C
    key = chunk * (p + 1) + torch.where(v, slot.long(), p)
    order = torch.sort(key, stable=True).indices
    mem = v[order]
    srow = torch.where(mem, order, -1).to(torch.int32)
    sk = key[order]
    pos = idx % C
    prev = torch.cat([torch.full((1,), -1, dtype=sk.dtype, device=dev), sk[:-1]])
    start = mem & ((pos == 0) | (sk != prev))
    nxt = torch.cat([sk[1:], torch.full((1,), -1, dtype=sk.dtype, device=dev)])
    nmem = torch.cat([mem[1:], torch.zeros(1, dtype=torch.bool, device=dev)])
    end = mem & ((pos == C - 1) | (nxt != sk) | ~nmem)
    starts = start.view(k, C).to(torch.int64)
    seg_of = (torch.cumsum(starts, 1) - 1).view(-1)  # a member row's segment in its chunk
    at = (chunk * C + seg_of).clamp(min=0)
    seg_slot = torch.full((n,), p, dtype=torch.int32, device=dev)
    seg_lo = torch.zeros(n, dtype=torch.int32, device=dev)
    seg_hi = torch.zeros(n, dtype=torch.int32, device=dev)
    seg_slot[at[start]] = slot[order][start].to(torch.int32)
    seg_lo[at[start]] = idx[start].to(torch.int32)
    seg_hi[at[end]] = (idx[end] + 1).to(torch.int32)
    rows = torch.bincount(slot[v].long(), minlength=p)[:p].to(torch.int32)
    return PatternChunks(C=C, k=k, p=p, ts=ts, v=v, slot=slot, rows=rows, srow=srow,
                         seg_slot=seg_slot, seg_lo=seg_lo, seg_hi=seg_hi,
                         nseg=starts.sum(1).to(torch.int32))


def pattern_chunks(ts: torch.Tensor, v: torch.Tensor, slot: torch.Tensor, C: int,
                   p: int) -> PatternChunks:
    """The chunks of a padded batch of k*C rows for the keyed batch routes:
    each chunk's member rows listed by (slot, row) with its (slot, rows)
    segments, and each slot's member rows in the batch. ts [k*C] int64, v
    [k*C] bool (the member rows), slot [k*C] int32. One block a chunk on
    the card (csrc/partition_pattern.cu `pp_chunks`)."""
    if ts.device.type == "cpu":
        return pattern_chunks_ref(ts, v, slot, C, p)
    kernels.require_cuda("pattern_chunks", ts, v, slot)
    n = ts.shape[0]
    if n % C or v.shape != (n,) or slot.shape != (n,) or slot.dtype != torch.int32 or p < 1:
        raise ValueError(f"pattern_chunks: [{n}] lanes in chunks of {C}, int32 slots")
    dev = ts.device
    k = n // C
    srow, seg_slot, seg_lo, seg_hi = _i32(n, dev), _i32(n, dev), _i32(n, dev), _i32(n, dev)
    nseg, rows = _i32(k, dev), _i32(p, dev)
    scratch = _i32(k * (C + 2 * p + 1), dev)
    kernels.check(kernels.function("pp_chunks")(
        v.data_ptr(), slot.data_ptr(), n, C, p, srow.data_ptr(), seg_slot.data_ptr(),
        seg_lo.data_ptr(), seg_hi.data_ptr(), nseg.data_ptr(), rows.data_ptr(),
        scratch.data_ptr(), kernels.stream()), "pattern_chunks")
    kernels.launches["pattern_chunks"] += 1
    return PatternChunks(C=C, k=k, p=p, ts=ts, v=v, slot=slot, rows=rows, srow=srow,
                         seg_slot=seg_slot, seg_lo=seg_lo, seg_hi=seg_hi, nseg=nseg)


@dataclasses.dataclass
class PartitionRows:
    """A batch's member rows by slot and its TIMER rows (the keyed scan's
    rows). rowlist [B] int32 by (slot, row), then -1; slot_start [P + 1]
    int32; timers [B] int32 the TIMER rows in row order, then unspecified;
    info [4] int32 with info[3] the TIMER row count (device lanes); rows
    [P] int32 each slot's member rows; on the card also rank [B] int32
    each row's place in its slot's list and the counters scratch, which
    K31's later kernels reuse."""

    rowlist: torch.Tensor
    slot_start: torch.Tensor
    timers: torch.Tensor
    info: torch.Tensor
    rows: torch.Tensor
    rank: Optional[torch.Tensor] = None
    counters: Optional[torch.Tensor] = None


def partition_rows_ref(batch: EventBatch, slot: torch.Tensor, p: int) -> PartitionRows:
    """Plain version of `partition_rows`."""
    dev = batch.ts.device
    _active, rowlist, slot_start = _member_rows(batch, slot, p)
    timers = torch.nonzero(batch.valid & (batch.kind == KIND_TIMER)).flatten().to(torch.int32)
    info = torch.tensor([0, 0, 0, timers.numel()], dtype=torch.int32, device=dev)
    return PartitionRows(rowlist=rowlist, slot_start=slot_start, timers=timers, info=info,
                         rows=(slot_start[1:] - slot_start[:-1]).to(torch.int32))


_ROWS_SORT_WORDS: dict = {}  # (B, P) -> the sort's int32 words of the workspace


def _row_lists(what: str, batch: EventBatch, slot: torch.Tensor, p: int,
               counters: int) -> PartitionRows:
    """The row lists on the card through `pt_rows` (csrc/partition_rows.cuh's
    launch), for K31, K32 and K37: every lane, a `counters`-long scratch
    for the caller's later kernels and the sort's own scratch, carved from
    one int32 workspace (one allocation a call: a TIMER step's batch of one
    row is all wrapper)."""
    bsz = batch.capacity
    dev = batch.ts.device
    kernels.require_cuda(what, batch.kind, batch.valid, slot)
    if slot.dtype != torch.int32 or slot.shape != (bsz,) or p < 1:
        raise ValueError(f"{what}: int32 [{bsz}] slots and P >= 1 expected")
    key = (bsz, p)
    words = _ROWS_SORT_WORDS.get(key)
    if words is None:  # 256-byte aligned, so the lanes after it keep the carve's alignment
        words = _ROWS_SORT_WORDS[key] = -(-kernels.function("pt_rows_workspace")(bsz, p)
                                          // 256) * 64
    ws = torch.empty(words + 4 + 3 * bsz + (p + 1) + p + counters, dtype=torch.int32,
                     device=dev)
    cuts = [words, 4, bsz, bsz, bsz, p + 1, p, counters]
    _sort, info, rank, rowlist, timers, slot_start, rows, scratch = torch.split(ws, cuts)
    kernels.check(kernels.function("pt_rows")(
        batch.kind.data_ptr(), batch.valid.data_ptr(), slot.data_ptr(), bsz, p, rank.data_ptr(),
        rowlist.data_ptr(), slot_start.data_ptr(), timers.data_ptr(),
        rows.data_ptr(), info.data_ptr(), ws.data_ptr(),
        kernels.stream()), what)
    return PartitionRows(rowlist=rowlist, slot_start=slot_start, timers=timers, info=info,
                         rows=rows, rank=rank, counters=scratch)


def partition_rows(batch: EventBatch, slot: torch.Tensor, p: int,
                   counters: Optional[int] = None) -> PartitionRows:
    """Each slot's member rows (valid CURRENT rows with a slot in [0, P))
    and the TIMER rows. On the card, one stable sort of the rows by slot
    (csrc/partition_rows.cuh through `pt_rows`; K31 and K37 take its lists);
    counters: the scratch's size (at least P + 1, the default)."""
    if batch.ts.device.type == "cpu":
        return partition_rows_ref(batch, slot, p)
    out = _row_lists("partition_rows", batch, slot, p, max(counters or 0, p + 1))
    kernels.launches["partition_rows"] += 1
    return out


def pattern_place_ref(out: dict, off, cap, n, p: int):
    """Plain version of `pattern_place`, by `_flat_order`."""
    dev = off.device
    nq = torch.minimum(n, cap).tolist()
    parts = [(q, c) for q, c in enumerate(nq) if c]
    flat_of, total = _flat_order(parts, p, dev)
    src = torch.cat([int(off[q]) + torch.arange(c, device=dev) for q, c in parts]) if parts \
        else flat_of
    rows = max(total, 1)
    res = {}
    for name, lane in out.items():
        o = torch.zeros((rows,) + tuple(lane.shape[1:]), dtype=lane.dtype, device=dev)
        o[flat_of] = lane[src]
        res[name] = o
    out_slot = torch.full((rows,), p, dtype=torch.int32, device=dev)
    out_first = torch.arange(rows, dtype=torch.int32, device=dev)
    base = 0
    for q, c in parts:
        dst = flat_of[base:base + c]
        out_slot[dst] = q
        out_first[dst] = dst[0].to(torch.int32)
        base += c
    return res, out_slot, out_first


def pattern_place(out: dict, off: torch.Tensor, cap: torch.Tensor, n: torch.Tensor, p: int):
    """The flattened rows of the keyed emission stretches: slot q's first
    min(n[q], cap[q]) rows at out rows off[q].. go to (position within the
    slot, slot) order, the JAX package's `_flatten` of a [P, out_cap]
    emission, compacted. out: {lane: [E] or [E, K]}; off [P] int64; cap,
    n [P] int32. Returns (lanes with max(rows, 1) rows, valid False past
    the rows; out_slot [rows] int32, P past them; out_first [rows] int32,
    each row's slot's first row). One host read: the row count. On the
    card partition.cuh's placement, then a gather
    (csrc/partition_pattern.cu `pp_place`)."""
    if off.device.type == "cpu":
        return pattern_place_ref(out, off, cap, n, p)
    kernels.require_cuda("pattern_place", off, cap, n, *out.values())
    dev = off.device
    nq = _i32(p, dev)
    n_start, info = _i32(p + 1, dev), torch.zeros(4, dtype=torch.int32, device=dev)
    e = out["valid"].shape[0]
    pos_base, oidx, counters = _i32(e + 2, dev), _i32(e + 1, dev), _i32(max(p, e) + 1, dev)
    stream = kernels.stream()
    kernels.check(kernels.function("pp_place")(
        p, n.data_ptr(), cap.data_ptr(), nq.data_ptr(), n_start.data_ptr(), pos_base.data_ptr(),
        oidx.data_ptr(), counters.data_ptr(), info.data_ptr(), stream), "pattern_place")
    total = int(info[0])  # the rows out, read back to size the output
    rows = max(total, 1)
    out_slot, out_first, src = _i32(rows, dev), _i32(rows, dev), _i32(rows, dev)
    kernels.check(kernels.function("pp_place_rows")(
        p, rows, off.data_ptr(), nq.data_ptr(), n_start.data_ptr(), oidx.data_ptr(),
        info.data_ptr(), out_slot.data_ptr(), out_first.data_ptr(), src.data_ptr(), stream),
        "pattern_place")
    res = {}
    for name, lane in out.items():
        w = lane.shape[1] if lane.dim() == 2 else 1
        o = torch.empty((rows,) + tuple(lane.shape[1:]), dtype=lane.dtype, device=dev)
        kernels.check(kernels.function("pp_gather")(
            lane.data_ptr(), src.data_ptr(), o.data_ptr(), rows, w, lane.element_size(), stream),
            "pattern_place")
        res[name] = o
    kernels.launches["pattern_place"] += 1
    return res, out_slot, out_first


# ---------------------------------------------------------------------------
# joins and the sort and frequent windows inside a partition (K38-K41)
# ---------------------------------------------------------------------------


def partition_ring_view_ref(state: dict):
    """Plain version of `partition_ring_view`: each slot's stable argsort
    of seq (empty slots last, in slot order), every lane gathered along
    the slot's row (`ring_view_ref` batched over the [P] axis)."""
    mask = state["seq"] >= 0
    perm = torch.argsort(torch.where(mask, state["seq"], NO_TIMER), dim=1, stable=True)
    cols = {n: torch.gather(c, 1, perm) for n, c in state["cols"].items()}
    return cols, torch.gather(state["ts"], 1, perm), torch.gather(mask, 1, perm)


def _pj_view_scratch(w: int) -> bool:
    """Whether K38 keeps its slots' `slot_at` rows in a global scratch: a
    block's rows past kViewSharedSlots (csrc/partition_join.cu; a group of
    G threads a slot, G the least power of two from 32 to 1,024 at or past
    W, blocks of max(G, 256) threads)."""
    g = 32
    while g < w and g < 1024:
        g *= 2
    return max(g, 256) // g * w > 56 * 1024


def partition_ring_view(state: dict):
    """Every partition's sliding ring in insertion order, for a join side's
    probe inside a partition: (cols {name: [P, W]}, ts [P, W], mask
    [P, W]); row q holds slot q's live elements first by seq, then its
    empty ring slots in slot order (the JAX package's `view` under the
    vmap). A slot's live seqs lie in [total[q] - W, total[q]), so the order
    is a rank over that dense range, and one launch places every lane and
    the mask (csrc/partition_join.cu `pj_view`)."""
    if state["seq"].device.type == "cpu":
        return partition_ring_view_ref(state)
    names = list(state["cols"])
    lanes = [state["cols"][n] for n in names] + [state["ts"]]
    kernels.require_cuda("partition_ring_view", state["seq"], state["total"], *lanes)
    p, w = state["seq"].shape
    if state["seq"].dtype != torch.int64 or state["total"].dtype != torch.int64 or \
            state["total"].shape != (p,) or any(x.shape != (p, w) for x in lanes):
        raise ValueError(f"partition_ring_view: int64 seq/total, [{p}, {w}] ring lanes and "
                         f"[{p}] totals expected")
    if p * w >= 2**31:
        raise ValueError(f"partition_ring_view: P {p} x W {w} out of range")
    dev = state["seq"].device
    outs = [torch.empty((p, w), dtype=x.dtype, device=dev) for x in lanes]
    mask = torch.empty((p, w), dtype=torch.bool, device=dev)
    args = [x.data_ptr() for x in lanes] + [x.data_ptr() for x in outs] + [
        x.element_size() for x in lanes]
    c_args = (ctypes.c_longlong * len(args))(*args)
    scratch = _i32(p * w, dev) if _pj_view_scratch(w) else None
    kernels.check(kernels.function("pj_view")(
        state["seq"].data_ptr(), state["total"].data_ptr(), p, w,
        None if scratch is None else scratch.data_ptr(), len(lanes), ctypes.addressof(c_args),
        mask.data_ptr(), kernels.stream()), "partition_ring_view")
    kernels.launches["partition_ring_view"] += 1
    return dict(zip(names, outs[:-1])), outs[-1], mask


def _null_fill(t: AttrType, dtype, dev):
    return torch.tensor(null_value(t), dtype=dtype, device=dev)


def partition_join_assemble_ref(pair, row_mask, row_slot, outer: bool, cap: int, p: int,
                                row_ts, row_kind, row_cols: dict, vts, vcols: dict,
                                partner_types: dict) -> JoinRows:
    """Plain version of `partition_join_assemble`: the miss column
    appended, the cells listed by (slot, row, column), a cumsum rank within
    each slot, the first `cap` of each slot kept, then ordered by (rank,
    slot) and gathered."""
    dev = pair.device
    r, w = pair.shape
    member = row_mask & (row_slot >= 0) & (row_slot < p)
    pair = pair & member[:, None]
    if outer:
        pair = torch.cat([pair, (member & ~pair.any(1))[:, None]], 1)
    wj = pair.shape[1]
    key = torch.where(member, row_slot.to(torch.int64), p)
    order = torch.sort(key, stable=True).indices  # rows by (slot, row)
    flat = pair[order].reshape(-1)
    cell_slot = key[order].repeat_interleave(wj)
    fi = flat.to(torch.int64)
    before = torch.cumsum(fi, 0) - fi
    counts = torch.bincount(cell_slot[flat], minlength=p + 1)[:p]
    slot_base = torch.cumsum(counts, 0) - counts
    rank = before - torch.cat([slot_base, before.new_zeros(1)])[cell_slot]
    idx = torch.nonzero(flat & (rank < cap)).flatten()
    ks, kr = cell_slot[idx], rank[idx]
    o = torch.sort(kr * (p + 1) + ks).indices  # (position, slot)
    idx, ks, kr = idx[o], ks[o], kr[o]
    n = idx.shape[0]
    rows = max(n, 1)
    pi = torch.zeros(rows, dtype=torch.int64, device=dev)
    pj = torch.full((rows,), w, dtype=torch.int64, device=dev)
    pi[:n] = order[torch.div(idx, wj, rounding_mode="floor")]
    pj[:n] = idx % wj
    valid = torch.arange(rows, device=dev) < n
    out_slot = torch.full((rows,), p, dtype=torch.int32, device=dev)
    out_slot[:n] = ks.to(torch.int32)
    first_of_slot = torch.zeros(p + 1, dtype=torch.int64, device=dev)
    first_of_slot[ks[kr == 0]] = torch.nonzero(kr == 0).flatten()
    out_first = torch.arange(rows, dtype=torch.int32, device=dev)
    out_first[:n] = first_of_slot[ks].to(torch.int32)
    null = pj >= w
    vslot = torch.where(null, 0, out_slot.to(torch.int64).clamp(max=p - 1))
    vlane = pj.clamp(max=w - 1)

    def partner(lane, t):
        return torch.where(null, _null_fill(t, lane.dtype, dev), lane[vslot, vlane])

    return JoinRows(
        ts=row_ts[pi], kind=row_kind[pi], valid=valid,
        probe_cols={nm: c[pi] for nm, c in row_cols.items()},
        partner_cols={nm: partner(vcols[nm], t) for nm, t in partner_types.items()},
        partner_ts=torch.where(null, torch.zeros((), dtype=torch.int64, device=dev),
                               vts[vslot, vlane]),
        slot=out_slot, first=out_first, overflow=(counts > cap).any())


def partition_join_assemble(pair, row_mask, row_slot, outer: bool, cap: int, p: int, row_ts,
                            row_kind, row_cols: dict, vts, vcols: dict,
                            partner_types: dict) -> JoinRows:
    """A keyed join step's matched (probe row, view lane) pairs: for each
    partition slot, its probe rows' matches in row-major order (its probe
    rows in row order, each against its own slot's view lanes) with, for
    an outer join, one null-partner row for each of its probe rows that
    matched nothing, at its row's turn; the slot's first `cap` kept; then
    every slot's rows by (position within the slot, slot), the JAX
    package's `_flatten` of the vmapped `_assemble`, compacted.

    pair: [R, W] bool, each row against its slot's W view lanes; row_mask
    [R] bool the probe rows; row_slot [R] int32 each row's slot (P: none);
    row_ts/row_kind/row_cols [R] probe lanes; vts/vcols [P, W] view lanes
    by slot; partner_types {name: AttrType} of the view's columns (the
    null fill). At least one row comes out (valid False past the rows).
    One host read: the row count. On the card csrc/partition_join.cu:
    a warp a row counts, one block ranks and places, a warp a row fills."""
    if pair.device.type == "cpu":
        return partition_join_assemble_ref(pair, row_mask, row_slot, outer, cap, p, row_ts,
                                           row_kind, row_cols, vts, vcols, partner_types)
    what = "partition_join_assemble"
    pair = pair.contiguous()
    kernels.require_cuda(what, pair, row_mask, row_slot, row_ts, row_kind,
                         *row_cols.values(), vts, *vcols.values())
    r, w = pair.shape
    if pair.dtype != torch.bool or row_slot.dtype != torch.int32 or any(
            c.shape != (r,) for c in (row_mask, row_slot, row_ts, row_kind,
                                      *row_cols.values())) or any(
            c.shape != (p, w) for c in (vts, *vcols.values())):
        raise ValueError(f"{what}: a [{r}, {w}] bool mask, [{r}] probe lanes with int32 slots "
                         f"and [{p}, {w}] view lanes expected")
    if cap < 1 or p < 1 or r * (w + 1) >= 2**31 or p * w >= 2**31:
        raise ValueError(f"{what}: capacity {cap} / mask [{r}, {w}] / P {p} out of range")
    dev = pair.device
    stream = kernels.stream()
    items = min(p * cap, r * (w + 1)) + 1
    row_cnt, row_off, rank, rowlist = _i32(r, dev), _i32(r, dev), _i32(r, dev), _i32(r, dev)
    slot_start, n_slot, n_start = _i32(p + 1, dev), _i32(p, dev), _i32(p + 1, dev)
    prefix, pos_base, oidx = _i32(r + 1, dev), _i32(cap + 2, dev), _i32(items, dev)
    counters = _i32(max(p, cap) + 1, dev)
    info = torch.zeros(4, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    kernels.check(kernels.function("pj_plan")(
        pair.data_ptr(), row_mask.data_ptr(), row_slot.data_ptr(), r, w, p, int(outer), cap,
        row_cnt.data_ptr(), row_off.data_ptr(), rank.data_ptr(), rowlist.data_ptr(),
        slot_start.data_ptr(), prefix.data_ptr(), n_slot.data_ptr(), n_start.data_ptr(),
        pos_base.data_ptr(), oidx.data_ptr(), counters.data_ptr(), info.data_ptr(),
        overflow.data_ptr(), stream), what)
    rows = max(int(info[0]), 1)  # the rows out, read back to size the output
    pi, pidx, out_slot, out_first = _i32(rows, dev), _i32(rows, dev), _i32(rows, dev), \
        _i32(rows, dev)
    valid = torch.empty(rows, dtype=torch.bool, device=dev)
    kernels.check(kernels.function("pj_fill")(
        pair.data_ptr(), row_mask.data_ptr(), row_slot.data_ptr(), r, w, p, int(outer), cap,
        rows, row_off.data_ptr(), n_start.data_ptr(), oidx.data_ptr(), info.data_ptr(),
        pi.data_ptr(), pidx.data_ptr(), out_slot.data_ptr(), out_first.data_ptr(),
        valid.data_ptr(), stream), what)

    def probe(lane):
        out = torch.empty(rows, dtype=lane.dtype, device=dev)
        kernels.check(kernels.function(f"jp_partner_{lane.element_size()}")(
            lane.data_ptr(), pi.data_ptr(), 0, out.data_ptr(), rows, r, stream), what)
        return out

    def partner(lane, bits):
        out = torch.empty(rows, dtype=lane.dtype, device=dev)
        kernels.check(kernels.function(f"jp_partner_{lane.element_size()}")(
            lane.data_ptr(), pidx.data_ptr(), bits, out.data_ptr(), rows, p * w, stream), what)
        return out

    from siddhi_tpu_torch.core.aggregators import _null_bits

    res = JoinRows(
        ts=probe(row_ts), kind=probe(row_kind), valid=valid,
        probe_cols={nm: probe(c) for nm, c in row_cols.items()},
        partner_cols={nm: partner(vcols[nm], _null_bits(t)) for nm, t in partner_types.items()},
        partner_ts=partner(vts, 0), slot=out_slot, first=out_first, overflow=overflow)
    kernels.launches[what] += 1
    return res


def _keyed_special_ref(step_ref, state: dict, batch: EventBatch, slot: torch.Tensor, p: int,
                       *args):
    """The plain keyed form of a special window's step: `step_ref` on each
    slot's state over its member rows (in row order; the window acts on
    CURRENT rows alone, so the vmap's masked rows change nothing), then
    every slot's rows by (position, slot). Returns (new_state, out,
    out_slot, out_first, overflow)."""
    _active, rowlist, slot_start = _member_rows(batch, slot, p)
    starts = slot_start.tolist()
    new_state = {k: ({n: a.clone() for n, a in v.items()} if isinstance(v, dict) else v.clone())
                 for k, v in state.items()}
    parts, ovf = [], False
    for q in range(p):
        lo, hi = starts[q], starts[q + 1]
        if hi == lo:
            continue
        rows = rowlist[lo:hi].long()
        nst, out, o = step_ref(_slot_state(state, q), _sub_batch(batch, rows), rows, *args)
        for k, v in nst.items():
            if isinstance(v, dict):
                for n, a in v.items():
                    new_state[k][n][q] = a
            else:
                new_state[k][q] = v
        parts.append((q, out, int(out.valid.sum())))
        ovf = ovf or bool(o)
    out, out_slot, out_first, _ = _flatten_out(batch, parts, p)
    return new_state, out, out_slot, out_first, torch.tensor(ovf, device=batch.ts.device)


def partition_sort_window_step_ref(state: dict, batch: EventBatch, slot: torch.Tensor,
                                   now: torch.Tensor, keys: list, w: int, p: int):
    """Plain version of `partition_sort_window_step`: `sort_window_step_ref`
    a slot, flattened by (position, slot)."""
    return _keyed_special_ref(
        lambda st, sub, _rows: sort_window_step_ref(st, sub, now, keys, w),
        state, batch, slot, p)


def partition_frequent_window_step_ref(state: dict, batch: EventBatch, key: torch.Tensor,
                                       slot: torch.Tensor, now: torch.Tensor, w: int, p: int):
    """Plain version of `partition_frequent_window_step`:
    `frequent_window_step_ref` a slot, flattened by (position, slot)."""
    return _keyed_special_ref(
        lambda st, sub, rows: frequent_window_step_ref(st, sub, key[rows], now, w),
        state, batch, slot, p)


def _place_special(what, state, batch, rows: PartitionRows, out_src, out_ts, out_kind,
                   out_valid, n_slot, off, new_src, w: int, p: int):
    """A keyed special window's stretches placed by (position, slot) with
    `pattern_place`, then every column from the source maps: state
    element q*w + j, batch row P*w + r, -1 zeros."""
    placed, out_slot, out_first = pattern_place(
        {"src": out_src, "ts": out_ts, "kind": out_kind, "valid": out_valid}, off, n_slot,
        n_slot, p)
    src = torch.where(placed["valid"], placed["src"], -1)
    names = list(batch.cols)
    pairs = [(state["cols"][n].view(-1), batch.cols[n]) for n in names]
    st = _gather(what, pairs + [(state["ts"].view(-1), batch.ts)], new_src, p * w, 1 << 30)
    cols = _gather(what, pairs, src, p * w, 1 << 30)
    out = EventBatch(ts=placed["ts"], kind=placed["kind"], valid=placed["valid"],
                     cols=dict(zip(names, cols)))
    new_cols = {n: c.view(p, w) for n, c in zip(names, st[:-1])}
    return out, out_slot, out_first, new_cols, st[-1].view(p, w)


def _check_keyed_special(what, state, batch, slot, w: int, p: int, lanes) -> None:
    bsz = batch.capacity
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype, slot.dtype) != (
            torch.int64, torch.int8, torch.bool, torch.int32):
        raise ValueError(f"{what}: lanes must be int64 ts, int8 kind, bool valid, int32 slot")
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, slot, *batch.cols.values())) \
            or set(state["cols"]) != set(batch.cols) or any(
            state["cols"][n].shape != (p, w) or state["cols"][n].dtype != a.dtype
            for n, a in batch.cols.items()) or any(x.shape != (p, w) for x in lanes):
        raise ValueError(f"{what}: batch lanes must be [{bsz}] and each state lane [{p}, {w}] "
                         "of the batch column's dtype")
    if w < 1 or p < 1 or 2 * bsz + p * w + 2 >= 2**31 or p * w >= 2**30:
        raise ValueError(f"{what}: P {p} x w {w} and B {bsz} out of range")


def partition_sort_window_step(state: dict, batch: EventBatch, slot: torch.Tensor,
                               now: torch.Tensor, keys: list, w: int, p: int):
    """One sort(w, keys) window step of every partition at once (K40),
    over a batch of B rows that each carry their partition slot.

    state: each partition's sort window, `sort_window_step`'s lanes with a
           leading [P] axis: {"cols": {name: [P, w]}, "ts", "occ", "seq":
           [P, w], "next": [P] int64}
    slot:  [B] int32; a valid CURRENT row with a slot in [0, P) is an
           arrival of its slot (no other row changes a window)
    returns (new_state, out, out_slot, out_first, overflow): out holds each
    slot's emissions (each CURRENT arrival, then its evicted greatest as
    EXPIRED at `now`), every slot's rows by (position within the slot,
    slot), at least one row; out_slot [rows] int32 (P past the rows),
    out_first [rows] int32 the slot's first row. One warp a slot walks the
    slot's rows with K25's device code (csrc/special_window.cu
    `sw_psort`), then `pattern_place` places the stretches (one host
    read) and `sw_gather` fills the columns."""
    if batch.ts.device.type == "cpu":
        return partition_sort_window_step_ref(state, batch, slot, now, keys, w, p)
    what = "partition_sort_window_step"
    kernels.require_cuda(what, batch.ts, batch.kind, batch.valid, slot, now, state["ts"],
                         state["occ"], state["seq"], state["next"], *batch.cols.values(),
                         *state["cols"].values())
    _check_keyed_special(what, state, batch, slot, w, p, (state["ts"], state["occ"],
                                                          state["seq"]))
    if not 1 <= len(keys) <= MAX_SORT_KEYS or state["next"].shape != (p,):
        raise ValueError(f"{what}: 1 to {MAX_SORT_KEYS} sort keys and [{p}] next expected")
    bsz, dev, k = batch.capacity, batch.ts.device, len(keys)
    rows = partition_rows(batch, slot, p)
    out_src, out_ts, out_kind, out_valid = _lanes_out(2 * bsz, dev)
    n_slot, new_src = _i32(p, dev), _i32(p * w, dev)
    new_occ = torch.empty((p, w), dtype=torch.bool, device=dev)
    new_seq = torch.empty((p, w), dtype=torch.int64, device=dev)
    new_next = torch.empty(p, dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    slot_bytes = (kernels.function("sw_slot_bytes")(0, w, k) + 15) // 16 * 16
    scratch = torch.empty(p * slot_bytes, dtype=torch.uint8, device=dev)
    a = _Args()
    kernels.check(kernels.function("sw_psort")(
        bsz, w, p, k, slot_bytes, a.ptrs([state["cols"][n] for n, _ in keys]),
        a.ptrs([batch.cols[n] for n, _ in keys]),
        a.ints([_KEY_TYPE[batch.cols[n].dtype] for n, _ in keys]),
        a.ints([int(d) for _, d in keys]), batch.ts.data_ptr(), rows.rowlist.data_ptr(),
        rows.slot_start.data_ptr(), state["occ"].data_ptr(), state["seq"].data_ptr(),
        state["next"].data_ptr(), now.data_ptr(), scratch.data_ptr(), out_src.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(), n_slot.data_ptr(),
        new_src.data_ptr(), new_occ.data_ptr(), new_seq.data_ptr(), new_next.data_ptr(),
        ovf.data_ptr(), kernels.stream()), what)
    off = 2 * rows.slot_start[:-1].to(torch.int64)
    out, out_slot, out_first, cols, ts = _place_special(
        what, state, batch, rows, out_src, out_ts, out_kind, out_valid, n_slot, off, new_src,
        w, p)
    new_state = {"cols": cols, "ts": ts, "occ": new_occ, "seq": new_seq, "next": new_next}
    kernels.launches[what] += 1
    return new_state, out, out_slot, out_first, ovf


def partition_frequent_window_step(state: dict, batch: EventBatch, key: torch.Tensor,
                                   slot: torch.Tensor, now: torch.Tensor, w: int, p: int):
    """One frequent(w) window step of every partition at once (K41): each
    slot's Misra-Gries table over its rows.

    state: `frequent_window_step`'s lanes with a leading [P] axis:
           {"cols": {name: [P, w]}, "ts": [P, w] int64, "occ": [P, w] bool,
           "key": [P, w] int64, "cnt": [P, w] int32}
    key:   [B] int64 row keys (float columns by their bits, so -0.0 and
           0.0 differ); slot: [B] int32 as `partition_sort_window_step`'s
    returns (new_state, out, out_slot, out_first, overflow) as
    `partition_sort_window_step`: each slot's evictions of a full table as
    EXPIRED at `now` in slot order, then the kept arrival as CURRENT. One
    warp a slot with K26's ballots (csrc/special_window.cu `sw_pfrequent`),
    then the placement and the gather."""
    if batch.ts.device.type == "cpu":
        return partition_frequent_window_step_ref(state, batch, key, slot, now, w, p)
    what = "partition_frequent_window_step"
    kernels.require_cuda(what, batch.ts, batch.kind, batch.valid, slot, key, now, state["ts"],
                         state["occ"], state["key"], state["cnt"], *batch.cols.values(),
                         *state["cols"].values())
    _check_keyed_special(what, state, batch, slot, w, p, (state["ts"], state["occ"],
                                                          state["key"], state["cnt"]))
    if key.shape != batch.ts.shape or key.dtype != torch.int64 or \
            state["cnt"].dtype != torch.int32:
        raise ValueError(f"{what}: key must be [B] int64 and cnt int32")
    bsz, dev = batch.capacity, batch.ts.device
    rows = partition_rows(batch, slot, p)
    out_src, out_ts, out_kind, out_valid = _lanes_out(2 * bsz + p * w, dev)
    n_slot, new_src = _i32(p, dev), _i32(p * w, dev)
    new_occ = torch.empty((p, w), dtype=torch.bool, device=dev)
    new_key = torch.empty((p, w), dtype=torch.int64, device=dev)
    new_cnt = torch.empty((p, w), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    slot_bytes = (kernels.function("sw_slot_bytes")(1, w, 0) + 15) // 16 * 16
    scratch = torch.empty(p * slot_bytes, dtype=torch.uint8, device=dev)
    kernels.check(kernels.function("sw_pfrequent")(
        bsz, w, p, slot_bytes, batch.ts.data_ptr(), key.data_ptr(), rows.rowlist.data_ptr(),
        rows.slot_start.data_ptr(), state["occ"].data_ptr(), state["key"].data_ptr(),
        state["cnt"].data_ptr(), now.data_ptr(), scratch.data_ptr(), out_src.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(), n_slot.data_ptr(),
        new_src.data_ptr(), new_occ.data_ptr(), new_key.data_ptr(), new_cnt.data_ptr(),
        ovf.data_ptr(), kernels.stream()), what)
    off = (2 * rows.slot_start[:-1] + w * torch.arange(p, device=dev,
                                                       dtype=torch.int32)).to(torch.int64)
    out, out_slot, out_first, cols, ts = _place_special(
        what, state, batch, rows, out_src, out_ts, out_kind, out_valid, n_slot, off, new_src,
        w, p)
    new_state = {"cols": cols, "ts": ts, "occ": new_occ, "key": new_key, "cnt": new_cnt}
    kernels.launches[what] += 1
    return new_state, out, out_slot, out_first, ovf


# ---------------------------------------------------------------------------
# the lossyFrequent and cron windows inside a partition (K42, K43)
# ---------------------------------------------------------------------------


def partition_lossy_frequent_window_step_ref(state: dict, batch: EventBatch, key: torch.Tensor,
                                             slot: torch.Tensor, now: torch.Tensor, c: int,
                                             width: int, support: float, error: float, p: int):
    """Plain version of `partition_lossy_frequent_window_step`:
    `lossy_frequent_window_step_ref` a slot (into the JAX package's
    per-partition buffer of B + c rows, B the whole batch's), flattened by
    (position, slot)."""
    cap = lossy_rows(batch.capacity, c)
    return _keyed_special_ref(
        lambda st, sub, rows: lossy_frequent_window_step_ref(st, sub, key[rows], now, c, width,
                                                             support, error, cap=cap),
        state, batch, slot, p)


def partition_lossy_frequent_window_step(state: dict, batch: EventBatch, key: torch.Tensor,
                                         slot: torch.Tensor, now: torch.Tensor, c: int,
                                         width: int, support: float, error: float, p: int):
    """One lossyFrequent(support, error) window step of every partition at
    once (K42): each slot's lossy-counting table over its rows, with its
    own total and buckets.

    state: `lossy_frequent_window_step`'s lanes with a leading [P] axis:
           {"cols": {name: [P, c]}, "ts": [P, c] int64, "occ": [P, c] bool,
           "key"/"cnt"/"bucket": [P, c] int64, "total": [P] int64}
    key:   [B] int64 row keys; slot: [B] int32 as
           `partition_sort_window_step`'s
    returns (new_state, out, out_slot, out_first, overflow) as
    `partition_sort_window_step`: each slot's arrivals meeting (s - e) *
    total as CURRENT, and at each of its bucket ends its pruned slots as
    EXPIRED at `now` in slot order. One warp a slot with K27's
    `lossy_arrive` (csrc/special_window.cu `sw_plossy`; the slot's key
    table in shared memory when four fit in a block, else in a global
    scratch), then the placement and the gather."""
    if batch.ts.device.type == "cpu":
        return partition_lossy_frequent_window_step_ref(state, batch, key, slot, now, c, width,
                                                        support, error, p)
    what = "partition_lossy_frequent_window_step"
    kernels.require_cuda(what, batch.ts, batch.kind, batch.valid, slot, key, now, state["ts"],
                         state["occ"], state["key"], state["cnt"], state["bucket"],
                         state["total"], *batch.cols.values(), *state["cols"].values())
    _check_keyed_special(what, state, batch, slot, c, p, (state["ts"], state["occ"],
                                                          state["key"], state["cnt"],
                                                          state["bucket"]))
    if key.shape != batch.ts.shape or state["total"].shape != (p,) or any(
            x.dtype != torch.int64 for x in (key, state["ts"], state["key"], state["cnt"],
                                             state["bucket"], state["total"])) or \
            state["occ"].dtype != torch.bool:
        raise ValueError(f"{what}: key [B], ts/key/cnt/bucket [{p}, {c}] and total [{p}] must "
                         "be int64, occ bool")
    bsz, dev = batch.capacity, batch.ts.device
    rows = partition_rows(batch, slot, p)
    out_src, out_ts, out_kind, out_valid = _lanes_out(2 * bsz + p * c, dev)
    n_slot, new_src = _i32(p, dev), _i32(p * c, dev)
    new_occ = torch.empty((p, c), dtype=torch.bool, device=dev)
    new_key, new_cnt, new_bucket = (torch.empty((p, c), dtype=torch.int64, device=dev)
                                    for _ in range(3))
    new_total = torch.empty(p, dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    slot_bytes = kernels.function("sw_slot_bytes")(4, c, 0)
    scratch = torch.empty(max(p * slot_bytes, 1), dtype=torch.uint8, device=dev)
    kernels.check(kernels.function("sw_plossy")(
        bsz, c, p, width, float(lossy_threshold(support, error)), batch.ts.data_ptr(),
        key.data_ptr(), rows.rowlist.data_ptr(), rows.slot_start.data_ptr(),
        state["occ"].data_ptr(), state["key"].data_ptr(), state["cnt"].data_ptr(),
        state["bucket"].data_ptr(), state["total"].data_ptr(), now.data_ptr(),
        scratch.data_ptr(), out_src.data_ptr(), out_ts.data_ptr(), out_kind.data_ptr(),
        out_valid.data_ptr(), n_slot.data_ptr(), new_src.data_ptr(), new_occ.data_ptr(),
        new_key.data_ptr(), new_cnt.data_ptr(), new_bucket.data_ptr(), new_total.data_ptr(),
        ovf.data_ptr(), kernels.stream()), what)
    off = (2 * rows.slot_start[:-1] + c * torch.arange(p, device=dev,
                                                       dtype=torch.int32)).to(torch.int64)
    out, out_slot, out_first, cols, ts = _place_special(
        what, state, batch, rows, out_src, out_ts, out_kind, out_valid, n_slot, off, new_src,
        c, p)
    new_state = {"cols": cols, "ts": ts, "occ": new_occ, "key": new_key, "cnt": new_cnt,
                 "bucket": new_bucket, "total": new_total}
    kernels.launches[what] += 1
    return new_state, out, out_slot, out_first, ovf


def partition_cron_window_step_ref(state: dict, batch: EventBatch, slot: torch.Tensor,
                                   now: torch.Tensor, w: int, p: int):
    """Plain version of `partition_cron_window_step`: for each slot with
    member rows, or with an open bucket a TIMER row of the batch flushes,
    `cron_window_step_ref` on that slot's buffers over its rows and the
    TIMER rows in row order (into the JAX package's per-partition buffer
    of B + 2(2w + 1) rows), then every slot's rows by (position, slot).
    (On any other slot the step changes nothing.)"""
    _active, rowlist, slot_start = _member_rows(batch, slot, p)
    timer_rows = torch.nonzero(batch.valid & (batch.kind == KIND_TIMER)).flatten()
    starts, cur_n = slot_start.tolist(), state["cur_n"].tolist()
    cap = cron_rows(batch.capacity, w)
    new_state = {k: ({n: a.clone() for n, a in v.items()} if isinstance(v, dict) else v.clone())
                 for k, v in state.items()}
    parts, ovf = [], False
    for q in range(p):
        lo, hi = starts[q], starts[q + 1]
        if hi == lo and (not timer_rows.numel() or not cur_n[q]):
            continue
        rows = _merged_rows(rowlist, lo, hi, timer_rows)
        nst, out, o = cron_window_step_ref(_slot_state(state, q), _sub_batch(batch, rows), now,
                                           w, cap=cap)
        for k, v in nst.items():
            if isinstance(v, dict):
                for n, a in v.items():
                    new_state[k][n][q] = a
            else:
                new_state[k][q] = v
        parts.append((q, out, int(out.valid.sum())))
        ovf = ovf or bool(o)
    out, out_slot, out_first, _ = _flatten_out(batch, parts, p)
    return new_state, out, out_slot, out_first, torch.tensor(ovf, device=batch.ts.device)


def partition_cron_window_step(state: dict, batch: EventBatch, slot: torch.Tensor,
                               now: torch.Tensor, w: int, p: int):
    """One cron window step of every partition at once (K43): each slot's
    open bucket collects its rows, and every TIMER row of the batch reaches
    every slot (the vmap's `(active & slot == p) | is_timer`), flushing each
    non-empty bucket.

    state: `cron_window_step`'s lanes with a leading [P] axis:
           {"cur_cols"/"prev_cols": {name: [P, w]}, "cur_ts"/"prev_ts":
           [P, w] int64, "cur_n"/"prev_n": [P] int32}
    slot:  [B] int32 as `partition_sort_window_step`'s
    returns (new_state, out, out_slot, out_first, overflow) as
    `partition_sort_window_step`: each flush of a slot (its previous bucket
    EXPIRED at `now`, a RESET, its bucket CURRENT). A warp a slot walks its
    rows merged with the TIMER rows with K28's `cron_row`
    (csrc/special_window.cu `sw_pcron`) into a stretch sized by the
    flushes it can make and the rows its buckets can hold (one host read:
    the rows out), then the placement and the gather."""
    if batch.ts.device.type == "cpu":
        return partition_cron_window_step_ref(state, batch, slot, now, w, p)
    what = "partition_cron_window_step"
    kernels.require_cuda(what, batch.ts, batch.kind, batch.valid, slot, now, state["cur_ts"],
                         state["cur_n"], state["prev_ts"], state["prev_n"],
                         *batch.cols.values(), *state["cur_cols"].values(),
                         *state["prev_cols"].values())
    for half in ("cur", "prev"):
        _check_keyed_special(what, {"cols": state[f"{half}_cols"]}, batch, slot, w, p,
                             (state[f"{half}_ts"],))
        if state[f"{half}_n"].shape != (p,) or state[f"{half}_n"].dtype != torch.int32 or \
                state[f"{half}_ts"].dtype != torch.int64:
            raise ValueError(f"{what}: {half}_n must be [{p}] int32 and {half}_ts int64")
    if 2 * p * w + batch.capacity >= 2**31:
        raise ValueError(f"{what}: P {p} x w {w} out of range")
    bsz, dev = batch.capacity, batch.ts.device
    rows = partition_rows(batch, slot, p)
    # each slot's stretch: at most one flush a TIMER row, and only while a
    # row has come since the last (or the bucket holds rows); a flush is
    # its previous bucket, a RESET and its bucket, each bucket at most its
    # rows so far (or the previous bucket's own)
    n_rows_q = rows.rows.to(torch.int64)
    cur_n, prev_n = state["cur_n"].to(torch.int64), state["prev_n"].to(torch.int64)
    flushes = torch.minimum(rows.info[3].to(torch.int64), n_rows_q + (cur_n > 0).to(torch.int64))
    cur_b = torch.clamp(cur_n + n_rows_q, max=w)
    cap = torch.clamp(flushes * (1 + torch.maximum(prev_n, cur_b) + cur_b),
                      max=cron_rows(bsz, w)).to(torch.int32)
    ends = torch.cumsum(cap.to(torch.int64), 0)
    off = ends - cap.to(torch.int64)
    n_rows = int(ends[-1])  # read back to size the stretches
    out_src, out_ts, out_kind, out_valid = _lanes_out(max(n_rows, 1), dev)
    n_slot = _i32(p, dev)
    new_cur, new_prev = _i32(p * w, dev), _i32(p * w, dev)
    new_cur_n, new_prev_n = _i32(p, dev), _i32(p, dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    scratch = _i32(2 * p * w, dev)
    kernels.check(kernels.function("sw_pcron")(
        w, p, batch.ts.data_ptr(), rows.rowlist.data_ptr(), rows.slot_start.data_ptr(),
        rows.timers.data_ptr(), rows.info.data_ptr(), state["cur_ts"].data_ptr(),
        state["cur_n"].data_ptr(), state["prev_ts"].data_ptr(), state["prev_n"].data_ptr(),
        now.data_ptr(), off.data_ptr(), cap.data_ptr(), scratch.data_ptr(), out_src.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(), n_slot.data_ptr(),
        new_cur.data_ptr(), new_prev.data_ptr(), new_cur_n.data_ptr(), new_prev_n.data_ptr(),
        ovf.data_ptr(), kernels.stream()), what)
    placed, out_slot, out_first = pattern_place(
        {"src": out_src, "ts": out_ts, "kind": out_kind, "valid": out_valid}, off, n_slot,
        n_slot, p)
    src = torch.where(placed["valid"], placed["src"], -1)
    names = list(batch.cols)
    sources = [(state["cur_cols"][n].view(-1), state["prev_cols"][n].view(-1), batch.cols[n])
               for n in names]
    sources.append((state["cur_ts"].view(-1), state["prev_ts"].view(-1), batch.ts))
    cur = _gather(what, sources, new_cur, p * w, p * w)
    prev = _gather(what, sources, new_prev, p * w, p * w)
    new_state = {
        "cur_cols": {n: c.view(p, w) for n, c in zip(names, cur[:-1])},
        "cur_ts": cur[-1].view(p, w), "cur_n": new_cur_n,
        "prev_cols": {n: c.view(p, w) for n, c in zip(names, prev[:-1])},
        "prev_ts": prev[-1].view(p, w), "prev_n": new_prev_n,
    }
    out = EventBatch(ts=placed["ts"], kind=placed["kind"], valid=placed["valid"],
                     cols=dict(zip(names, _gather(what, sources[:-1], src, p * w, p * w))))
    kernels.launches[what] += 1
    return new_state, out, out_slot, out_first, ovf
