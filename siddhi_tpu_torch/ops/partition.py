"""The keyed partition steps: the partitioned length window (K29) and the
windowed min/max of a partition (K30).

The JAX package runs a partitioned query step under `jax.vmap` over P
partition states (siddhi_tpu/core/partition.py `_vmapped`): every partition
sees the whole batch under a mask and emits a `[P, K]` output, which
`_flatten` orders by output position first and partition slot second. The
port keeps the same rows in a keyed form: each row carries its partition
slot (P = no partition), per-partition state is indexed by slot, and the
output comes out already flattened, ordered by (position within its
partition, slot). For a windowless step the position is the row, so the
order is the arrival order; for the length window it is the row's rank
within its partition plus that partition's evictions so far, which is not
the arrival order.

On the card each step is hand-written CUDA (csrc/partition_window.cu); each
`*_ref` beside a wrapper is its plain version, which the wrapper takes only
for tensors on the CPU. `partition_length_window_step_ref` runs the
unpartitioned `length_window_step_ref` once per live slot on that slot's
rows (the vmap's semantics) and flattens by (position, slot), so it checks
K29 independently of its closed-form positions.
"""

from __future__ import annotations

import dataclasses

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.event import EventBatch, KIND_CURRENT
from siddhi_tpu_torch.core.types import AttrType, null_value
from siddhi_tpu_torch.core.windows import BIG, length_window_step_ref
from siddhi_tpu_torch.ops.prefix import extreme_identity


@dataclasses.dataclass
class PartitionMembers:
    """A partitioned length-window step's index lanes, beside its
    birth/death membership (elements are the P*W ring slots, slot-major,
    then the B batch rows).

    slot:       [2B] int32, each output row's partition slot (P: padding)
    first:      [2B] int32, the first output row of the row's slot (the
                row itself for padding): the segment id of the keyed
                running reductions (ops/group.py `Groups.first`)
    rowlist:    [B] int32, the batch's member rows ordered by (slot, rank),
                then -1
    slot_start: [P + 1] int32, where each slot's rows begin in `rowlist`
    elem_slot:  [P*W + B] int64, each element's slot (P: not a member)
    w:          the ring size W
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
