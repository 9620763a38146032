"""Window processors — device-resident ring buffers with batched emission.

Reference: query/processor/stream/window/*.java. The reference mutates per-event
queues inside synchronized blocks; here each window is a stage over the Flow
with a fixed-capacity slot-indexed ring as carried state.

Ported so far: length, time, timeLength, externalTime, lengthBatch, timeBatch
and externalTimeBatch, and the findable views a join probes. The length
window's emission order follows the reference: per arrival when full, the
evictee's EXPIRED is emitted before the arrival's CURRENT
(LengthWindowProcessor.java:102-138 insertBeforeCurrent); in the time
windows every due EXPIRED flushes before its triggering CURRENT or TIMER row
(TimeWindowProcessor.java:79+).
lengthBatch, timeBatch and externalTimeBatch flush tumbling buckets
(LengthBatchWindowProcessor.java:108-160), the time-driven two at each
duration boundary of the window time and on an externalTimeBatch idle
timeout. Each step, and the ring view, is a hand-written CUDA kernel on the
card (csrc/length_window.cu, csrc/time_window.cu, csrc/batch_window.cu,
csrc/ring_view.cu); the `*_ref` functions are their plain PyTorch versions,
which the wrappers take only for tensors on the CPU. The sort, frequent,
lossyFrequent and cron windows live in core/windows_special.py (K25-K28);
`make_window` builds them too. The other windows raise "not ported yet".
Inside a partition the ring and bucket lanes gain a leading [P] axis and
each step runs every partition at once by the rows' slots (ops/partition.py:
the length window K29, the time windows K31, the batch windows K32).
"""

from __future__ import annotations

import ctypes

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import (
    EventBatch,
    KIND_CURRENT,
    KIND_EXPIRED,
    KIND_RESET,
    KIND_TIMER,
    StreamSchema,
)
from siddhi_tpu_torch.core.executor import Env, Scope, TS_ATTR
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE, AttrType
from siddhi_tpu_torch.ops.scatter import set_at
from siddhi_tpu_torch.query_api.definition import WindowSpec
from siddhi_tpu_torch.query_api.expression import Constant, Variable

BIG = torch.iinfo(torch.int32).max


def _const_raw(spec: WindowSpec, i: int, what: str):
    if i >= len(spec.parameters) or not isinstance(spec.parameters[i], Constant):
        raise SiddhiAppCreationError(f"window {spec.name}: parameter {i} must be a constant {what}")
    return spec.parameters[i].value


def _const_param(spec: WindowSpec, i: int, what: str) -> int:
    return int(_const_raw(spec, i, what))


class WindowStage:
    """Base: (state, Flow) -> (state', Flow'). `is_batch`: the window flushes
    tumbling buckets (the selector then collapses each flush).
    `needs_scheduler`: the step reports its next expiry ("next_timer" in the
    flow's aux) and TIMER rows must be sent when it falls due."""

    is_batch = False
    needs_scheduler = False

    def init_state(self):
        raise NotImplementedError

    def apply(self, state, flow: Flow):
        raise NotImplementedError

    def view_seq(self, state):
        """Per-slot admission seqs in `view()` order (-1: an empty slot), or
        None when this window keeps no admission order: join lineage then
        records the partner as unresolved (observability/lineage.py)."""
        return None

    def view_with_seq(self, state):
        """(cols, ts, mask, seq) — `view()` and `view_seq()` paired by
        position."""
        return (*self.view(state), self.view_seq(state))

    def view(self, state):
        """Stored window contents for a join's probe: `(cols, ts, mask)` with
        rows in insertion order (reference: FindableProcessor.find,
        LengthWindowProcessor.java:144)."""
        raise NotImplementedError(f"{type(self).__name__} is not findable")


def length_window_step_ref(state: dict, batch: EventBatch, w: int):
    """Plain version of `length_window_step`, in the JAX package's scatter
    formulation: rank/perm by cumsum and a stable argsort, the inclusive
    eviction count E by cumsum, then EXPIRED and CURRENT rows scattered into
    their output positions."""
    dev = batch.ts.device
    bsz = batch.capacity
    total = state["total"]
    valid_cur = batch.valid & (batch.kind == KIND_CURRENT)
    vc = valid_cur.to(torch.int32)
    rank = torch.cumsum(vc, 0, dtype=torch.int32) - vc
    c = vc.sum(dtype=torch.int32)
    seq_batch = torch.where(valid_cur, total + rank, torch.full_like(batch.ts, -1))
    elem_seq = torch.cat([state["seq"], seq_batch])
    present = elem_seq >= 0
    trig_rank = (elem_seq + w - total).to(torch.int32)
    len_trig_valid = present & (trig_rank >= 0) & (trig_rank < c)
    perm = torch.argsort((~valid_cur).to(torch.uint8), stable=True)  # rank -> row

    ranks = torch.arange(bsz, dtype=torch.int32, device=dev)
    e = (ranks < c) & (total + ranks >= w)
    E = torch.cumsum(e.to(torch.int32), 0, dtype=torch.int32)
    cur_pos_rank = ranks + E
    n_out = 2 * bsz
    # evicted element (seq = total + i - w): a ring slot if it predates this
    # batch, else the batch row of rank i - w
    seq_ev = total + ranks - w
    ring_slot = torch.where(seq_ev >= 0, seq_ev % w, torch.zeros_like(seq_ev))
    batch_row = perm[(ranks - w).clamp(0, bsz - 1).long()]
    elem_idx = torch.where(seq_ev < total, ring_slot, w + batch_row).long()
    trig_ts = batch.ts[perm]

    elem_cols = {n: torch.cat([state["cols"][n], batch.cols[n]]) for n in batch.cols}
    # one extra dump slot at n_out takes every dropped write
    out_ts = torch.zeros(n_out + 1, dtype=torch.int64, device=dev)
    out_kind = torch.zeros(n_out + 1, dtype=torch.int8, device=dev)
    out_valid = torch.zeros(n_out + 1, dtype=torch.bool, device=dev)
    out_cols = {
        n: torch.zeros(n_out + 1, dtype=a.dtype, device=dev) for n, a in batch.cols.items()
    }
    exp_dst = torch.where(e, cur_pos_rank - 1, n_out).long()
    out_ts[exp_dst] = trig_ts
    out_kind[exp_dst] = KIND_EXPIRED
    out_valid[exp_dst] = True
    for n in out_cols:
        out_cols[n][exp_dst] = elem_cols[n][elem_idx]
    cur_pos_row = cur_pos_rank[rank.clamp(0, bsz - 1).long()]
    cur_dst = torch.where(valid_cur, cur_pos_row, n_out).long()
    out_ts[cur_dst] = batch.ts
    out_kind[cur_dst] = KIND_CURRENT
    out_valid[cur_dst] = True
    for n in out_cols:
        out_cols[n][cur_dst] = batch.cols[n]
    out = EventBatch(
        ts=out_ts[:n_out], kind=out_kind[:n_out], valid=out_valid[:n_out],
        cols={n: a[:n_out] for n, a in out_cols.items()},
    )

    minus1 = torch.full((w,), -1, dtype=torch.int32, device=dev)
    birth = torch.cat([minus1, torch.where(valid_cur, cur_pos_row, -1)])
    E_at = E[trig_rank.clamp(0, bsz - 1).long()]
    death = torch.where(len_trig_valid, trig_rank + E_at - 1, BIG)
    death = torch.where(present, death, -1)

    # ring update: evicted slots clear, then the batch's last min(c, w)
    # insertions land in slot seq % w
    ring_evicted = len_trig_valid[:w]
    insert = valid_cur & (rank >= c - w)
    slots = torch.where(insert, (total + rank) % w, w).long()

    def place(old, vals, cleared):
        lane = torch.cat([torch.where(ring_evicted, cleared, old), old[:1]])
        lane[slots] = vals.to(lane.dtype)
        return lane[:w]

    zero = lambda x: torch.zeros((), dtype=x.dtype, device=dev)  # noqa: E731
    new_state = {
        "cols": {
            n: place(state["cols"][n], batch.cols[n], zero(batch.cols[n]))
            for n in batch.cols
        },
        "ts": place(state["ts"], batch.ts, zero(batch.ts)),
        "wts": place(state["wts"], batch.ts, zero(batch.ts)),
        "seq": place(state["seq"], seq_batch, torch.full((), -1, dtype=torch.int64, device=dev)),
        "total": total + c,
    }
    return out, birth, death, new_state


def length_window_step(state: dict, batch: EventBatch, w: int):
    """One length(w) window step over a batch of B arrivals.

    state: {"cols": {name: [w]}, "ts": [w] int64, "wts": [w] int64,
            "seq": [w] int64 (-1 = empty slot), "total": 0-d int64}
    returns (out, birth_pos, death_pos, new_state):
      out        [2B] EventBatch of interleaved EXPIRED/CURRENT rows
      birth_pos  [w+B] int32, death_pos [w+B] int32: element e (ring slots,
                 then batch rows) is in the window at output row p iff
                 birth_pos[e] <= p < death_pos[e] (absent elements: death -1)
      new_state  the ring after the batch (new tensors; `state` is untouched)
    """
    if batch.ts.device.type == "cpu":
        return length_window_step_ref(state, batch, w)
    lanes = [batch.ts, batch.kind, batch.valid, *batch.cols.values(), state["ts"],
             state["wts"], state["seq"], state["total"], *state["cols"].values()]
    kernels.require_cuda("length_window_step", *lanes)
    bsz = batch.capacity
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, *batch.cols.values())) or any(
        x.shape != (w,) for x in (state["ts"], state["wts"], state["seq"], *state["cols"].values())
    ):
        raise ValueError(f"length_window_step: lanes must be [{bsz}] and ring lanes [{w}]")
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype, state["seq"].dtype,
            state["total"].dtype) != (torch.int64, torch.int8, torch.bool, torch.int64,
                                      torch.int64) or any(
            state["cols"][n].dtype != a.dtype for n, a in batch.cols.items()):
        raise ValueError("length_window_step: lane dtypes must be int64 ts/seq/total, "
                         "int8 kind, bool valid, and each ring column the batch's dtype")
    if 2 * bsz + w >= 2**31:
        raise ValueError(f"length_window_step: batch {bsz} too large for int32 positions")
    dev = batch.ts.device

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    rank, perm, count = i32(bsz), i32(bsz), i32(())
    birth, death = i32(w + bsz), i32(w + bsz)
    out_src, ring_src = i32(2 * bsz), i32(w)
    out_ts = torch.empty(2 * bsz, dtype=torch.int64, device=dev)
    out_kind = torch.empty(2 * bsz, dtype=torch.int8, device=dev)
    out_valid = torch.empty(2 * bsz, dtype=torch.bool, device=dev)
    new_seq = torch.empty(w, dtype=torch.int64, device=dev)
    new_total = torch.empty((), dtype=torch.int64, device=dev)
    stream = kernels.stream()
    err = kernels.function("lw_prepare")(
        batch.kind.data_ptr(), batch.valid.data_ptr(), batch.ts.data_ptr(),
        state["seq"].data_ptr(), state["total"].data_ptr(), bsz, w,
        rank.data_ptr(), perm.data_ptr(), count.data_ptr(), birth.data_ptr(),
        death.data_ptr(), out_src.data_ptr(), out_ts.data_ptr(), out_kind.data_ptr(),
        out_valid.data_ptr(), ring_src.data_ptr(), new_seq.data_ptr(),
        new_total.data_ptr(), stream,
    )
    kernels.check(err, "length_window_step")

    def gather(ring_lane, batch_lane, idx):
        out = torch.empty(idx.shape[0], dtype=ring_lane.dtype, device=dev)
        fn = kernels.function(f"lw_gather_{ring_lane.element_size()}")
        kernels.check(
            fn(ring_lane.data_ptr(), batch_lane.data_ptr(), idx.data_ptr(),
               out.data_ptr(), idx.shape[0], w, stream),
            "length_window_step",
        )
        return out

    out = EventBatch(
        ts=out_ts, kind=out_kind, valid=out_valid,
        cols={n: gather(state["cols"][n], a, out_src) for n, a in batch.cols.items()},
    )
    new_state = {
        "cols": {n: gather(state["cols"][n], a, ring_src) for n, a in batch.cols.items()},
        "ts": gather(state["ts"], batch.ts, ring_src),
        "wts": gather(state["wts"], batch.ts, ring_src),
        "seq": new_seq,
        "total": new_total,
    }
    kernels.launches["length_window_step"] += 1
    return out, birth, death, new_state


NO_TIMER = torch.iinfo(torch.int64).max
DEFAULT_TIME_CAPACITY = 1024
_I64_MIN = torch.iinfo(torch.int64).min


def _time_trigger_ref(vals: torch.Tensor, start: torch.Tensor, target: torch.Tensor):
    """For each element, the first row r >= start with vals[r] >= target
    (len(vals) when none), by binary lifting over a sparse table of running
    maxima: no [elements, rows] matrix is formed."""
    bsz = vals.shape[0]
    levels = max(1, int(bsz).bit_length())  # 2**levels > bsz
    size = 1 << levels
    table = [torch.cat([vals, torch.full((size - bsz,), _I64_MIN, dtype=torch.int64,
                                          device=vals.device)])]
    for k in range(1, levels + 1):
        prev, half = table[-1], 1 << (k - 1)
        shifted = torch.cat([prev[half:], torch.full((half,), _I64_MIN, dtype=torch.int64,
                                                     device=vals.device)])
        table.append(torch.maximum(prev, shifted))
    pos = start.to(torch.int64)
    for k in range(levels, -1, -1):
        step = 1 << k
        span_max = table[k][pos.clamp(max=size - 1)]
        ok = (pos + step <= size) & (span_max < target)
        pos = torch.where(ok, pos + step, pos)
    return pos.clamp(max=bsz)


def time_window_step_ref(state: dict, batch: EventBatch, bwts: torch.Tensor, w: int, t: int):
    """Plain version of `time_window_step`, in the JAX package's formulation
    (SlidingWindow.apply's time path) without its [W+B, B] due matrix and
    [W+2B, W+B] member matrix: each element's first time-trigger row comes
    from `_time_trigger_ref`, the death/birth candidates are ordered by one
    stable sort on (trigger row * 2 | row * 2 + 1, seq), and the ring update is
    `_ring_state`'s scatter. Padding rows are zeroed."""
    dev = batch.ts.device
    bsz = batch.capacity
    k = w + bsz
    total = state["total"]
    valid_cur = batch.valid & (batch.kind == KIND_CURRENT)
    is_timer = batch.valid & (batch.kind == KIND_TIMER)
    vc = valid_cur.to(torch.int32)
    rank = torch.cumsum(vc, 0, dtype=torch.int32) - vc
    c = vc.sum(dtype=torch.int32)
    seq_batch = torch.where(valid_cur, total + rank, torch.full_like(batch.ts, -1))
    elem_seq = torch.cat([state["seq"], seq_batch])
    elem_wts = torch.cat([state["wts"], bwts])
    elem_ts = torch.cat([state["ts"], batch.ts])
    present = elem_seq >= 0
    rows = torch.arange(bsz, dtype=torch.int64, device=dev)
    own_row = torch.cat([torch.full((w,), -1, dtype=torch.int64, device=dev), rows])

    # capacity: the insertion of seq + W evicts seq
    trig_rank = elem_seq + w - total
    len_ok = present & (trig_rank >= 0) & (trig_rank < c)
    perm = torch.argsort((~valid_cur).to(torch.uint8), stable=True)  # rank -> row
    trig_len = torch.where(len_ok, perm[trig_rank.clamp(0, bsz - 1)], BIG)
    # time: the first CURRENT or TIMER row at or after the element's own whose
    # window time is >= its own + t
    trig_vals = torch.where(valid_cur | is_timer, bwts, _I64_MIN)
    first = _time_trigger_ref(trig_vals, own_row.clamp(min=0), elem_wts + t)
    trig_time = torch.where(present & (first < bsz), first, BIG)
    trig_row = torch.minimum(trig_len, trig_time)
    evict = present & (trig_row < BIG)

    # candidates: k deaths (key 2 * trigger row) and B births (2 * row + 1),
    # ordered by (key, seq)
    cand_key = torch.cat([torch.where(evict, trig_row * 2, BIG),
                          torch.where(valid_cur, rows * 2 + 1, BIG)])
    cand_elem = torch.cat([torch.arange(k, device=dev), torch.arange(w, k, device=dev)])
    cand_exp = torch.cat([torch.ones(k, dtype=torch.bool, device=dev),
                          torch.zeros(bsz, dtype=torch.bool, device=dev)])
    cand_valid = cand_key < BIG
    cand_seq = elem_seq[cand_elem]
    order = torch.argsort(cand_seq, stable=True)
    order = order[torch.argsort(cand_key[order], stable=True)]
    o_valid = cand_valid[order]
    o_exp = cand_exp[order] & o_valid
    o_elem = cand_elem[order]
    o_trig = (cand_key[order] // 2).clamp(0, bsz - 1)
    zero64 = torch.zeros((), dtype=torch.int64, device=dev)
    out_ts = torch.where(o_exp, batch.ts[o_trig], elem_ts[o_elem])
    out = EventBatch(
        ts=torch.where(o_valid, out_ts, zero64),
        kind=(o_exp.to(torch.int8) * KIND_EXPIRED),
        valid=o_valid,
        cols={n: torch.where(o_valid, torch.cat([state["cols"][n], a])[o_elem],
                             torch.zeros((), dtype=a.dtype, device=dev))
              for n, a in batch.cols.items()},
    )

    # lazy membership: element e is in the window at output rows
    # birth <= p < death (absent elements: death -1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=dev)
    inv = inv.to(torch.int32)
    birth = torch.cat([torch.full((w,), -1, dtype=torch.int32, device=dev),
                       torch.where(valid_cur, inv[k:], -1)])
    death = torch.where(evict, inv[:k], BIG)
    death = torch.where(present, death, -1)

    # the ring after the batch (SlidingWindow._ring_state): rows evicted
    # within the batch are not inserted
    ring_evicted = evict[:w]
    insert = valid_cur & ~evict[w:] & (rank >= c - w)
    slots = torch.where(insert, (total + rank) % w, w)

    def place(old, vals, cleared):
        return set_at(torch.where(ring_evicted, cleared, old), slots, vals)

    zero = lambda x: torch.zeros((), dtype=x.dtype, device=dev)  # noqa: E731
    new_seq = place(state["seq"], seq_batch, torch.full((), -1, dtype=torch.int64, device=dev))
    new_state = {
        "cols": {n: place(state["cols"][n], a, zero(a)) for n, a in batch.cols.items()},
        "ts": place(state["ts"], batch.ts, zero64),
        "wts": place(state["wts"], bwts, zero64),
        "seq": new_seq,
        "total": total + c,
    }
    live_wts = torch.where(new_seq >= 0, new_state["wts"], NO_TIMER - t)
    next_timer = live_wts.min() + t
    return out, birth, death, new_state, next_timer


def time_window_step(state: dict, batch: EventBatch, bwts: torch.Tensor, w: int, t: int):
    """One step of a sliding time window (time, timeLength, externalTime):
    B arrivals into a W-slot ring whose elements also expire once a CURRENT
    or TIMER row's window time reaches their own + t.

    state: as `length_window_step`'s ("wts" holds each element's window
           time); bwts: [B] int64 window time of each batch row (the event ts,
           or the externalTime attribute)
    returns (out, birth_pos, death_pos, new_state, next_timer):
      out        [W + 2B] EventBatch: each row's due EXPIREDs (ordered by
                 seq, carrying the trigger row's ts) before its CURRENT, then
                 zeroed padding rows with valid False
      birth_pos / death_pos  [W + B] int32 lazy membership, as
                 `length_window_step`'s
      new_state  the ring after the batch (it may hold holes: seq -1)
      next_timer 0-d int64: the earliest live window time + t (NO_TIMER when
                 the ring is empty)
    """
    if batch.ts.device.type == "cpu":
        return time_window_step_ref(state, batch, bwts, w, t)
    lanes = [batch.ts, batch.kind, batch.valid, bwts, *batch.cols.values(), state["ts"],
             state["wts"], state["seq"], state["total"], *state["cols"].values()]
    kernels.require_cuda("time_window_step", *lanes)
    bsz = batch.capacity
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, bwts,
                                       *batch.cols.values())) or any(
        x.shape != (w,) for x in (state["ts"], state["wts"], state["seq"],
                                  *state["cols"].values())
    ):
        raise ValueError(f"time_window_step: lanes must be [{bsz}] and ring lanes [{w}]")
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype, bwts.dtype, state["seq"].dtype,
            state["wts"].dtype, state["total"].dtype) != (
            torch.int64, torch.int8, torch.bool, torch.int64, torch.int64, torch.int64,
            torch.int64) or any(state["cols"][n].dtype != a.dtype
                                for n, a in batch.cols.items()):
        raise ValueError("time_window_step: lane dtypes must be int64 ts/wts/seq/total, "
                         "int8 kind, bool valid, and each ring column the batch's dtype")
    if w < 1 or 2 * (w + 2 * bsz) >= 2**31:
        raise ValueError(f"time_window_step: batch {bsz} / ring {w} out of range")
    dev = batch.ts.device

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    size = 1 << max(1, int(bsz - 1).bit_length())  # segment-tree leaves >= B
    tree = torch.empty(2 * size, dtype=torch.int64, device=dev)
    rank, perm, count = i32(bsz), i32(bsz), i32(())
    trig, hist, dx, cursor = i32(w + bsz), i32(bsz), i32(bsz), i32(bsz)
    by_seq, dpos = i32(w + bsz), i32(w + bsz)
    n_valid = i32(())
    birth, death = i32(w + bsz), i32(w + bsz)
    n_out = w + 2 * bsz
    out_src, ring_src = i32(n_out), i32(w)
    out_ts = torch.empty(n_out, dtype=torch.int64, device=dev)
    out_kind = torch.empty(n_out, dtype=torch.int8, device=dev)
    out_valid = torch.empty(n_out, dtype=torch.bool, device=dev)
    new_seq = torch.empty(w, dtype=torch.int64, device=dev)
    new_total = torch.empty((), dtype=torch.int64, device=dev)
    next_timer = torch.empty((), dtype=torch.int64, device=dev)
    stream = kernels.stream()
    err = kernels.function("tw_prepare")(
        batch.kind.data_ptr(), batch.valid.data_ptr(), batch.ts.data_ptr(), bwts.data_ptr(),
        state["seq"].data_ptr(), state["wts"].data_ptr(), state["total"].data_ptr(),
        bsz, w, size, t, tree.data_ptr(), rank.data_ptr(), perm.data_ptr(), count.data_ptr(),
        trig.data_ptr(), hist.data_ptr(), dx.data_ptr(), cursor.data_ptr(), by_seq.data_ptr(),
        dpos.data_ptr(), n_valid.data_ptr(), birth.data_ptr(), death.data_ptr(),
        out_src.data_ptr(), out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(),
        ring_src.data_ptr(), new_seq.data_ptr(), new_total.data_ptr(), next_timer.data_ptr(),
        stream,
    )
    kernels.check(err, "time_window_step")

    def gather(ring_lane, batch_lane, idx):
        out = torch.empty(idx.shape[0], dtype=ring_lane.dtype, device=dev)
        fn = kernels.function(f"lw_gather_{ring_lane.element_size()}")
        kernels.check(
            fn(ring_lane.data_ptr(), batch_lane.data_ptr(), idx.data_ptr(),
               out.data_ptr(), idx.shape[0], w, stream),
            "time_window_step",
        )
        return out

    out = EventBatch(
        ts=out_ts, kind=out_kind, valid=out_valid,
        cols={n: gather(state["cols"][n], a, out_src) for n, a in batch.cols.items()},
    )
    new_state = {
        "cols": {n: gather(state["cols"][n], a, ring_src) for n, a in batch.cols.items()},
        "ts": gather(state["ts"], batch.ts, ring_src),
        "wts": gather(state["wts"], bwts, ring_src),
        "seq": new_seq,
        "total": new_total,
    }
    kernels.launches["time_window_step"] += 1
    return out, birth, death, new_state, next_timer


def _view_perm_ref(state: dict):
    """SlidingWindow._view_perm: the live mask and the stable argsort of
    seq (empty slots last, in slot order)."""
    mask = state["seq"] >= 0
    return mask, torch.argsort(torch.where(mask, state["seq"], NO_TIMER), stable=True)


def ring_view_ref(state: dict):
    """Plain version of `ring_view`: every lane gathered by the view
    permutation."""
    mask, perm = _view_perm_ref(state)
    cols = {n: c[perm] for n, c in state["cols"].items()}
    return cols, state["ts"][perm], mask[perm]


def ring_view_seq_ref(state: dict) -> torch.Tensor:
    """Plain version of `ring_view_seq` (SlidingWindow.view_seq): the seq
    lane gathered by the view permutation."""
    return state["seq"][_view_perm_ref(state)[1]]


_RV_SHARED_SLOTS = 56 * 1024  # csrc/ring_view.cu kSharedSlots


def _ring_view_launch(state: dict, what: str, lanes: list, with_mask: bool, with_seq: bool):
    """K11's one launch over a ring on the card (csrc/ring_view.cu `rv_view`):
    each of `lanes` in view order, the mask and K48's seq lane (each when
    asked, else None). Returns (lanes in view order, mask, vseq)."""
    seq, total = state["seq"], state["total"]
    kernels.require_cuda(what, seq, total, *lanes)
    w = seq.shape[0]
    if seq.dtype != torch.int64 or total.dtype != torch.int64 or any(
            x.shape != (w,) for x in lanes):
        raise ValueError(f"{what}: int64 seq/total and [{w}] ring lanes expected")
    dev = seq.device
    n = len(lanes)
    dtypes = [x.dtype for x in lanes] + [torch.bool] * with_mask + [torch.int64] * with_seq
    bufs = [torch.empty(w, dtype=dt, device=dev) for dt in dtypes]
    mask = bufs[n] if with_mask else None
    vseq = bufs[-1] if with_seq else None
    src = (ctypes.c_void_p * max(n, 1))(*[x.data_ptr() for x in lanes])
    dst = (ctypes.c_void_p * max(n, 1))(*[x.data_ptr() for x in bufs[:n]])
    size = (ctypes.c_int * max(n, 1))(*[x.element_size() for x in lanes])
    scratch = torch.empty(w, dtype=torch.int32, device=dev) if w > _RV_SHARED_SLOTS else None
    kernels.check(kernels.function("rv_view")(
        seq.data_ptr(), total.data_ptr(), w, None if scratch is None else scratch.data_ptr(),
        n, ctypes.addressof(src), ctypes.addressof(dst), ctypes.addressof(size),
        None if mask is None else mask.data_ptr(), None if vseq is None else vseq.data_ptr(),
        kernels.stream()), what)
    return bufs[:n], mask, vseq


def ring_view_seq(state: dict) -> torch.Tensor:
    """K48: a sliding ring's admission seqs in `ring_view` order (JAX
    SlidingWindow.view_seq: the live slots' seqs ascending, then the empty
    slots' own seqs, -1, in slot order), [W] int64, from K11's launch with
    no lane but the seq (csrc/ring_view.cu `rv_view`)."""
    if state["seq"].device.type == "cpu":
        return ring_view_seq_ref(state)
    vseq = _ring_view_launch(state, "ring_view_seq", [], False, True)[2]
    kernels.launches["ring_view_seq"] += 1
    return vseq


def ring_view(state: dict, with_seq: bool = False):
    """A sliding ring's stored contents in insertion order, for a join's
    probe (reference: FindableProcessor.find over the window buffer):
    (cols {name: [W]}, ts [W], mask [W]), live elements first by seq, then
    the empty slots in slot order. Live seqs lie in [total - W, total), so
    the order is a rank over that dense range, and one launch places every
    lane (csrc/ring_view.cu `rv_view`). With `with_seq` also the seq lane in
    the same order (K48) from the same launch, so the view and its seqs are
    paired by position."""
    if state["seq"].device.type == "cpu":
        view = ring_view_ref(state)
        return (*view, ring_view_seq_ref(state)) if with_seq else view
    names = list(state["cols"])
    lanes = [state["cols"][n] for n in names] + [state["ts"]]
    outs, mask, vseq = _ring_view_launch(state, "ring_view", lanes, True, with_seq)
    kernels.launches["ring_view"] += 1
    if with_seq:
        kernels.launches["ring_view_seq"] += 1
    cols = dict(zip(names, outs[:-1]))
    return (cols, outs[-1], mask, vseq) if with_seq else (cols, outs[-1], mask)


class SlidingWindow(WindowStage):
    """A ring of capacity W that always length-evicts at W, plus an optional
    time predicate over each element's window time (the event ts, or an
    attribute for externalTime). Covers length(N) [W = N], time(T),
    timeLength(T, N) and externalTime(attr, T).

    Overflow policy for time windows (as the JAX package's): when more than W
    events are live at once, the oldest are evicted EARLY and still emitted
    as EXPIRED, so downstream aggregates stay consistent; only the expiry
    time is early. Raise DEFAULT_TIME_CAPACITY if that matters."""

    def __init__(self, schema: StreamSchema, ref: str, capacity: int, device,
                 duration_ms: int | None = None, time_attr: str | None = None,
                 use_scheduler: bool = False):
        if capacity < 1:
            raise SiddhiAppCreationError(f"window needs a length >= 1, got {capacity}")
        self.schema = schema
        self.ref = ref
        self.w = int(capacity)
        self.t = duration_ms
        self.time_attr = time_attr
        self.needs_scheduler = use_scheduler
        self.device = torch.device(device)

    def init_state(self):
        w, dev = self.w, self.device
        return {
            "cols": {
                n: torch.zeros(w, dtype=PHYSICAL_DTYPE[t], device=dev)
                for n, t in self.schema.attrs
            },
            "ts": torch.zeros(w, dtype=torch.int64, device=dev),
            "wts": torch.zeros(w, dtype=torch.int64, device=dev),
            "seq": torch.full((w,), -1, dtype=torch.int64, device=dev),
            "total": torch.zeros((), dtype=torch.int64, device=dev),
        }

    def apply(self, state, flow: Flow):
        b = flow.batch
        aux = dict(flow.aux)
        if flow.partition is not None:
            return self._apply_partitioned(state, flow, aux)
        if self.t is None:
            out, birth, death, new_state = length_window_step(state, b, self.w)
        else:
            bwts = b.ts if self.time_attr is None else b.cols[self.time_attr].to(torch.int64)
            out, birth, death, new_state, next_timer = time_window_step(
                state, b, bwts.contiguous(), self.w, self.t)
            if self.needs_scheduler:
                aux["next_timer"] = next_timer
        # the window's elements (ring slots, then batch rows), for aggregators
        # that reduce over membership
        member_cols = {
            (self.ref, None, n): torch.cat([state["cols"][n], b.cols[n]]) for n in b.cols
        }
        member_cols[(self.ref, None, TS_ATTR)] = torch.cat([state["ts"], b.ts])
        return new_state, Flow(
            batch=out,
            ref=flow.ref,
            now=flow.now,
            birth_pos=birth,
            death_pos=death,
            member_env=Env(member_cols, now=flow.now),
            aux=aux,
        )

    def _apply_partitioned(self, state, flow: Flow, aux: dict):
        """Inside a partition (the ring lanes gain a leading [P] axis):
        every partition's step at once by the row slots, the length window
        by K29 and the time windows by K31 (ops/partition.py), the rows out
        in (position, slot) order."""
        from siddhi_tpu_torch.core.groupby import PARTITION_SLOT_KEY, partition_ctx
        from siddhi_tpu_torch.ops.partition import (
            partition_length_window_step,
            partition_time_window_step,
        )

        b, ctx = flow.batch, flow.partition
        if self.t is None:
            out, birth, death, new_state, members = partition_length_window_step(
                state, b, ctx.slot, self.w, ctx.capacity)
        else:
            bwts = b.ts if self.time_attr is None else b.cols[self.time_attr].to(torch.int64)
            out, birth, death, new_state, next_timer, members = partition_time_window_step(
                state, b, bwts.contiguous(), ctx.slot, self.w, self.t, ctx.capacity)
            if self.needs_scheduler:
                aux["next_timer"] = next_timer
        member_cols = {(self.ref, None, n): torch.cat([state["cols"][n].reshape(-1), b.cols[n]])
                       for n in b.cols}
        member_cols[(self.ref, None, TS_ATTR)] = torch.cat([state["ts"].reshape(-1), b.ts])
        member_cols[PARTITION_SLOT_KEY] = members.elem_slot
        return new_state, Flow(
            batch=out, ref=flow.ref, now=flow.now, birth_pos=birth, death_pos=death,
            member_env=Env(member_cols, now=flow.now), aux=aux,
            partition=partition_ctx(members.slot, members.first, ctx.capacity, ctx.overflow,
                                    members))

    def view(self, state):
        if state["seq"].dim() == 2:  # inside a partition: every slot's ring (K38)
            from siddhi_tpu_torch.ops.partition import partition_ring_view

            return partition_ring_view(state)
        return ring_view(state)

    def view_seq(self, state):
        return ring_view_seq(state)

    def view_with_seq(self, state):
        return ring_view(state, with_seq=True)


# ---------------------------------------------------------------------------
# batch (tumbling) family: lengthBatch, timeBatch, externalTimeBatch
# ---------------------------------------------------------------------------

def _flush_count(bsz: int, n: int) -> int:
    """F: at most bsz // n + 1 flushes fit in one batch (the carried bucket
    holds fewer than n rows), so the flush bookkeeping lanes are [F]."""
    return min(bsz // n + 2, bsz)


def batch_window_rows(bsz: int, n: int, emit_expired: bool) -> int:
    """Rows of the flow a lengthBatch(n) step hands on: 3n + 2B + F with the
    EXPIRED lanes, n + B + F without."""
    f = _flush_count(bsz, n)
    return 3 * n + 2 * bsz + f if emit_expired else n + bsz + f


def time_batch_rows(bsz: int, w: int, emit_expired: bool) -> int:
    """Rows of the flow a time-batch step hands on (F = B flush lanes):
    3w + 3B with the EXPIRED lanes, w + 2B without."""
    return 3 * w + 3 * bsz if emit_expired else w + 2 * bsz


def _batch_flush_ref(state: dict, batch: EventBatch, w: int, F: int, valid_cur, e_row,
                     n_flush, row_of_flush, emit_expired: bool):
    """The emission both batch branches share, in the JAX package's
    formulation: candidate keys trigger_row*4 + {0 expired, 1 reset,
    2 current} for every carried, previous-bucket, batch and reset candidate,
    one stable sort by (key, tie), the lanes gathered in that order, and the
    new buffers scattered from the flush arithmetic. Padding rows are zeroed.
    `e_row` is each CURRENT row's bucket (flushes at or before it),
    `row_of_flush` [F] the row of each flush."""
    dev = batch.ts.device
    bsz = batch.capacity
    big = BIG
    cur_n0 = state["cur_n"]
    any_flush = n_flush > 0
    f_arr = torch.arange(F, dtype=torch.int32, device=dev)
    flush_exists = f_arr < n_flush

    def flush_key(f, kindbit):
        return row_of_flush[f.clamp(0, F - 1).long()] * 4 + kindbit

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    cw = torch.arange(w, dtype=torch.int32, device=dev)
    rows = torch.arange(bsz, dtype=torch.int32, device=dev)
    carried_valid = cw < cur_n0
    cc_cur_key = torch.where(carried_valid & any_flush, flush_key(zero_i, 2), big)
    cc_exp_key = torch.where(carried_valid & (n_flush > 1), flush_key(zero_i + 1, 0), big)
    prev_valid = cw < state["prev_n"]
    pv_exp_key = torch.where(prev_valid & any_flush, flush_key(zero_i, 0), big)
    row_emit = valid_cur & (e_row < n_flush)
    bt_cur_key = torch.where(row_emit, flush_key(e_row, 2), big)
    bt_exp_key = torch.where(row_emit & (e_row + 1 < n_flush), flush_key(e_row + 1, 0), big)
    rs_key = torch.where(flush_exists, row_of_flush * 4 + 1, big)

    def full(k, v):
        return torch.full((k,), v, dtype=torch.int8, device=dev)

    if emit_expired:
        cand_key = torch.cat([cc_cur_key, cc_exp_key, pv_exp_key, bt_cur_key, bt_exp_key, rs_key])

        def lanes(cur, prev, bat):
            return torch.cat([cur, cur, prev, bat, bat, cur[:1].expand(F)])

        cand_kind = torch.cat([
            full(w, KIND_CURRENT), full(w, KIND_EXPIRED), full(w, KIND_EXPIRED),
            full(bsz, KIND_CURRENT), full(bsz, KIND_EXPIRED), full(F, KIND_RESET),
        ])
        tie = torch.cat([cw, cw, cw, rows + w, rows + w, f_arr])
        bt_cur_off = 3 * w
    else:
        cand_key = torch.cat([cc_cur_key, bt_cur_key, rs_key])

        def lanes(cur, prev, bat):
            return torch.cat([cur, bat, cur[:1].expand(F)])

        cand_kind = torch.cat([full(w, KIND_CURRENT), full(bsz, KIND_CURRENT), full(F, KIND_RESET)])
        tie = torch.cat([cw, rows + w, f_arr])
        bt_cur_off = w
    cand_valid = cand_key < big
    order = torch.argsort(tie, stable=True)
    order = order[torch.argsort(cand_key[order], stable=True)]
    o_valid = cand_valid[order]
    o_kind = torch.where(o_valid, cand_kind[order], 0).to(torch.int8)
    o_ts = lanes(state["cur_ts"], state["prev_ts"], batch.ts)[order]
    if emit_expired:
        trig_ts = batch.ts[torch.div(cand_key[order], 4, rounding_mode="floor").clamp(0, bsz - 1)]
        o_ts = torch.where(o_kind == KIND_EXPIRED, trig_ts, o_ts)
    o_ts = torch.where(o_valid, o_ts, 0)
    o_cols = {}
    for nm in batch.cols:
        lane = lanes(state["cur_cols"][nm], state["prev_cols"][nm], batch.cols[nm])[order]
        o_cols[nm] = torch.where(o_valid, lane, torch.zeros((), dtype=lane.dtype, device=dev))
    out = EventBatch(ts=o_ts, kind=o_kind, valid=o_valid, cols=o_cols)

    # lazy membership over the elements [carried w | prev w | batch B]
    birth = death = None
    if emit_expired:
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=dev)
        inv = inv.to(torch.int32)
        birth_cc = torch.where(carried_valid & any_flush, inv[:w], big)
        birth_bt = torch.where(row_emit, inv[bt_cur_off: bt_cur_off + bsz], big)
        death_cc = torch.where(carried_valid & (n_flush > 1), inv[w: 2 * w], big)
        death_bt = torch.where(row_emit & (e_row + 1 < n_flush),
                               inv[3 * w + bsz: 3 * w + 2 * bsz], big)

        def prev_lane(v):
            return torch.full((w,), v, dtype=torch.int32, device=dev)

        birth = torch.cat([birth_cc, prev_lane(big), birth_bt])
        death = torch.cat([death_cc, prev_lane(-1), death_bt])

    # new buffers: the open bucket (filled by rank after the carried rows
    # when nothing flushed) and the last flushed one
    remaining = valid_cur & (e_row == n_flush)
    keep_carried = ~any_flush
    rm = remaining.to(torch.int32)
    rem_rank = torch.cumsum(rm, 0, dtype=torch.int32) - rm
    rem_slot = torch.where(remaining, rem_rank + torch.where(keep_carried, cur_n0, 0), w)

    def place_cur(old, vals):
        kept = torch.where(keep_carried, old, torch.zeros_like(old))
        return set_at(kept, rem_slot, vals)

    new_cur_n = (torch.where(keep_carried, cur_n0, 0) + rm.sum(dtype=torch.int32)).to(torch.int32)
    in_last = row_emit & (e_row == n_flush - 1)
    carried_in_last = carried_valid & (n_flush == 1)
    n_carried_last = torch.where(n_flush == 1, cur_n0, 0)
    il = in_last.to(torch.int32)
    lb_rank = torch.cumsum(il, 0, dtype=torch.int32) - il
    lb_slot_c = torch.where(carried_in_last, cw, w)
    lb_slot_b = torch.where(in_last, n_carried_last + lb_rank, w)

    def place_prev(old_prev, carried_vals, batch_vals):
        base = torch.where(any_flush, torch.zeros_like(old_prev), old_prev)
        base = set_at(base, lb_slot_c, carried_vals)
        return set_at(base, lb_slot_b, batch_vals)

    new_prev_n = torch.where(any_flush, n_carried_last + il.sum(dtype=torch.int32),
                             state["prev_n"]).to(torch.int32)
    new_state = {
        "cur_cols": {nm: place_cur(state["cur_cols"][nm], batch.cols[nm]) for nm in batch.cols},
        "cur_ts": place_cur(state["cur_ts"], batch.ts),
        "cur_n": new_cur_n,
        "prev_cols": {nm: place_prev(state["prev_cols"][nm], state["cur_cols"][nm], batch.cols[nm])
                      for nm in batch.cols},
        "prev_ts": place_prev(state["prev_ts"], state["cur_ts"], batch.ts),
        "prev_n": new_prev_n,
        "bucket_start": state["bucket_start"],
        "timeout_deadline": state["timeout_deadline"],
    }
    return out, birth, death, new_state


def batch_window_step_ref(state: dict, batch: EventBatch, n: int, emit_expired: bool):
    """Plain version of `batch_window_step`: the lengthBatch flush lanes in
    the JAX package's formulation (flush f at the row completing bucket
    f + 1: rank and perm by cumsum and a stable argsort), then the shared
    emission `_batch_flush_ref`."""
    dev = batch.ts.device
    bsz = batch.capacity
    valid_cur = batch.valid & (batch.kind == KIND_CURRENT)
    vc = valid_cur.to(torch.int32)
    rank = torch.cumsum(vc, 0, dtype=torch.int32) - vc
    c = vc.sum(dtype=torch.int32)
    perm = torch.argsort((~valid_cur).to(torch.uint8), stable=True).to(torch.int32)
    cur_n0 = state["cur_n"]
    F = _flush_count(bsz, n)
    e_row = torch.div(cur_n0 + rank, n, rounding_mode="floor")
    n_flush = torch.div(cur_n0 + c, n, rounding_mode="floor")
    f_arr = torch.arange(F, dtype=torch.int32, device=dev)
    trig_rank_f = (f_arr + 1) * n - 1 - cur_n0
    flush_exists = (trig_rank_f >= 0) & (trig_rank_f < c)
    row_of_flush = torch.where(
        flush_exists, perm[trig_rank_f.clamp(0, bsz - 1).long()], bsz - 1
    ).to(torch.int64)
    return _batch_flush_ref(state, batch, n, F, valid_cur, e_row, n_flush, row_of_flush,
                            emit_expired)


def batch_window_step(state: dict, batch: EventBatch, n: int, emit_expired: bool):
    """One lengthBatch(n) step over a batch of B arrivals.

    state: {"cur_cols": {name: [n]}, "cur_ts": [n] int64, "cur_n": 0-d int32
            (the open bucket), "prev_cols", "prev_ts", "prev_n" (the last
            flushed bucket), "bucket_start", "timeout_deadline" (0-d int64,
            carried unchanged: they belong to the time branches)}
    Every flush f (the row completing the bucket) emits, in order: the
    previous bucket's EXPIRED rows (with the trigger row's ts; only when
    emit_expired), one RESET row (carrying the open bucket's first element
    cur[0], cur_ts[0]), then the closing bucket's CURRENT rows (carried rows
    first at flush 0, then batch rows in arrival order). Padding rows follow
    with valid False.
    returns (out, birth_pos, death_pos, new_state):
      out        [batch_window_rows(B, n, emit_expired)] EventBatch
      birth_pos / death_pos  [2n + B] int32 lazy membership of the elements
                 (carried bucket, previous bucket, batch rows) — None when
                 emit_expired is off
      new_state  the buffers after the batch (new tensors)
    """
    if batch.ts.device.type == "cpu":
        return batch_window_step_ref(state, batch, n, emit_expired)
    _check_batch_lanes("batch_window_step", state, batch, n)
    bsz, w = batch.capacity, n
    n_rows = batch_window_rows(bsz, n, emit_expired)
    if n < 1 or n_rows + 2 * w + bsz >= 2**31:
        raise ValueError(f"batch_window_step: batch {bsz} / length {n} out of range")
    dev = batch.ts.device
    scan, (rank, perm, e_row, flush_row, flush_q, flush_start, out_src, cur_src,
           prev_src) = _batch_scratch(dev, bsz, w, n_rows)
    out_ts = torch.empty(n_rows, dtype=torch.int64, device=dev)
    out_kind = torch.empty(n_rows, dtype=torch.int8, device=dev)
    out_valid = torch.empty(n_rows, dtype=torch.bool, device=dev)
    birth, death = _membership_lanes(dev, 2 * w + bsz, emit_expired)
    new_cur_n, new_prev_n = torch.empty(2, dtype=torch.int32, device=dev).unbind()
    err = kernels.function("bw_prepare")(
        batch.kind.data_ptr(), batch.valid.data_ptr(), batch.ts.data_ptr(),
        state["cur_ts"].data_ptr(), state["cur_n"].data_ptr(), state["prev_n"].data_ptr(),
        bsz, w, n_rows, int(emit_expired), rank.data_ptr(), perm.data_ptr(), e_row.data_ptr(),
        flush_row.data_ptr(), flush_q.data_ptr(), flush_start.data_ptr(), scan.data_ptr(),
        out_src.data_ptr(), out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(),
        birth.data_ptr() if emit_expired else None, death.data_ptr() if emit_expired else None,
        cur_src.data_ptr(), prev_src.data_ptr(), new_cur_n.data_ptr(), new_prev_n.data_ptr(),
        kernels.stream(),
    )
    kernels.check(err, "batch_window_step")
    out, new_state = _gather_batch_lanes("batch_window_step", state, batch, w, out_src,
                                         out_ts, out_kind, out_valid, cur_src, prev_src,
                                         new_cur_n, new_prev_n, state["bucket_start"],
                                         state["timeout_deadline"])
    kernels.launches["batch_window_step"] += 1
    return out, birth, death, new_state


def _batch_scratch(dev, bsz: int, w: int, n_rows: int):
    """One int32 allocation for a batch step's scratch: the flush pass's
    32-byte scalars (first, for their int64 alignment), then rank, perm,
    e_row, flush_row, flush_q [B], flush_start [B + 1], the output rows'
    sources and the two buffers' sources."""
    sizes = (bsz,) * 5 + (bsz + 1, n_rows, w, w)
    buf = torch.empty(8 + sum(sizes), dtype=torch.int32, device=dev)
    return buf[:8], buf[8:].split(sizes)


def _membership_lanes(dev, k: int, emit_expired: bool):
    if not emit_expired:
        return None, None
    return torch.empty((2, k), dtype=torch.int32, device=dev).unbind()


def _check_batch_lanes(what: str, state: dict, batch: EventBatch, w: int) -> None:
    lanes = [batch.ts, batch.kind, batch.valid, *batch.cols.values(), state["cur_ts"],
             state["prev_ts"], state["cur_n"], state["prev_n"], state["bucket_start"],
             state["timeout_deadline"], *state["cur_cols"].values(),
             *state["prev_cols"].values()]
    kernels.require_cuda(what, *lanes)
    bsz = batch.capacity
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, *batch.cols.values())) or any(
        x.shape != (w,) for x in (state["cur_ts"], state["prev_ts"],
                                  *state["cur_cols"].values(), *state["prev_cols"].values())
    ):
        raise ValueError(f"{what}: lanes must be [{bsz}] and buffers [{w}]")
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype, state["cur_ts"].dtype,
            state["prev_ts"].dtype, state["cur_n"].dtype, state["prev_n"].dtype,
            state["bucket_start"].dtype, state["timeout_deadline"].dtype) != (
            torch.int64, torch.int8, torch.bool, torch.int64, torch.int64, torch.int32,
            torch.int32, torch.int64, torch.int64) or any(
                state["cur_cols"][c].dtype != batch.cols[c].dtype
                or state["prev_cols"][c].dtype != batch.cols[c].dtype for c in batch.cols):
        raise ValueError(f"{what}: lane dtypes must be int64 ts and times, int8 kind, bool "
                         "valid, int32 counts, and each buffer column the batch's dtype")


def _gather_batch_lanes(what, state, batch, w, out_src, out_ts, out_kind, out_valid, cur_src,
                        prev_src, cur_n, prev_n, bucket_start, timeout_deadline):
    """The output batch and the new state: the columns and buffers each
    gathered from [carried w | previous w | batch B] by
    csrc/batch_window.cu's bw_gather, and the given scalars."""
    dev = batch.ts.device
    stream = kernels.stream()

    def gather(cur, prev, bat, idx):
        out = torch.empty(idx.shape[0], dtype=cur.dtype, device=dev)
        fn = kernels.function(f"bw_gather_{cur.element_size()}")
        kernels.check(
            fn(cur.data_ptr(), prev.data_ptr(), bat.data_ptr(), idx.data_ptr(), out.data_ptr(),
               idx.shape[0], w, stream),
            what,
        )
        return out

    sc, sp = state["cur_cols"], state["prev_cols"]
    cols = list(batch.cols)
    out = EventBatch(
        ts=out_ts, kind=out_kind, valid=out_valid,
        cols={c: gather(sc[c], sp[c], batch.cols[c], out_src) for c in cols},
    )
    new_state = {
        "cur_cols": {c: gather(sc[c], sp[c], batch.cols[c], cur_src) for c in cols},
        "cur_ts": gather(state["cur_ts"], state["prev_ts"], batch.ts, cur_src),
        "cur_n": cur_n,
        "prev_cols": {c: gather(sc[c], sp[c], batch.cols[c], prev_src) for c in cols},
        "prev_ts": gather(state["cur_ts"], state["prev_ts"], batch.ts, prev_src),
        "prev_n": prev_n,
        "bucket_start": bucket_start,
        "timeout_deadline": timeout_deadline,
    }
    return out, new_state


# next_timer modes of the time branch: none (externalTimeBatch), the open
# bucket's end (timeBatch), the idle timeout (externalTimeBatch with one)
TIMER_NONE, TIMER_BUCKET, TIMER_TIMEOUT = 0, 1, 2


def time_batch_step_ref(state: dict, batch: EventBatch, wts: torch.Tensor, now: torch.Tensor,
                        w: int, t: int, start_time, timeout_ms, timer_mode: int,
                        emit_expired: bool):
    """Plain version of `time_batch_step`, in the JAX package's formulation
    (BatchWindow.apply's time branch): the bucket index g of each trigger
    row, open_g as a cummax seeded with the carried bucket, the flushes
    (plus the positional idle-timeout flush), e_row by an inclusive cumsum,
    row_of_flush by a stable argsort, then the shared emission, the new
    bucket start, the idle deadline and next_timer."""
    dev = batch.ts.device
    bsz = batch.capacity
    big = BIG
    valid_cur = batch.valid & (batch.kind == KIND_CURRENT)
    is_timer = batch.valid & (batch.kind == KIND_TIMER)
    vc = valid_cur.to(torch.int32)
    rank = torch.cumsum(vc, 0, dtype=torch.int32) - vc
    trigger_ok = valid_cur | is_timer
    bs = state["bucket_start"]
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
    if start_time is not None:
        start0 = torch.full((), int(start_time), dtype=torch.int64, device=dev)
    else:
        first_trig = torch.argmax(trigger_ok.to(torch.int8))
        start0 = torch.where(bs >= 0, bs, torch.where(trigger_ok.any(), wts[first_trig], minus1))
    rel = torch.clamp(wts - start0, min=0)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    g = torch.where(trigger_ok & (start0 >= 0), torch.div(rel, t, rounding_mode="floor"), zero)
    carried_g = torch.where(bs >= 0, torch.div(torch.clamp(bs - start0, min=0), t,
                                               rounding_mode="floor"), zero)
    open_g = torch.cummax(torch.maximum(g, carried_g), 0).values
    prev_open = torch.cat([carried_g[None], open_g[:-1]])
    tr = trigger_ok.to(torch.int32)
    had_bucket = (bs >= 0) | ((torch.cumsum(tr, 0, dtype=torch.int32) - tr) > 0)
    flush_here = trigger_ok & (g > prev_open) & had_bucket
    if timeout_ms is not None:
        # positional: only a TIMER with no CURRENT row before it in the
        # batch can see a genuinely elapsed deadline
        flush_here = flush_here | (is_timer & (rank == 0) & (state["cur_n"] > 0)
                                   & (now >= state["timeout_deadline"]))
    fh = flush_here.to(torch.int32)
    e_row = torch.cumsum(fh, 0, dtype=torch.int32)  # inclusive: a flush at i precedes row i
    n_flush = fh.sum(dtype=torch.int32)
    rows = torch.arange(bsz, dtype=torch.int32, device=dev)
    by_flush = torch.argsort(torch.where(flush_here, rows, big), stable=True)
    row_of_flush = torch.where(rows < n_flush, by_flush, bsz - 1).to(torch.int64)
    new_bucket_start = torch.where(trigger_ok.any() & (start0 >= 0), start0 + open_g[-1] * t,
                                   start0)
    e_row = torch.where(valid_cur, e_row, 0)
    out, birth, death, new_state = _batch_flush_ref(state, batch, w, bsz, valid_cur, e_row,
                                                    n_flush, row_of_flush, emit_expired)
    new_state["bucket_start"] = new_bucket_start
    no_timer = torch.full((), NO_TIMER, dtype=torch.int64, device=dev)
    if timer_mode == TIMER_TIMEOUT:
        # wall-clock idle deadline: every arriving CURRENT row pushes it on;
        # with an empty open bucket there is none
        new_state["timeout_deadline"] = torch.where(
            valid_cur.any(), now + timeout_ms,
            torch.where(new_state["cur_n"] > 0, state["timeout_deadline"], no_timer))
        next_timer = torch.where(new_state["cur_n"] > 0, new_state["timeout_deadline"],
                                 no_timer)
    elif timer_mode == TIMER_BUCKET:
        next_timer = torch.where(new_bucket_start >= 0, new_bucket_start + t, no_timer)
    else:
        next_timer = no_timer
    return out, birth, death, new_state, next_timer


def time_batch_step(state: dict, batch: EventBatch, wts: torch.Tensor, now: torch.Tensor,
                    w: int, t: int, start_time, timeout_ms, timer_mode: int,
                    emit_expired: bool):
    """One timeBatch / externalTimeBatch step over a batch of B rows
    (arrivals and TIMER rows) against a [w] open bucket and a [w] previous
    bucket.

    state: the lengthBatch step's buffers, with "bucket_start" (the open
           bucket's start, -1 before any) and "timeout_deadline" (the armed
           wall-clock idle deadline, NO_TIMER when none) in use
    wts:   [B] int64 window time of each row (the ts lane, or the
           externalTimeBatch attribute); now: 0-d int64 clock
    t:     the duration (ms); start_time: the grid's start or None (the
           first trigger row's time); timeout_ms: the idle timeout or None;
    timer_mode: TIMER_NONE / TIMER_BUCKET / TIMER_TIMEOUT (what next_timer
           reports)
    A trigger row (CURRENT or TIMER) whose bucket index
    (wts - start) // t passes the open bucket's flushes it: the previous
    bucket's EXPIRED rows (with the trigger row's ts; only when
    emit_expired), a RESET, then the closing bucket's CURRENT rows; so does
    an elapsed idle timeout at a TIMER row with no CURRENT row before it.
    returns (out, birth_pos, death_pos, new_state, next_timer):
      out        [time_batch_rows(B, w, emit_expired)] EventBatch
      birth_pos / death_pos  [2w + B] int32 lazy membership (None without
                 the EXPIRED lanes)
      new_state  the buffers, counts, bucket start and idle deadline
      next_timer 0-d int64 (NO_TIMER: none)
    """
    if batch.ts.device.type == "cpu":
        return time_batch_step_ref(state, batch, wts, now, w, t, start_time, timeout_ms,
                                   timer_mode, emit_expired)
    _check_batch_lanes("time_batch_step", state, batch, w)
    kernels.require_cuda("time_batch_step", wts, now)
    bsz = batch.capacity
    n_rows = time_batch_rows(bsz, w, emit_expired)
    if (wts.shape != (bsz,) or wts.dtype != torch.int64 or now.shape != ()
            or now.dtype != torch.int64 or w < 1 or t < 1
            or n_rows + 2 * w + bsz >= 2**31):
        raise ValueError(f"time_batch_step: [B] int64 times, a 0-d int64 clock, w >= 1 and "
                         f"t >= 1 within range; got batch {bsz}, w {w}, t {t}")
    dev = batch.ts.device
    scan, (rank, perm, e_row, flush_row, flush_q, flush_start, out_src, cur_src,
           prev_src) = _batch_scratch(dev, bsz, w, n_rows)
    out_ts = torch.empty(n_rows, dtype=torch.int64, device=dev)
    out_kind = torch.empty(n_rows, dtype=torch.int8, device=dev)
    out_valid = torch.empty(n_rows, dtype=torch.bool, device=dev)
    birth, death = _membership_lanes(dev, 2 * w + bsz, emit_expired)
    new_cur_n, new_prev_n = torch.empty(2, dtype=torch.int32, device=dev).unbind()
    new_bs, new_dl, next_timer = torch.empty(3, dtype=torch.int64, device=dev).unbind()
    err = kernels.function("tb_prepare")(
        batch.kind.data_ptr(), batch.valid.data_ptr(), batch.ts.data_ptr(), wts.data_ptr(),
        state["cur_ts"].data_ptr(), state["cur_n"].data_ptr(), state["prev_n"].data_ptr(),
        state["bucket_start"].data_ptr(), state["timeout_deadline"].data_ptr(), now.data_ptr(),
        bsz, w, n_rows, int(emit_expired), int(t), int(start_time is not None),
        int(start_time or 0), timer_mode, int(timeout_ms or 0),
        rank.data_ptr(), perm.data_ptr(), e_row.data_ptr(), flush_row.data_ptr(),
        flush_q.data_ptr(), flush_start.data_ptr(), scan.data_ptr(), out_src.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(),
        birth.data_ptr() if emit_expired else None, death.data_ptr() if emit_expired else None,
        cur_src.data_ptr(), prev_src.data_ptr(), new_cur_n.data_ptr(), new_prev_n.data_ptr(),
        new_bs.data_ptr(), new_dl.data_ptr(), next_timer.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "time_batch_step")
    out, new_state = _gather_batch_lanes("time_batch_step", state, batch, w, out_src, out_ts,
                                         out_kind, out_valid, cur_src, prev_src, new_cur_n,
                                         new_prev_n, new_bs, new_dl)
    kernels.launches["time_batch_step"] += 1
    return out, birth, death, new_state, next_timer


class BatchWindow(WindowStage):
    """Tumbling buckets: every `length` events (lengthBatch) or at each
    `duration_ms` boundary of the window time (timeBatch on the event
    timestamp, externalTimeBatch on `time_attr`). On each flush the
    reference emits the previous bucket's EXPIREDs, a RESET, then the
    closing bucket's CURRENTs (LengthBatchWindowProcessor.java:108-160).
    timeBatch needs the scheduler (a TIMER row at the open bucket's end
    closes it); externalTimeBatch with `timeout_ms` re-arms a WALL-CLOCK idle
    deadline on every event, and a TIMER arriving with a nonempty open
    bucket and no CURRENT row before it force-closes the bucket without
    moving the grid (ExternalTimeBatchWindowProcessor, lines 243-258).
    A time bucket holds `capacity` slots; rows past them are dropped.

    `emit_expired`: the query runtime clears it when nothing can observe
    EXPIRED rows (`insert [current] into` output and no membership-reading
    aggregator); the flow then has no EXPIRED lanes and no membership."""

    is_batch = True

    def __init__(self, schema: StreamSchema, ref: str, length, device, capacity=None,
                 duration_ms=None, time_attr=None, start_time=None, timeout_ms=None):
        if (length is None) == (duration_ms is None):
            raise SiddhiAppCreationError("batch window needs length xor duration")
        if length is not None and length < 1:
            raise SiddhiAppCreationError(f"lengthBatch window needs a length >= 1, got {length}")
        self.schema = schema
        self.ref = ref
        self.n = None if length is None else int(length)
        self.w = self.n if length is not None else int(capacity)
        self.t = duration_ms
        self.time_attr = time_attr
        self.start_time = start_time
        self.timeout_ms = timeout_ms
        # timeBatch closes its bucket at a TIMER; externalTimeBatch needs one
        # only for the idle timeout
        timebatch = duration_ms is not None and time_attr is None
        self.needs_scheduler = timebatch or timeout_ms is not None
        self.timer_mode = (TIMER_TIMEOUT if timeout_ms is not None
                           else TIMER_BUCKET if timebatch else TIMER_NONE)
        self.device = torch.device(device)
        self.emit_expired = True

    def init_state(self):
        w, dev = self.w, self.device

        def cols():
            return {nm: torch.zeros(w, dtype=PHYSICAL_DTYPE[t], device=dev)
                    for nm, t in self.schema.attrs}

        return {
            "cur_cols": cols(),
            "cur_ts": torch.zeros(w, dtype=torch.int64, device=dev),
            "cur_n": torch.zeros((), dtype=torch.int32, device=dev),
            "prev_cols": cols(),
            "prev_ts": torch.zeros(w, dtype=torch.int64, device=dev),
            "prev_n": torch.zeros((), dtype=torch.int32, device=dev),
            "bucket_start": torch.full((), -1, dtype=torch.int64, device=dev),
            "timeout_deadline": torch.full((), NO_TIMER, dtype=torch.int64, device=dev),
        }

    def apply(self, state, flow: Flow):
        b = flow.batch
        aux = dict(flow.aux)
        if flow.partition is not None:
            return self._apply_partitioned(state, flow, aux)
        if self.n is not None:
            out, birth, death, new_state = batch_window_step(state, b, self.n, self.emit_expired)
        else:
            wts = b.cols[self.time_attr].to(torch.int64) if self.time_attr else b.ts
            out, birth, death, new_state, next_timer = time_batch_step(
                state, b, wts.contiguous(), flow.now, self.w, self.t, self.start_time,
                self.timeout_ms, self.timer_mode, self.emit_expired)
            if self.needs_scheduler:
                aux["next_timer"] = next_timer
        member_env = None
        if self.emit_expired:
            member_cols = {
                (self.ref, None, nm): torch.cat([state["cur_cols"][nm], state["prev_cols"][nm],
                                                 b.cols[nm]])
                for nm in b.cols
            }
            member_cols[(self.ref, None, TS_ATTR)] = torch.cat(
                [state["cur_ts"], state["prev_ts"], b.ts])
            member_env = Env(member_cols, now=flow.now)
        return new_state, Flow(batch=out, ref=flow.ref, now=flow.now, birth_pos=birth,
                               death_pos=death, member_env=member_env, aux=aux)

    def _apply_partitioned(self, state, flow: Flow, aux: dict):
        """Inside a partition (the buffers gain a leading [P] axis): every
        partition's step at once by the row slots (ops/partition.py K32),
        the rows out in (position, slot) order; the elements of the
        membership are each slot's open then previous bucket, then the
        batch rows."""
        from siddhi_tpu_torch.core.groupby import PARTITION_SLOT_KEY, partition_ctx
        from siddhi_tpu_torch.ops.partition import partition_batch_window_step

        b, ctx = flow.batch, flow.partition
        wts = b.cols[self.time_attr].to(torch.int64) if self.time_attr else b.ts
        out, birth, death, new_state, next_timer, members = partition_batch_window_step(
            state, b, wts.contiguous(), flow.now, ctx.slot, ctx.capacity, self.w, self.n,
            self.t, self.start_time, self.timeout_ms, self.timer_mode, self.emit_expired)
        if self.needs_scheduler:
            aux["next_timer"] = next_timer
        member_env = None
        if self.emit_expired:
            def elems(cur, prev, bat):
                return torch.cat([torch.cat([cur, prev], 1).reshape(-1), bat])

            member_cols = {(self.ref, None, nm): elems(state["cur_cols"][nm],
                                                       state["prev_cols"][nm], b.cols[nm])
                           for nm in b.cols}
            member_cols[(self.ref, None, TS_ATTR)] = elems(state["cur_ts"], state["prev_ts"],
                                                           b.ts)
            member_cols[PARTITION_SLOT_KEY] = members.elem_slot
            member_env = Env(member_cols, now=flow.now)
        return new_state, Flow(
            batch=out, ref=flow.ref, now=flow.now, birth_pos=birth, death_pos=death,
            member_env=member_env, aux=aux,
            partition=partition_ctx(members.slot, members.first, ctx.capacity, ctx.overflow,
                                    members))

    def view(self, state):
        # the open bucket is the probe-able content (reference:
        # LengthBatchWindowProcessor.find over currentEventQueue); inside a
        # partition each slot's bucket, [P, w]
        mask = torch.arange(self.w, dtype=torch.int32,
                            device=state["cur_ts"].device) < state["cur_n"][..., None]
        return state["cur_cols"], state["cur_ts"], mask


def make_window(spec: WindowSpec, schema: StreamSchema, ref: str, scope: Scope,
                time_capacity: int = DEFAULT_TIME_CAPACITY) -> WindowStage:
    """Reference: SingleInputStreamParser.generateProcessor window dispatch."""
    name = spec.name.lower() if spec.namespace is None else f"{spec.namespace}:{spec.name}"
    dev = scope.device
    if name == "length":
        return SlidingWindow(schema, ref, _const_param(spec, 0, "length"), dev)
    if name == "time":
        return SlidingWindow(schema, ref, time_capacity, dev,
                             duration_ms=_const_param(spec, 0, "duration"), use_scheduler=True)
    if name == "timelength":
        t = _const_param(spec, 0, "duration")
        return SlidingWindow(schema, ref, _const_param(spec, 1, "length"), dev,
                             duration_ms=t, use_scheduler=True)
    if name == "externaltime":
        attr = _time_attr(spec, 0, schema)
        scope.record_key((ref, None, attr))
        return SlidingWindow(schema, ref, time_capacity, dev,
                             duration_ms=_const_param(spec, 1, "duration"), time_attr=attr)
    if name == "lengthbatch":
        return BatchWindow(schema, ref, _const_param(spec, 0, "length"), dev)
    if name == "timebatch":
        start = _const_param(spec, 1, "start time") if len(spec.parameters) > 1 else None
        return BatchWindow(schema, ref, None, dev, capacity=time_capacity,
                           duration_ms=_const_param(spec, 0, "duration"), start_time=start)
    if name == "externaltimebatch":
        attr = _time_attr(spec, 0, schema)
        scope.record_key((ref, None, attr))
        n = len(spec.parameters)
        return BatchWindow(schema, ref, None, dev, capacity=time_capacity,
                           duration_ms=_const_param(spec, 1, "duration"), time_attr=attr,
                           start_time=_const_param(spec, 2, "start time") if n > 2 else None,
                           timeout_ms=_const_param(spec, 3, "timeout") if n > 3 else None)
    if name == "sort":
        from siddhi_tpu_torch.core.windows_special import SortWindow

        n = _const_param(spec, 0, "length")
        keys: list[tuple[str, bool]] = []
        i = 1
        params = spec.parameters
        while i < len(params):
            p = params[i]
            if not isinstance(p, Variable):
                raise SiddhiAppCreationError(
                    "sort window parameters after the length must be "
                    "attribute [, 'asc'|'desc'] pairs")
            desc = False
            if i + 1 < len(params) and isinstance(params[i + 1], Constant) and str(
                    params[i + 1].value).lower() in ("asc", "desc"):
                desc = str(params[i + 1].value).lower() == "desc"
                i += 1
            keys.append((p.attribute, desc))
            i += 1
        for a, _d in keys:
            scope.record_key((ref, None, a))
        return SortWindow(schema, ref, n, keys, dev)
    if name in ("frequent", "lossyfrequent"):
        from siddhi_tpu_torch.core.windows_special import FrequentWindow, LossyFrequentWindow

        if name == "frequent":
            n = _const_param(spec, 0, "count")
            rest = spec.parameters[1:]
        else:
            support = _const_raw(spec, 0, "support threshold")
            if len(spec.parameters) > 1 and not isinstance(spec.parameters[1], Variable):
                error = _const_raw(spec, 1, "error bound")
                rest = spec.parameters[2:]
            else:
                error = float(support) / 10.0  # reference default error bound
                rest = spec.parameters[1:]
        attrs = []
        for p in rest:
            if not isinstance(p, Variable):
                raise SiddhiAppCreationError(
                    f"{'frequent' if name == 'frequent' else 'lossyFrequent'} window keys "
                    "must be attributes")
            attrs.append(p.attribute)
        for a in (attrs or schema.attr_names):  # no keys = whole-event key
            scope.record_key((ref, None, a))
        if name == "frequent":
            return FrequentWindow(schema, ref, n, attrs, dev)
        return LossyFrequentWindow(schema, ref, float(support), float(error), attrs, dev)
    if name == "cron":
        from siddhi_tpu_torch.core.windows_special import CronWindow

        expr = _const_raw(spec, 0, "cron expression")
        return CronWindow(schema, ref, str(expr), dev, capacity=time_capacity)
    raise SiddhiAppCreationError(f"window '{spec.name}' is not ported yet")


def _time_attr(spec: WindowSpec, i: int, schema: StreamSchema) -> str:
    p = spec.parameters[i] if i < len(spec.parameters) else None
    if not isinstance(p, Variable):
        raise SiddhiAppCreationError(f"window {spec.name}: parameter {i} must be an attribute")
    if schema.attr_types.get(p.attribute) not in (AttrType.LONG, AttrType.INT):
        raise SiddhiAppCreationError("external time attribute must be long")
    return p.attribute
