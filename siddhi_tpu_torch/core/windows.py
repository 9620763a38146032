"""Window processors — device-resident ring buffers with batched emission.

Reference: query/processor/stream/window/*.java. The reference mutates per-event
queues inside synchronized blocks; here each window is a stage over the Flow
with a fixed-capacity slot-indexed ring as carried state.

Only the length window is ported so far. Its emission order follows the
reference: per arrival when full, the evictee's EXPIRED is emitted before the
arrival's CURRENT (LengthWindowProcessor.java:102-138 insertBeforeCurrent).
The step is a hand-written CUDA kernel on the card (csrc/length_window.cu);
`length_window_step_ref` is its plain PyTorch version, which the wrapper takes
only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import (
    EventBatch,
    KIND_CURRENT,
    KIND_EXPIRED,
    StreamSchema,
)
from siddhi_tpu_torch.core.executor import Env, TS_ATTR
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE
from siddhi_tpu_torch.query_api.definition import WindowSpec
from siddhi_tpu_torch.query_api.expression import Constant

BIG = torch.iinfo(torch.int32).max


def _const_param(spec: WindowSpec, i: int, what: str) -> int:
    if i >= len(spec.parameters) or not isinstance(spec.parameters[i], Constant):
        raise SiddhiAppCreationError(f"window {spec.name}: parameter {i} must be a constant {what}")
    return int(spec.parameters[i].value)


class WindowStage:
    """Base: (state, Flow) -> (state', Flow')."""

    def init_state(self):
        raise NotImplementedError

    def apply(self, state, flow: Flow):
        raise NotImplementedError


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


class SlidingWindow(WindowStage):
    """length(N): a ring of capacity W = N; each arrival beyond the N-th
    evicts the oldest element, emitted as EXPIRED just before the arrival's
    CURRENT."""

    def __init__(self, schema: StreamSchema, ref: str, capacity: int, device):
        if capacity < 1:
            raise SiddhiAppCreationError(f"length window needs a length >= 1, got {capacity}")
        self.schema = schema
        self.ref = ref
        self.w = int(capacity)
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
        out, birth, death, new_state = length_window_step(state, b, self.w)
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
        )


def make_window(spec: WindowSpec, schema: StreamSchema, ref: str, device) -> WindowStage:
    """Reference: SingleInputStreamParser.generateProcessor window dispatch."""
    name = spec.name.lower() if spec.namespace is None else f"{spec.namespace}:{spec.name}"
    if name == "length":
        return SlidingWindow(schema, ref, _const_param(spec, 0, "length"), device)
    raise SiddhiAppCreationError(f"window '{spec.name}' is not ported yet")
