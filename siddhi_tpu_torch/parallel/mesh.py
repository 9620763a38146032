"""The device mesh and the sharded steps of a partitioned query.

The port of siddhi_tpu/parallel/mesh.py. The JAX package places a
`PartitionedQueryRuntime`'s [P] state axis on a `jax.sharding.Mesh` and lets
XLA insert the collectives; the port runs the same contract in-process over
an explicit device list (JAX's model is single-controller too): each shard
steps its own slice of the [P] axis, and the flags and the next timer are
reduced across the shards on the delivering device. No `torch.distributed`.

`mesh_devices(device)` is the port's `jax.devices()`:

* `cuda`: every visible GPU; when `XLA_FLAGS` holds
  `--xla_force_host_platform_device_count=N` with N above the GPU count, N
  shards spread round-robin over the GPUs. On one H100 all N sit on
  `cuda:0`. This is the port's only extension of the JAX contract, and the
  only way one card runs the mesh code: every figure taken so is N shards
  sharing one card, not N cards.
* `cpu`: the host device count that flag gives JAX's host platform (1
  without it), so the tests' 8-device flag gives the port the same mesh.

Two sharded steps:

* the replicated step (`replicated_step`, `@app:shard` axis 'part'; JAX
  shard.py:443 `apply_partition_mesh` over `_pstep_outer_impl`): the [P]
  axis in D blocks of P/D slots; every shard sees the whole batch, its
  rows masked to its block, and runs the keyed step over its block. The
  shards' rows are placed in the unsharded step's order: a windowless step's
  rows are positional (row b is input row b), folded by owner (K49's fold);
  after a window or an order-by each slot's rows form a stretch, and the
  stretches of every shard go to (position, slot) order through
  partition.cuh's placement (ops/partition.py `pattern_place`).
* the routed step (`shard_partitioned_query(routed=True)`, JAX mesh.py:159
  `_make_routed_step`): K50 routes each active row to device slot % D
  (slots stripe: state row (s % D) * P/D + s // D, watch point mesh.py:104),
  TIMER rows to every device in row order; each shard steps its P/D local
  slots over its own sub-batch. The rows are set-equal to the unsharded
  step's, not in its order (as in JAX).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
from typing import Optional

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.event import EventBatch, KIND_TIMER

_MAX_ROUTE_LANES = 32  # kMaxLanes of csrc/shard_route.cu
_DEVICE_COUNT_FLAG = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


# ---------------------------------------------------------------------------
# the device list
# ---------------------------------------------------------------------------


def host_device_count() -> int:
    """The device count `XLA_FLAGS`' --xla_force_host_platform_device_count
    asks for (the last one given), 1 without it."""
    found = _DEVICE_COUNT_FLAG.findall(os.environ.get("XLA_FLAGS", ""))
    return max(1, int(found[-1])) if found else 1


def mesh_devices(device) -> list:
    """The mesh devices for an app on `device` (see the module docstring)."""
    dev = torch.device(device)
    n = host_device_count()
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    gpus = torch.cuda.device_count()
    if gpus < 1:
        raise RuntimeError("mesh_devices: no CUDA device is visible")
    return [torch.device("cuda", i % gpus) for i in range(max(gpus, n))]


# ---------------------------------------------------------------------------
# state trees
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure (dicts, lists, tuples)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _block(state, lo: int, hi: int, device):
    return tree_map(lambda x: x[lo:hi].to(device), state)


def _cat_blocks(blocks: list, device):
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]), *blocks)


def _batch_to(batch: EventBatch, device) -> EventBatch:
    return EventBatch(ts=batch.ts.to(device), kind=batch.kind.to(device),
                      valid=batch.valid.to(device),
                      cols={n: c.to(device) for n, c in batch.cols.items()})


def reduce_aux(auxs: list, device) -> dict:
    """The shards' aux flags ORed and their next timers min-reduced on the
    delivering device (JAX mesh.py:244-256: psum > 0 and pmin)."""
    out: dict = {}
    for aux in auxs:
        for k, v in aux.items():
            v = torch.as_tensor(v).to(device)
            if k == "next_timer":
                out[k] = v if k not in out else torch.minimum(out[k], v)
            else:
                v = v.to(torch.bool).any()
                out[k] = v if k not in out else out[k] | v
    return out


# ---------------------------------------------------------------------------
# K50: the routed pre-pass
# ---------------------------------------------------------------------------


def route_rows_ref(slot, active, is_timer, lanes: dict, p: int, d: int):
    """Plain version of `route_rows`, in the JAX package's formulation
    (mesh.py:200-222): a [D, B] take mask, ranks by cumsum, a scatter of the
    row indices with the dropped ones into a dump slot, then each lane
    gathered through them with its fill."""
    b = slot.shape[0]
    dev = slot.device
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    devs = torch.arange(d, dtype=torch.int32, device=dev)
    dev_of = torch.where(active & (slot < p), slot % d, d)
    take = (dev_of[None, :] == devs[:, None]) | is_timer[None, :]
    rank = torch.cumsum(take.to(torch.int32), 1) - 1
    dst = torch.where(take, devs[:, None].long() * b + rank, d * b).reshape(-1)
    routed = torch.full((d * b + 1,), b, dtype=torch.int32, device=dev)
    routed[dst] = idx.expand(d, b).reshape(-1)
    routed = routed[:d * b].reshape(d, b)
    pad = routed >= b
    ri = routed.clamp(0, b - 1).long()

    def lane(x, fill):
        return torch.where(pad, torch.full((), fill, dtype=x.dtype, device=dev), x[ri])

    out = {n: lane(x, 0) for n, x in lanes.items()}
    rslot = lane(torch.where(active, slot, p).to(torch.int32), p)
    return routed, out, rslot, ~pad


def route_rows(slot, active, is_timer, lanes: dict, p: int, d: int):
    """Route a batch's rows to the D devices of a partition mesh.

    slot [B] int32 (P for a row of no partition), active [B] bool,
    is_timer [B] bool, lanes {name: [B]}: each active row with slot < P to
    device slot % D, each TIMER row to every device, in row order. Returns
    (routed [D, B] int32 row indices, B for a pad; {name: [D, B]} lanes with
    0 at the pads; rslot [D, B] int32, the row's slot or P; rvalid [D, B]
    bool, not a pad). K50 on the card, exact."""
    if slot.device.type == "cpu":
        return route_rows_ref(slot, active, is_timer, lanes, p, d)
    names = list(lanes)
    srcs = [lanes[n].contiguous() for n in names]
    kernels.require_cuda("route_rows", slot, active, is_timer, *srcs)
    if len(srcs) > _MAX_ROUTE_LANES or slot.dtype != torch.int32:
        raise ValueError(f"route_rows: int32 slots and at most {_MAX_ROUTE_LANES} lanes")
    b = slot.shape[0]
    dev = slot.device
    routed = torch.empty((d, b), dtype=torch.int32, device=dev)
    rslot = torch.empty((d, b), dtype=torch.int32, device=dev)
    rvalid = torch.empty((d, b), dtype=torch.bool, device=dev)
    outs = [torch.empty((d, b), dtype=x.dtype, device=dev) for x in srcs]
    nl = len(srcs)
    c_ins = (ctypes.c_void_p * max(nl, 1))(*[x.data_ptr() for x in srcs])
    c_outs = (ctypes.c_void_p * max(nl, 1))(*[x.data_ptr() for x in outs])
    c_sizes = (ctypes.c_int * max(nl, 1))(*[x.element_size() for x in srcs])
    kernels.check(kernels.function("sr_route")(
        b, d, p, slot.data_ptr(), active.data_ptr(), is_timer.data_ptr(), nl,
        ctypes.addressof(c_ins), ctypes.addressof(c_outs), ctypes.addressof(c_sizes),
        routed.data_ptr(), rslot.data_ptr(), rvalid.data_ptr(), kernels.stream()), "route_rows")
    kernels.launches["shard_route"] += 1
    return routed, dict(zip(names, outs)), rslot, rvalid


# ---------------------------------------------------------------------------
# the replicated step (axis 'part')
# ---------------------------------------------------------------------------


def positional(qr) -> bool:
    """A windowless step without order-by or limit: its output row b is its
    input row b, so the shards' rows fold by owner."""
    sel = qr.selector
    return (qr.chain.window is None and not sel.order_by and sel.limit is None
            and sel.offset is None)


def _lanes(out: EventBatch) -> dict:
    lanes = {"ts": out.ts, "kind": out.kind, "valid": out.valid}
    lanes.update({"c." + n: c for n, c in out.cols.items()})
    return lanes


def _from_lanes(lanes: dict, cols) -> EventBatch:
    return EventBatch(ts=lanes["ts"], kind=lanes["kind"], valid=lanes["valid"],
                      cols={n: lanes["c." + n] for n in cols})


def _merge_positional(outs: list, owner: torch.Tensor) -> EventBatch:
    """Row b of every shard's positional output from its owner shard (K49's
    fold; `valid` the OR over shards, true only on the owner)."""
    from siddhi_tpu_torch.parallel.keyshard import fold_rows

    shards = [_lanes(o) for o in outs]
    lanes, v = fold_rows({n: [sh[n] for sh in shards] for n in shards[0] if n != "valid"},
                         owner, [o.valid for o in outs])
    lanes["valid"] = v
    return _from_lanes(lanes, outs[0].cols)


def _merge_stretches(outs: list, ctxs: list, pl: int, p: int, device):
    """Each shard's rows of a slot form a stretch in position order; the
    stretches of every shard (blocks in slot order) go to (position, slot)
    order by partition.cuh's placement (`pattern_place`). Rows of no slot
    (a time window's TIMER rows) come first, shard 0's alone. Returns the
    merged batch and its slot and segment-head lanes."""
    from siddhi_tpu_torch.ops.partition import pattern_place

    names = list(_lanes(outs[0]))
    parts = {n: [] for n in names}
    gslots = []
    front = None
    for d, (out, ctx) in enumerate(zip(outs, ctxs)):
        s = ctx.slot.to(device)
        has = s < pl
        lanes = {n: x.to(device) for n, x in _lanes(out).items()}
        if d == 0:
            rows = torch.nonzero(~has).reshape(-1)
            front = {n: x[rows] for n, x in lanes.items()}
        order = torch.sort(torch.where(has, s, pl), stable=True).indices
        order = order[:int(has.sum())]
        for n in names:
            parts[n].append(lanes[n][order])
        gslots.append(s[order].to(torch.int64) + d * pl)
    flat = {n: torch.cat(xs) for n, xs in parts.items()}
    gslot = torch.cat(gslots)
    n = torch.bincount(gslot, minlength=p).to(torch.int32)
    off = (torch.cumsum(n, 0, dtype=torch.int64) - n)
    placed, out_slot, out_first = pattern_place(flat, off, n, n, p)
    rows = int(n.sum())
    nf = front["ts"].shape[0]
    lanes = {k: torch.cat([front[k], placed[k][:rows]]) for k in names}
    slot = torch.cat([torch.full((nf,), p, dtype=torch.int32, device=device),
                      out_slot[:rows]])
    first = torch.cat([torch.arange(nf, dtype=torch.int32, device=device),
                       out_first[:rows] + nf])
    if not (nf + rows):  # one empty row, as the unsharded steps keep
        lanes = {k: x[:1] for k, x in placed.items()}
        slot, first = out_slot[:1], out_first[:1]
    return _from_lanes(lanes, outs[0].cols), slot, first


def replicated_step(qr, devices, ptable: dict, state, batch: EventBatch, now: torch.Tensor):
    """The partition mesh's step of `qr` over `devices` (its `mesh_devices`
    set by `apply_partition_mesh`): the key table and the slots as the unsharded
    `_pstep_outer`, then one keyed step a shard over its block of P/D slots
    with the whole batch, the rows placed in the unsharded order, the flags
    and timers reduced, the table op on the merged rows. Returns (ptable',
    state', out, out_ctx) as `_pstep_outer`."""
    from siddhi_tpu_torch.core.groupby import partition_ctx
    from siddhi_tpu_torch.core.partition import _assign, _reduce_paux

    n_dev, p = len(devices), qr.p
    pl = p // n_dev
    dev = qr.device
    ptable, active, slot, grp, povf = _assign(ptable, qr.key_of, qr.stream_id, batch, now)
    # a key past the table's capacity lands past every lane, padded or not
    slot = torch.where(slot >= qr.p_logical, p, slot).to(torch.int32)
    is_timer = batch.valid & (batch.kind == KIND_TIMER)
    live = active & (slot < p)
    idx = torch.arange(slot.shape[0], dtype=torch.int32, device=dev)
    blocks, outs, ctxs, auxs = [], [], [], []
    for d, ddev in enumerate(devices):
        lo = d * pl
        mine = live & (slot >= lo) & (slot < lo + pl)
        lslot = torch.where(mine, slot - lo, pl).to(torch.int32)
        first = torch.where(mine, grp.first, idx)
        b_d = dataclasses.replace(batch, valid=mine | is_timer)
        ctx = partition_ctx(lslot.to(ddev), first.to(ddev), pl, povf.to(ddev))
        st, out, octx, aux = qr._pstep_rows(_block(state, lo, lo + pl, ddev),
                                            _batch_to(b_d, ddev), now.to(ddev), ctx,
                                            _reduce_paux({}, povf.to(ddev)))
        blocks.append(st)
        outs.append(out)
        ctxs.append(octx)
        auxs.append(aux)
    aux = reduce_aux(auxs, dev)
    if positional(qr):
        out = _merge_positional(outs, torch.where(live, slot // pl, 0).to(torch.int32))
        out_ctx = partition_ctx(slot, grp.first, p, povf)
    else:
        out, oslot, ofirst = _merge_stretches(outs, ctxs, pl, p, dev)
        out_ctx = partition_ctx(oslot, ofirst, p, povf)
    qr._apply_table_op(out, now, aux)
    qr._note_aux(aux)
    return ptable, _cat_blocks(blocks, dev), out, out_ctx


# ---------------------------------------------------------------------------
# the routed step and the standalone sharded query
# ---------------------------------------------------------------------------


def routed_step(qr, devices, ptable: dict, state, batch: EventBatch, now: torch.Tensor):
    """JAX mesh.py:175 `routed_step`: the key table and slots, K50's
    pre-pass, then each shard's keyed step over its P/D local slots (local
    row l of shard d is slot l * D + d) and its own sub-batch. Returns
    (ptable', state', rows of every shard side by side, aux)."""
    from siddhi_tpu_torch.core.groupby import partition_ctx, slot_first
    from siddhi_tpu_torch.core.partition import _assign

    n_dev, p = len(devices), qr.p
    pl = p // n_dev
    dev = qr.device
    ptable, active, slot, _grp, povf = _assign(ptable, qr.key_of, qr.stream_id, batch, now)
    slot = slot.to(torch.int32)
    is_timer = batch.valid & (batch.kind == KIND_TIMER)
    lanes = {"ts": batch.ts, "kind": batch.kind}
    lanes.update({"c." + n: c for n, c in batch.cols.items()})
    _routed, rl, rslot, rvalid = route_rows(slot, active.contiguous(), is_timer.contiguous(),
                                            lanes, p, n_dev)
    blocks, outs, auxs = [], [], []
    for d, ddev in enumerate(devices):
        rs = rslot[d].to(ddev)
        own = rs < p
        lslot = torch.where(own, torch.div(rs, n_dev, rounding_mode="floor"), pl)
        lslot = lslot.to(torch.int32)
        kind = rl["kind"][d].to(ddev)
        rv = rvalid[d].to(ddev)
        b_d = EventBatch(ts=rl["ts"][d].to(ddev), kind=kind,
                         valid=(rv & own) | (rv & (kind == KIND_TIMER)),
                         cols={n: rl["c." + n][d].to(ddev) for n in batch.cols})
        ctx = partition_ctx(lslot, slot_first(lslot, pl), pl, povf.to(ddev))
        st, out, _octx, aux = qr._pstep_rows(_block(state, d * pl, (d + 1) * pl, ddev), b_d,
                                             now.to(ddev), ctx, {})
        blocks.append(st)
        outs.append(_batch_to(out, dev))
        auxs.append(aux)
    aux = reduce_aux(auxs, dev)
    prev = aux.get("partition_overflow")
    aux["partition_overflow"] = povf if prev is None else prev | povf
    rows = EventBatch(ts=torch.cat([o.ts for o in outs]), kind=torch.cat([o.kind for o in outs]),
                      valid=torch.cat([o.valid for o in outs]),
                      cols={n: torch.cat([o.cols[n] for o in outs]) for n in outs[0].cols})
    return ptable, _cat_blocks(blocks, dev), rows, aux


@dataclasses.dataclass
class ShardedPartitionedQuery:
    """A partitioned query whose [P] state axis lives across a device list,
    with its own key table and state (JAX mesh.py:60)."""

    qr: object  # PartitionedQueryRuntime
    devices: list
    routed: bool
    _ptable: dict
    _state: object

    def step(self, batch: EventBatch, now):
        """One sharded step: (rows, aux). Routed: every shard's rows side by
        side, set-equal to the unsharded step's; replicated: the unsharded
        step's rows in its order."""
        qr = self.qr
        now_t = torch.as_tensor(now, dtype=torch.int64).to(qr.device)
        if self.routed:
            self._ptable, self._state, outs, aux = routed_step(
                qr, self.devices, self._ptable, self._state, batch, now_t)
            return outs, aux
        self._ptable, self._state, out, _ctx = replicated_step(
            qr, self.devices, self._ptable, self._state, batch, now_t)
        aux = {"next_timer": qr.next_timer} if qr.next_timer is not None else {}
        return out, aux

    @property
    def state(self):
        return self._state

    def total_emitted(self, outs: EventBatch) -> int:
        """The rows the step emitted, summed over the shards."""
        return int(outs.valid.sum())


def shard_partitioned_query(qr, devices, routed: bool = True,
                            ptable: Optional[dict] = None, state=None) -> ShardedPartitionedQuery:
    """A `PartitionedQueryRuntime`'s step with its [P] axis over `devices`
    (JAX mesh.py:96). The partition capacity must divide by the device
    count. `ptable`/`state` carry a key table and a [P] state in (the
    routed state in its striped layout); by default both start empty."""
    n_dev = len(devices)
    if qr.p % n_dev != 0:
        raise ValueError(
            f"partition capacity {qr.p} is not divisible by the mesh size "
            f"{n_dev}; set @app:partitionCapacity(size='<multiple of {n_dev}>')"
        )
    dev = qr.device
    if ptable is None:
        ptable = {"keys": torch.zeros(qr.p, dtype=torch.int64, device=dev),
                  "used": torch.zeros(qr.p, dtype=torch.bool, device=dev),
                  "n": torch.zeros((), dtype=torch.int32, device=dev)}
    return ShardedPartitionedQuery(qr, list(devices), routed, ptable,
                                   qr.init_state() if state is None else state)
