"""Key-sharded group-by state and join placement (`@app:shard(axis='keys')`).

The port of siddhi_tpu/parallel/keyshard.py:

- `KeyShardedGroupExec` (JAX :134): an eligible windowless grouped query's
  state gains a leading [D] device axis; every shard sees the whole batch,
  runs the (stateless) chain, masks away the CURRENT/EXPIRED rows whose
  group key it does not own (the key-routed pre-pass), and advances only
  its own groups. Emissions are positional (row b of the output is input
  row b), so K49's fold rebuilds the unsharded output exactly: each lane
  takes its owner shard's bits (JAX: a psum of owner-masked lanes, floats
  bitcast to integers first so -0.0 and NaN payloads survive), `valid` is
  the OR over shards.
- `apply_join_mesh` (JAX :523): join-side state leaves whose leading axis
  divides by D are placed across the mesh devices; the step itself is
  unchanged. On one card that changes no row: each placed leaf is gathered
  to the step's device, stepped, and split back.

K49 (csrc/keyshard.cu): `owner_of` (JAX :62 `mix64` and :74 `owner_of`, the
splitmix64 finalizer then % D, bit-identical to the numpy form) and
`fold_rows` (the owner-masked fold of `_step_impl`, :227-251). Each `*_ref`
beside them is its plain version, which a wrapper takes only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.

`export_state` canonicalizes the [D, G] group tables into the single-device
layout (device-major slot order) and `import_state` re-hashes every key onto
another mesh size, both pure host numpy (JAX :339, :400); their wiring into
persistence waits for the port's persistence module.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.parallel.mesh import tree_map

log = logging.getLogger(__name__)

KEY_AXIS = "keys"
_MAX_FOLD_LANES = 32  # kMaxLanes of csrc/keyshard.cu
_FOLD_TABLE_BY_VALUE = 384  # kTableByValue of csrc/keyshard.cu

# splitmix64 finalizer constants: single-column group keys pass through
# `mix_keys` un-mixed, so the owner hash scrambles low bits itself
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_M1_I64 = int(_M1) - (1 << 64)  # the same bits as int64
_M2_I64 = int(_M2) - (1 << 64)


def mix64(k):
    """splitmix64 finalizer over numpy uint64 lanes (JAX keyshard.py:62);
    the host-side re-hash of `import_state`."""
    k = k ^ (k >> np.uint64(30))
    k = k * _M1
    k = k ^ (k >> np.uint64(27))
    k = k * _M2
    k = k ^ (k >> np.uint64(31))
    return k


def owner_of_np(keys, n_devices: int) -> np.ndarray:
    """Owning device index in [0, n_devices) of each int64 group key, numpy
    (JAX keyshard.py:74)."""
    with np.errstate(over="ignore"):
        return (mix64(np.asarray(keys).astype("uint64")) % np.uint64(n_devices)).astype("int32")


# ---------------------------------------------------------------------------
# K49: the owner hash and the owner-masked fold
# ---------------------------------------------------------------------------


def _lsr(k: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (their uint64 bits)."""
    return (k >> n) & ((1 << (64 - n)) - 1)


def owner_of_ref(keys: torch.Tensor, n_devices: int) -> torch.Tensor:
    """Plain version of `owner_of`: splitmix64 on the int64 bits with
    wrapping multiplies and logical shifts, then an unsigned % D (from the
    two 32-bit halves)."""
    k = keys.to(torch.int64)
    k = k ^ _lsr(k, 30)
    k = k * _M1_I64
    k = k ^ _lsr(k, 27)
    k = k * _M2_I64
    k = k ^ _lsr(k, 31)
    d = int(n_devices)
    hi, lo = _lsr(k, 32), k & 0xFFFFFFFF
    return (((hi % d) * ((1 << 32) % d) + lo % d) % d).to(torch.int32)


def owner_of(keys: torch.Tensor, n_devices: int) -> torch.Tensor:
    """[B] int32 owning mesh device of each int64 group key, bit-identical to
    `owner_of_np` (K49's owner entry on the card)."""
    if keys.device.type == "cpu":
        return owner_of_ref(keys, n_devices)
    keys = keys.to(torch.int64).contiguous()
    kernels.require_cuda("owner_of", keys)
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    kernels.check(kernels.function("ks_owner")(
        keys.data_ptr(), keys.numel(), int(n_devices), out.data_ptr(), kernels.stream()),
        "owner_of")
    kernels.launches["shard_owner"] += 1
    return out


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def fold_rows_ref(lanes: dict, owner: torch.Tensor, valid):
    """Plain version of `fold_rows`, in the JAX package's formulation: per
    shard the lanes masked to the rows it owns (floats as their integer
    bits, bools as int32), summed over the shards; `valid` ORed. Takes the
    shards' lanes as `fold_rows` does (or stacked [D, B]) and stacks them."""
    valid = torch.stack([v.to(owner.device) for v in valid])
    n_dev = valid.shape[0]
    devs = torch.arange(n_dev, dtype=owner.dtype, device=owner.device)
    mine = owner[None, :] == devs[:, None]
    out = {}
    for name, shards in lanes.items():
        x = torch.stack([v.to(owner.device) for v in shards])
        if x.dtype == torch.bool:
            out[name] = torch.where(mine, x, False).to(torch.int32).sum(0) > 0
            continue
        bits = x.view(_BITS[x.element_size()]) if x.dtype.is_floating_point else x
        summed = torch.where(mine, bits, torch.zeros((), dtype=bits.dtype, device=bits.device))
        summed = summed.sum(0, dtype=torch.int64).to(bits.dtype)
        out[name] = summed.view(x.dtype) if x.dtype.is_floating_point else summed
    return out, valid.any(0)


def fold_rows(lanes: dict, owner: torch.Tensor, valid):
    """Fold D shards' positional outputs into one: lanes {name: D [B]
    tensors, shard by shard}, owner [B] int32 (each row's owner shard),
    valid D [B] bool tensors. Returns ({name: [B]}, valid [B]): each lane's
    element from the owner's row, bit for bit; valid the OR over shards
    (K49's fold on the card: one launch reading the shards in place; a
    shard on another device is moved to the owner's first)."""
    if owner.device.type == "cpu":
        return fold_rows_ref(lanes, owner, valid)
    names = list(lanes)
    if len(names) > _MAX_FOLD_LANES:
        raise ValueError(f"fold_rows: at most {_MAX_FOLD_LANES} lanes, got {len(names)}")
    kernels.require_cuda("fold_rows", owner)
    dev, di, b, n_dev = owner.device, owner.get_device(), owner.shape[0], len(valid)
    if owner.dtype != torch.int32 or owner.dim() != 1:
        raise ValueError("fold_rows: an int32 [B] owner lane")
    # one pass a tensor, the host work of a call: a shard on another card
    # is moved to the owner's (kept alive until the launch is queued)
    table, moved, shp = [], [], owner.shape
    for shards in [lanes[n] for n in names] + [valid]:
        dt = shards[0].dtype
        if len(shards) != n_dev:
            raise ValueError(f"fold_rows: {n_dev} shards a lane, got {len(shards)}")
        for x in shards:
            if x.get_device() != di:
                x = x.to(dev)
                moved.append(x)
            if x.dtype != dt or x.shape != shp or not x.is_contiguous():
                raise ValueError(f"fold_rows: contiguous [{b}] lanes of one dtype a lane")
            table.append(x.data_ptr())
    if valid[0].dtype != torch.bool:
        raise ValueError("fold_rows: bool valid lanes")
    outs = [torch.empty((b,), dtype=lanes[n][0].dtype, device=dev) for n in names]
    v_out = torch.empty((b,), dtype=torch.bool, device=dev)
    args = [x.data_ptr() for x in outs] + [x.element_size() for x in outs] + table
    c_args = (ctypes.c_longlong * len(args))(*args)
    table_g = None
    if len(table) > _FOLD_TABLE_BY_VALUE:
        table_g = torch.tensor(table, dtype=torch.int64).to(dev)
    kernels.check(kernels.function("ks_fold")(
        len(names), n_dev, b, ctypes.addressof(c_args), owner.data_ptr(), v_out.data_ptr(),
        None if table_g is None else table_g.data_ptr(), kernels.stream()), "fold_rows")
    kernels.launches["shard_fold"] += 1
    return dict(zip(names, outs)), v_out


# ---------------------------------------------------------------------------
# eligibility (JAX keyshard.py:83)
# ---------------------------------------------------------------------------


def keyed_shardable(qr) -> tuple[bool, Optional[str]]:
    """(eligible, reason-when-not) for key-sharding one query runtime: a
    plain windowless grouped query with no host-side ordering state, whose
    aggregators are exact under the owner mask (count, min/max, integer
    sum)."""
    from siddhi_tpu_torch.core.aggregators import (
        CountAggregator,
        ExtremeAggregator,
        SumAggregator,
    )
    from siddhi_tpu_torch.core.query_runtime import QueryRuntime
    from siddhi_tpu_torch.core.types import AttrType

    if type(qr) is not QueryRuntime:
        return False, "not a plain single-stream query runtime"
    sel = qr.selector
    if sel.group is None:
        return False, "no group-by key to shard on"
    if qr.chain.window is not None:
        return False, "windowed chain state is not key-shardable yet"
    if sel.order_by or sel.limit is not None or sel.offset is not None:
        return False, "order by / limit reorders rows across groups"
    if qr.rate_limiter is not None:
        return False, "output rate limiter holds host-side state"
    if qr.table_op is not None or qr.tables:
        return False, "table reads/writes stay single-device"
    if getattr(qr, "join_findables", None):
        return False, "in-condition table probes stay single-device"
    for agg in sel.aggregators:
        if isinstance(agg, (CountAggregator, ExtremeAggregator)):
            continue
        if isinstance(agg, SumAggregator) and agg.type is AttrType.LONG:
            continue
        return False, (
            f"{type(agg).__name__} float arithmetic is "
            "reassociation-sensitive under the key-routed mask"
        )
    return True, None


# ---------------------------------------------------------------------------
# the key-sharded group-by (JAX keyshard.py:134)
# ---------------------------------------------------------------------------


class KeyShardedGroupExec:
    """Key-sharded execution of one eligible grouped query: the [D]-stacked
    state, the step (`_step_impl`, the query's signature, which the query's
    `receive` takes once armed), the occupancy gauges and the snapshot
    canonicalize / re-hash pair."""

    def __init__(self, qr, devices):
        self.qr = qr
        self.devices = list(devices)
        self.n = len(self.devices)

    def arm(self) -> None:
        """Swap in the sharded step; before the first event only (the state
        layout changes)."""
        qr = self.qr
        if qr.state is not None:
            raise RuntimeError(
                f"query '{qr.query_id}': cannot key-shard after state materialized")
        qr._keyshard = self

    def init_state(self):
        """The unsharded init state with a leading [D] device axis: every
        shard starts with an empty group table."""
        return tree_map(lambda x: torch.stack([x] * self.n), self.qr.init_state())

    def _step_impl(self, state, batch, now: torch.Tensor):
        from siddhi_tpu_torch.core.event import EventBatch, KIND_CURRENT
        from siddhi_tpu_torch.core.flow import Flow
        from siddhi_tpu_torch.observability.lineage import LIN
        from siddhi_tpu_torch.parallel.mesh import _batch_to, reduce_aux

        qr = self.qr
        n_dev = self.n
        dev = qr.device
        owner = None
        outs, blocks, auxs = [], [], []
        pre = None
        for d, ddev in enumerate(self.devices):
            st = tree_map(lambda x: x[d].to(ddev), state)
            b = _batch_to(batch, ddev)
            flow = Flow(batch=b, ref=qr.ref, now=now.to(ddev))
            chain_state, flow = qr.chain.apply(st["chain"], flow)
            if pre is None:
                # the pre-mask chain output: what the unsharded selector sees
                pre = _batch_to(flow.batch, dev)
                key = qr.selector.group.key_of(flow.env()).expand(flow.batch.valid.shape)
                owner = owner_of(key.contiguous().to(dev), n_dev)
            mine = owner.to(ddev) == d
            # CURRENT/EXPIRED rows advance state on their owner only;
            # TIMER/RESET (and invalid) rows go to every shard
            keep = torch.where(flow.sign != 0, mine, True)
            masked = EventBatch(flow.batch.ts, flow.batch.kind, flow.batch.valid & keep,
                                flow.batch.cols)
            flow = dataclasses.replace(flow, batch=masked)
            sel_state, out = qr.selector.apply(st["sel"], flow)
            blocks.append({"chain": chain_state, "sel": sel_state})
            outs.append(out)
            auxs.append(flow.aux)
        lanes = {"c." + n: [o.cols[n] for o in outs] for n in outs[0].cols}
        folded, valid = fold_rows(lanes, owner, [o.valid for o in outs])
        # ts and kind: JAX's replicated out_specs=P() hands on shard 0's copy
        out = EventBatch(outs[0].ts.to(dev), outs[0].kind.to(dev), valid,
                         {n: folded["c." + n] for n in outs[0].cols})
        aux = reduce_aux(auxs, dev)
        qr._note_aux(aux)
        if qr.lineage is not None:
            lin = {k: v.to(dev) for k, v in qr.chain.probe_lanes.items()}
            lin[LIN + "in"] = batch.valid & (batch.kind == KIND_CURRENT)
            lin[LIN + "in_ts"] = batch.ts
            lin[LIN + "w_valid"] = pre.valid
            lin[LIN + "w_kind"] = pre.kind
            lin[LIN + "w_ts"] = pre.ts
            lin[LIN + "out_valid"] = out.valid
            lin[LIN + "out_kind"] = out.kind
            if "__group_key__" in out.cols:
                lin[LIN + "gkey"] = out.cols["__group_key__"]
            qr._lin_sink.append((None, lin))
        new_state = tree_map(lambda *xs: torch.stack([x.to(dev) for x in xs]), *blocks)
        return new_state, out

    # ---- observability ---------------------------------------------------

    def describe_state(self) -> dict:
        """Per-device key occupancy and skew (JAX keyshard.py:308)."""
        qr = self.qr
        g = qr.selector.group.capacity
        d: dict = {"query": qr.query_id, "devices": self.n, "axis": KEY_AXIS,
                   "group_capacity": g}
        if qr.state is None:
            return d
        with qr._receive_lock:
            n_dev = qr.state["sel"]["group"]["n"].cpu().numpy()
        keys = [int(x) for x in n_dev.reshape(-1)]
        total = sum(keys)
        d["per_device_keys"] = keys
        d["total_keys"] = total
        d["occupancy"] = [round(k / g, 4) for k in keys] if g else []
        mean = total / self.n if self.n else 0.0
        d["skew"] = round(max(keys) / mean, 3) if mean else 0.0
        return d

    # ---- snapshot canonical form (JAX keyshard.py:339-447) ---------------

    def export_state(self, state):
        """Canonical single-device numpy state: the [D, G] group tables
        collapse into one G-table (device-major slot order), the [D, G]
        aggregator lanes gathered alongside; the raw sharded tree when the
        layout is not the canonical grouped one."""
        from siddhi_tpu_torch.interop import state_to_numpy

        host = state_to_numpy(state)
        g = self.qr.selector.group.capacity
        sel = host.get("sel") if isinstance(host, dict) else None
        grp = sel.get("group") if isinstance(sel, dict) else None
        agg_leaves = _leaves(sel.get("aggs")) if isinstance(sel, dict) else []
        canonical = (
            grp is not None
            and isinstance(host, dict)
            and set(host) == {"chain", "sel"}
            and set(sel) <= {"aggs", "group"}
            and all(l.ndim >= 2 and l.shape[0] == self.n and l.shape[1] == g
                    for l in agg_leaves)
        )
        if canonical:
            order = [(dd, s) for dd in range(self.n) for s in range(g) if grp["used"][dd, s]]
            canonical = len(order) <= g
        if not canonical:
            return {"__keyshard_raw__": self.n, "state": host}
        one = state_to_numpy(self.qr.init_state())
        pg = one["sel"]["group"]
        for i, (dd, s) in enumerate(order):
            pg["keys"][i] = grp["keys"][dd, s]
            pg["used"][i] = True
        pg["n"] = np.int32(len(order)).reshape(())

        def gather(dst, src):
            dst = np.array(dst)
            for i, (dd, s) in enumerate(order):
                dst[i] = src[dd, s]
            return dst

        one["sel"]["aggs"] = _np_map(gather, one["sel"]["aggs"], sel["aggs"])
        return one

    def import_state(self, value):
        """The [D]-sharded state (torch, on the query's device) from a
        canonical or raw snapshot tree, every group key re-hashed to its
        owner on this mesh."""
        from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy

        dev = self.qr.device
        if isinstance(value, dict) and "__keyshard_raw__" in value:
            snap_d = int(value["__keyshard_raw__"])
            if snap_d != self.n:
                raise ValueError(
                    f"query '{self.qr.query_id}': raw key-sharded snapshot "
                    f"taken on {snap_d} devices cannot restore onto "
                    f"{self.n} (canonical export required for rebalance)")
            return state_from_numpy(value["state"], dev)
        host = _np_map(np.array, value)
        g = self.qr.selector.group.capacity
        grp = host["sel"]["group"]
        ns = state_to_numpy(self.init_state())
        ng = ns["sel"]["group"]
        owners = owner_of_np(np.asarray(grp["keys"], np.int64), self.n)
        counts = [0] * self.n
        place: dict = {}  # canonical slot -> (device, local slot)
        for s in range(g):
            if not grp["used"][s]:
                continue
            dd = int(owners[s])
            i = counts[dd]
            counts[dd] += 1
            ng["keys"][dd, i] = grp["keys"][s]
            ng["used"][dd, i] = True
            place[s] = (dd, i)
        ng["n"] = np.asarray(counts, np.int32)

        def scatter(dst, src):
            for s, (dd, i) in place.items():
                dst[dd, i] = src[s]
            return dst

        ns["sel"]["aggs"] = _np_map(scatter, ns["sel"]["aggs"], host["sel"]["aggs"])
        return state_from_numpy(ns, dev)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _np_map(fn, *trees):
    return tree_map(lambda *xs: fn(*(np.asarray(x) for x in xs)), *trees)


# ---------------------------------------------------------------------------
# placement (ShardRuntime, axis 'keys'; JAX keyshard.py:455, :523)
# ---------------------------------------------------------------------------


def apply_keyshard(app_runtime, devices) -> dict:
    """Arm key-sharded execution on every eligible grouped query. Returns
    qid -> placement info; an ineligible grouped query gets {"sharded":
    False, "reason"}. Already-armed queries keep their live [D] state."""
    from siddhi_tpu_torch.core.query_runtime import QueryRuntime

    fused_members = set()
    for j in app_runtime.junctions.values():
        fi = getattr(j, "fused_ingest", None)
        if fi is not None:
            for ep in getattr(fi, "endpoints", ()):
                fused_members.add(id(ep.qr))
    placed: dict = {}
    for qid, qr in list(app_runtime.queries.items()):
        if getattr(qr, "_keyshard", None) is not None:
            placed[qid] = {"sharded": True, "devices": qr._keyshard.n, "axis": KEY_AXIS,
                           "group_capacity": qr.selector.group.capacity}
            continue
        ok, why = keyed_shardable(qr)
        grouped = type(qr) is QueryRuntime and getattr(qr.selector, "group", None) is not None
        if ok and id(qr) in fused_members:
            # the app's fusion veto keeps eligible queries out of fused
            # engines; a fused dispatch would bypass the sharded step
            ok, why = False, "member of a fused ingest group"
            log.warning("query '%s': keyed sharding skipped — %s (fusion veto "
                        "missed; report this)", qid, why)
        if not ok:
            if grouped:
                placed[qid] = {"sharded": False, "reason": why}
            continue
        if qr.state is not None:
            placed[qid] = {"sharded": False, "reason": "state already materialized"}
            continue
        ex = KeyShardedGroupExec(qr, devices)
        ex.arm()
        placed[qid] = {"sharded": True, "devices": ex.n, "axis": KEY_AXIS,
                       "group_capacity": qr.selector.group.capacity}
        log.info("query '%s': group-by state key-sharded across %d devices", qid, ex.n)
    return placed


def apply_join_mesh(app_runtime, devices) -> dict:
    """Place join-side state across the mesh: every leaf of a join query's
    "join" state whose leading axis divides by the device count is held as
    D row blocks, one a mesh device; the step is unchanged (gathered to the
    step's device, stepped, split back), so rows and lineage lanes are
    byte-identical. Returns qid -> placement info."""
    from siddhi_tpu_torch.core.join import JoinQueryRuntime

    n_dev = len(devices)
    placed: dict = {}
    for qid, qr in list(app_runtime.queries.items()):
        if type(qr) is not JoinQueryRuntime:
            continue
        if getattr(qr, "_joinshard", False):
            placed[qid] = {"sharded": True, "devices": n_dev, "axis": KEY_AXIS}
            continue
        spec = qr.init_state()

        def eligible(x):
            return x.dim() >= 1 and x.shape[0] >= n_dev and x.shape[0] % n_dev == 0

        n_sharded = sum(1 for x in _torch_leaves(spec["join"]) if eligible(x))
        if n_sharded == 0:
            placed[qid] = {"sharded": False,
                           "reason": f"no join-state axis divisible by {n_dev} devices"}
            continue
        if qr.state is not None:
            placed[qid] = {"sharded": False, "reason": "state already materialized"}
            continue
        _place_join(qr, devices, eligible)
        placed[qid] = {"sharded": True, "devices": n_dev, "axis": KEY_AXIS,
                       "sharded_leaves": n_sharded}
        log.info("query '%s': join window state sharded across %d devices (%d leaves)",
                 qid, n_dev, n_sharded)
    return placed


def _torch_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _torch_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _torch_leaves(v)]
    return [tree]


def _place_join(qr, devices, eligible) -> None:
    """Wrap the join's step: the placed leaves' D blocks gathered to the
    step's device before it and split back onto the mesh devices after it
    (`qr.join_blocks`, leaf path -> blocks). On one card every block is a
    view of its leaf: nothing moves."""
    step = qr._step_impl
    dev = qr.device
    n_dev = len(devices)

    def split(tree, path=()):
        if isinstance(tree, dict):
            return {k: split(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(split(v, path + (i,)) for i, v in enumerate(tree))
        if eligible(tree):
            qr.join_blocks[path] = [b.to(d) for b, d in zip(tree.chunk(n_dev), devices)]
        return tree

    def gather(tree, path=()):
        if isinstance(tree, dict):
            return {k: gather(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(gather(v, path + (i,)) for i, v in enumerate(tree))
        blocks = qr.join_blocks.get(path)
        if blocks is None or all(b.device == tree.device for b in blocks):
            return tree
        return torch.cat([b.to(dev) for b in blocks])

    def placed_step(state, batch, now, side):
        state = dict(state, join=gather(state["join"]))
        state, out = step(state, batch, now, side)
        split(state["join"])
        return state, out

    qr.join_blocks = {}
    qr._step_impl = placed_step
    qr._joinshard = True
