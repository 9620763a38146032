"""First-class sharded execution: `@app:shard(devices='N', axis=...)`.

The port of siddhi_tpu/parallel/shard.py. `@app:shard` / SIDDHI_TPU_SHARD
resolve at app creation (`resolve_shard_annotation`, malformed options raise
there with JAX's class and message) and apply at `start()` (`ShardRuntime`):

* **axis='part'**: every plain `PartitionedQueryRuntime` fed by an outer
  stream gets the partition mesh (`apply_partition_mesh`): its [P] state
  axis is split into D blocks of P/D slots, one a mesh device, and each
  shard runs the keyed step over its block with the whole batch; the
  shards' rows are placed in the unsharded step's (position, slot) order
  (parallel/mesh.py `replicated_step`). An indivisible
  `@app:partitionCapacity` is padded with dead slots, the key table keeping
  its capacity.
* **axis='batch'**: a junction whose fused endpoints are all stateless gets
  a `BatchShardRouter`: a `send_columns` call's micro-batch k goes to mesh
  device k % D, one `_dispatch_chunk` a chunk of each device's batches, and
  the packed outputs are delivered in the original batch order.
* **axis='keys'**: the partition mesh, plus key-sharded group-by state and
  join placement (parallel/keyshard.py).
* **axis='auto'** (default): the partition mesh and the batch router.

The mesh is `mesh_devices(app device)` (parallel/mesh.py), the port's
`jax.devices()`: every visible GPU, or on one card as many virtual shards as
`XLA_FLAGS=--xla_force_host_platform_device_count=N` asks for, all on that
card. A mesh of fewer than two devices turns sharding off with JAX's
warning.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

SHARD_ENV = "SIDDHI_TPU_SHARD"
SHARD_AXIS_ENV = "SIDDHI_TPU_SHARD_AXIS"
MAX_DEVICES = 64
_AXES = ("auto", "part", "batch", "keys")


# ---------------------------------------------------------------------------
# annotation / env resolution (JAX shard.py:71-160)
# ---------------------------------------------------------------------------


def shard_env_override() -> Optional[int]:
    """Process-wide device-count override: N (force N-device sharding),
    0 (force off), or None (defer to the app's @app:shard annotation)."""
    v = os.environ.get(SHARD_ENV, "").strip().lower()
    if not v:
        return None
    if v in ("off", "false", "no"):
        return 0
    try:
        return max(0, int(v))
    except ValueError:
        log.warning("ignoring malformed %s=%r", SHARD_ENV, v)
        return None


def shard_axis_override() -> Optional[str]:
    """Process-wide axis override (SIDDHI_TPU_SHARD_AXIS): one of the axis
    names, or None to defer to the app's @app:shard annotation."""
    v = os.environ.get(SHARD_AXIS_ENV, "").strip().lower()
    if not v:
        return None
    if v not in _AXES:
        log.warning(
            "ignoring malformed %s=%r (expected one of %s)",
            SHARD_AXIS_ENV, v, ", ".join(_AXES),
        )
        return None
    return v


def iter_shard_annotation_problems(ann):
    """Yield one message per malformed `@app:shard` element (JAX shard.py
    :102). Accepted shapes: @app:shard(devices='N'[, axis='part|batch|keys|
    auto']) or the sole-positional @app:shard('N')."""
    sole_positional = len(ann.elements) == 1 and ann.elements[0][0] is None
    for k, v in ann.elements:
        if k == "devices" or (k is None and sole_positional):
            try:
                ok = 1 <= int(v) <= MAX_DEVICES
            except (TypeError, ValueError):
                ok = False
            if not ok:
                yield (
                    f"@app:shard devices '{v}' must be an integer in "
                    f"1..{MAX_DEVICES}"
                )
        elif k == "axis":
            if str(v).strip().lower() not in _AXES:
                yield (
                    f"@app:shard axis '{v}' must be one of "
                    f"{', '.join(_AXES)}"
                )
        else:
            yield (
                f"unknown @app:shard option '{k if k is not None else v}' "
                "(expected devices, axis)"
            )


def resolve_shard_annotation(ann) -> tuple[int, str]:
    """(requested_devices, axis) from an `@app:shard` annotation (or None)
    and the SIDDHI_TPU_SHARD / SIDDHI_TPU_SHARD_AXIS overrides, which win;
    0 devices = off. Raises SiddhiAppCreationError on malformed options
    (JAX shard.py:134)."""
    from siddhi_tpu_torch.core.errors import SiddhiAppCreationError

    devices = 0
    axis = "auto"
    if ann is not None:
        for problem in iter_shard_annotation_problems(ann):
            raise SiddhiAppCreationError(problem)
        v = ann.element("devices")
        if v is None and len(ann.elements) == 1 and ann.elements[0][0] is None:
            v = ann.elements[0][1]  # strict sole-positional fallback
        devices = int(v) if v is not None else 0
        ax = ann.element("axis")
        if ax is not None:
            axis = str(ax).strip().lower()
    env = shard_env_override()
    if env is not None:
        devices = env
    env_axis = shard_axis_override()
    if env_axis is not None:
        axis = env_axis
    return devices, axis


# ---------------------------------------------------------------------------
# batch-axis router eligibility (JAX shard.py:168-189)
# ---------------------------------------------------------------------------


def shardable_stateless(qr) -> bool:
    """True when a fused endpoint's query carries no cross-batch state, so
    its rows for a micro-batch depend only on that micro-batch
    (`QueryRuntime.stateless_chain`); joins, patterns and partitioned
    runtimes never are."""
    from siddhi_tpu_torch.core.query_runtime import QueryRuntime

    return type(qr) is QueryRuntime and qr.stateless_chain


def router_eligible(fi) -> bool:
    """May a junction's fused ingest engine be batch-axis sharded? Every
    endpoint must be stateless (the port's engine has no residual consumers
    or shared rings, which exist only for stateful chains in JAX)."""
    if not fi.endpoints:
        return False
    return all(shardable_stateless(ep.qr) for ep in fi.endpoints)


# ---------------------------------------------------------------------------
# batch-axis round-robin router (JAX shard.py:197-435)
# ---------------------------------------------------------------------------


class BatchShardRouter:
    """Round-robin batch-axis data parallelism for one junction's fused
    ingest: micro-batch k of a columnar send goes to mesh device k % D, each
    device's batches are encoded into fresh wire chunks, each chunk runs
    through the engine's `_dispatch_chunk` on its device, and the packed
    outputs are delivered in the original batch order. Armed only where
    every endpoint is stateless (`router_eligible`)."""

    def __init__(self, junction, devices):
        self.junction = junction
        self.devices = list(devices)
        self.dispatches = [0] * len(self.devices)
        self.events = [0] * len(self.devices)
        self.sends = 0
        self._lock = threading.Lock()
        # senders serialize on _send_gate; a callback re-entering
        # send_columns from the merged drain takes the single-device path
        self._send_gate = threading.Lock()
        self._sender = None

    def describe_state(self) -> dict:
        total = max(1, sum(self.events))
        d = len(self.devices)
        return {
            "devices": d,
            "sends": self.sends,
            "per_device_dispatches": list(self.dispatches),
            "per_device_events": list(self.events),
            # 1.0 = a perfectly even share of the events
            "occupancy": [round(e * d / total, 3) for e in self.events],
        }

    def try_send(self, fi, prog, ts_arr, cols, n: int, B: int, now: int) -> Optional[bool]:
        """Sharded fused send of one columnar call. None: the single-device
        fused path owns the call (fewer than two micro-batches for two
        devices, a re-entrant send, or a narrow-wire misfit before anything
        was dispatched); True once the sharded send committed."""
        M = -(-n // B)
        D = min(len(self.devices), M)
        if D < 2:
            return None
        if self._sender is threading.current_thread():
            return None
        with self._send_gate:
            self._sender = threading.current_thread()
            try:
                return self._send(fi, prog, ts_arr, cols, n, B, now, M, D)
            finally:
                self._sender = None

    def _send(self, fi, prog, ts_arr, cols, n, B, now, M: int, D: int) -> Optional[bool]:
        from siddhi_tpu_torch.core.event import WireNarrowMisfit
        from siddhi_tpu_torch.core.pipeline import device_views

        assigned = [list(range(d, M, D)) for d in range(D)]
        # encode every device's chunks first (host work), each into a fresh
        # buffer: a misfit falls back with nothing dispatched
        staged: list[list] = []
        try:
            for d in range(D):
                chunks = []
                for ofs in range(0, len(assigned[d]), fi.K):
                    part = assigned[d][ofs:ofs + fi.K]
                    K = fi._chunk_K(len(part))
                    host = np.zeros(12 * K + K * prog.wire_bytes, dtype=np.uint8)
                    bases = host[:8 * K].view(np.int64)
                    counts = host[8 * K:12 * K].view(np.int32)
                    wire = host[12 * K:].reshape(K, prog.wire_bytes)
                    for j, k in enumerate(part):
                        lo, hi = k * B, min(k * B + B, n)
                        counts[j] = hi - lo
                        _buf, bases[j] = prog.encode(
                            ts_arr[lo:hi], {kk: v[lo:hi] for kk, v in cols.items()}, hi - lo,
                            out=wire[j])
                    chunks.append((host, K, int(counts.sum()), part))
                staged.append(chunks)
        except WireNarrowMisfit:
            return None

        results: list[list] = [[] for _ in range(D)]
        rounds = max(len(c) for c in staged)
        # chunks dispatch round-robin, not in batch order: lineage
        # observations park keyed by global batch and replay in order
        fi._lin_begin_send()
        try:
            for r in range(rounds):
                for d in range(D):
                    if r >= len(staged[d]):
                        continue
                    host, K, n_events, part = staged[d][r]
                    dev = torch.from_numpy(host).to(self.devices[d])
                    wire, counts, bases = device_views(dev, K, prog.wire_bytes)
                    packs, event = fi._dispatch_chunk(prog, wire, counts, bases, K, n_events,
                                                      now, lin_ks=part)
                    if packs is None:
                        # the junction's handler owned the failure: this
                        # chunk's batches deliver nothing, kept aligned
                        results[d].append((None, None, K, len(part)))
                        continue
                    with self._lock:
                        self.dispatches[d] += 1
                        self.events[d] += n_events
                    results[d].append((packs, event, K, len(part)))
        finally:
            fi._lin_end_send()
        with self._lock:
            self.sends += 1
        try:
            self._merged_drain(fi, prog, results, M, D)
        except Exception as e:
            j = self.junction
            if j.exception_handler is None:
                raise
            j._on_worker_error(e, "sharded drain")
        return True

    def _merged_drain(self, fi, prog, results, M: int, D: int) -> None:
        """Read back every device's packs and deliver each endpoint's rows
        in the original micro-batch order: global batch k's rows come from
        device k % D's next iteration, so the row stream and the callback
        grouping equal the single-device drain's."""
        for pos, i in enumerate(prog.deliver_idx):
            qr = fi.endpoints[i].qr
            if not qr.query_callbacks:
                continue
            _layout, row_bytes = prog.layouts[i]
            dev_rows, dev_cnts = [], []
            for d in range(D):
                parts, cnt_parts = [], []
                for packs, event, K, nb in results[d]:
                    if packs is None:  # a dropped chunk: no rows, kept aligned
                        cnt_parts.append(np.zeros((nb,), np.int32))
                        continue
                    buf = packs[pos]
                    hdr_rows = -(-4 * K // row_bytes)
                    hdr = fi._readback(buf, 0, hdr_rows, event)
                    cnts = hdr.reshape(-1)[:4 * K].view(np.int32)
                    total = int(cnts.sum())
                    if total:
                        parts.append(fi._readback(buf, hdr_rows, hdr_rows + total, None))
                    # padding iterations (j >= nb) carry no rows
                    cnt_parts.append(np.asarray(cnts[:nb], np.int32))
                dev_rows.append(np.concatenate(parts) if parts
                                else np.zeros((0, row_bytes), np.uint8))
                dev_cnts.append(np.concatenate(cnt_parts) if cnt_parts
                                else np.zeros((0,), np.int32))
            seq_parts = []
            cseq = np.zeros((M,), dtype=np.int32)
            offs, iters = [0] * D, [0] * D
            for k in range(M):
                d = k % D
                ci = iters[d]
                iters[d] += 1
                c = int(dev_cnts[d][ci]) if ci < len(dev_cnts[d]) else 0
                cseq[k] = c
                if c:
                    seq_parts.append(dev_rows[d][offs[d]:offs[d] + c])
                    offs[d] += c
            total = int(cseq.sum())
            if total:
                fi.deliver_endpoint(prog, i, np.concatenate(seq_parts), cseq, total)


# ---------------------------------------------------------------------------
# partition-axis mesh placement (JAX shard.py:443-519)
# ---------------------------------------------------------------------------


def apply_partition_mesh(app_runtime, devices) -> dict:
    """Place every plain `PartitionedQueryRuntime` fed by an outer stream on
    the mesh: its [P] state axis split into D blocks, one a device, each
    shard stepping its block with the whole batch (parallel/mesh.py
    `replicated_step`; the rows equal the unsharded step's). Joins, patterns
    and `#inner`-fed queries keep the unsharded keyed step, as in JAX.
    Returns qid -> placement info."""
    from siddhi_tpu_torch.core.partition import PartitionedQueryRuntime

    D = len(devices)
    placed: dict = {}
    for pr in app_runtime.partitions:
        for qr in pr.queries:
            if type(qr) is not PartitionedQueryRuntime or qr.key_of is None:
                continue
            qid = qr.query_id
            padded = 0
            if qr.p % D != 0:
                if qr.state is not None:
                    placed[qid] = {
                        "sharded": False,
                        "reason": (
                            f"partitionCapacity {qr.p} % devices {D} != 0 "
                            "with live state"
                        ),
                    }
                    continue
                # dead slots: the key table keeps its capacity (the overflow
                # threshold), the padded lanes never receive a key
                target = -(-qr.p // D) * D
                padded = target - qr.p
                log.info(
                    "query '%s': padding @app:partitionCapacity %d to %d "
                    "(%d dead slot(s)) for the %d-device mesh",
                    qid, qr.p, target, padded, D,
                )
                qr.p = target
            qr.mesh_devices = list(devices)
            placed[qid] = {
                "sharded": True,
                "devices": D,
                "axis": "part",
                "local_slots": qr.p // D,
            }
            if padded:
                placed[qid]["padded_slots"] = padded
    return placed


# ---------------------------------------------------------------------------
# the app-level shard runtime, built at start() (JAX shard.py:527-641)
# ---------------------------------------------------------------------------


class ShardRuntime:
    """Resolved sharded-execution mode of one app, built by
    `SiddhiAppRuntime.start()` from the creation-time resolution; `apply()`
    places partitioned state on the mesh, arms key sharding and the batch
    routers."""

    def __init__(self, app_runtime, requested: int, axis: str):
        from siddhi_tpu_torch.parallel.mesh import mesh_devices

        self.app = app_runtime
        self.axis = axis
        self.requested = int(requested)
        devs = mesh_devices(app_runtime.device)
        n = min(self.requested, len(devs))
        if n < self.requested:
            log.warning(
                "app '%s': @app:shard requested %d devices but only %d are "
                "visible; clamping (set XLA_FLAGS="
                "--xla_force_host_platform_device_count=N for a virtual "
                "CPU mesh)",
                app_runtime.name, self.requested, len(devs),
            )
        self.devices = devs[:n]
        self.partitioned: dict = {}
        self.routers: dict = {}
        self.keyshard: dict = {}
        self.joins: dict = {}

    @property
    def n(self) -> int:
        return len(self.devices)

    def apply(self) -> None:
        if self.n < 2:
            log.warning(
                "app '%s': sharded execution disabled (%d device(s) "
                "available)", self.app.name, self.n,
            )
            return
        if self.axis in ("auto", "part", "keys"):
            self.partitioned = apply_partition_mesh(self.app, self.devices)
        self.rearm_keyshard()
        self.rearm_routers()

    def rearm_keyshard(self) -> None:
        """(Re)arm key-sharded group-by and join state (axis='keys' only);
        already-armed queries keep their live [D] state."""
        if self.n < 2 or self.axis != "keys":
            return
        from siddhi_tpu_torch.parallel.keyshard import apply_join_mesh, apply_keyshard

        self.keyshard.update(apply_keyshard(self.app, self.devices))
        self.joins.update(apply_join_mesh(self.app, self.devices))

    def rearm_routers(self) -> None:
        """(Re)arm batch-axis routers on every eligible fused ingest engine,
        carrying the counters of a router it replaces."""
        if self.n < 2 or self.axis not in ("auto", "batch"):
            return
        prev_routers = self.routers
        self.routers = {}
        for sid, j in list(self.app.junctions.items()):
            fi = j.fused_ingest
            if fi is None or not router_eligible(fi):
                continue
            r = BatchShardRouter(j, self.devices)
            prev = prev_routers.get(sid)
            if prev is not None and len(prev.devices) == len(self.devices):
                r.dispatches = list(prev.dispatches)
                r.events = list(prev.events)
                r.sends = prev.sends
            fi.shard_router = r
            self.routers[sid] = r

    def describe_state(self) -> dict:
        d: dict = {
            "devices": self.n,
            "requested": self.requested,
            "axis": self.axis,
        }
        if self.partitioned:
            d["partitioned"] = dict(self.partitioned)
        if self.routers:
            d["streams"] = {
                sid: r.describe_state() for sid, r in self.routers.items()
            }
        if self.keyshard:
            ks = {}
            for qid, info in self.keyshard.items():
                qr = self.app.queries.get(qid)
                ex = getattr(qr, "_keyshard", None)
                live = ex.describe_state() if ex is not None else {}
                ks[qid] = {**info, **live}
            d["keyshard"] = ks
        if self.joins:
            d["joins"] = dict(self.joins)
        return d
