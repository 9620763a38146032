"""Event lineage: explain every output back to its input events.

Ported from siddhi_tpu/observability/lineage.py, record for record. When an
alert fires, the first question is which input events caused it. Opt-in with
`@app:lineage(capacity='N', mode='full|sample', sample.every='K')`:

1. Ingress stamping: every stream junction gets a `LineageArena` (the flight
   recorder's columnar ring) that gives each valid CURRENT event a
   monotonically increasing per-stream sequence id and keeps the last
   `capacity` events decodable. A consumer's k-th CURRENT row is the
   junction's seq k, because every delivery path is order-preserving per
   stream.

2. Per-operator provenance: each armed query step also produces `__lin.*`
   lanes (device tensors beside its outputs; the emissions are untouched,
   so lineage on or off gives byte-identical rows), which a host recorder
   replays:

   * windows: the admit mask (after the filters) and the window flow's
     valid/kind/ts lanes drive an exact host replay of the membership — each
     emitted row records the seq ranges in the ring or bucket;
   * patterns and sequences: the per-ref capture timestamps of each match,
     resolved back to per-stream seqs;
   * joins: each matched row carries (probe row, partner window seq), the
     latter from the partner ring's seq view (`SlidingWindow.view_seq`, K48);
   * group-by: admitted rows carry their group key, emissions the out row's
     key, and the bucket is filtered by key;
   * aggregations: per time bucket, the contributing seq range and count.

   On the fused ingest the lanes of the K micro-batches are read back in one
   copy a chunk and replayed micro-batch by micro-batch.

3. Serving: `runtime.lineage(stream_or_query, index)` walks the recorded
   graph backward (through insert-into chains) to the input events, decoded
   on demand from the arenas; `runtime.lineage_report()` and the manager's
   `lineage_reports()` / `lineage_text()` summarise it.

Costs: nothing when off (one `is None` check a site). When on, each observed
step reads its `__lin.*` lanes back once, and host memory is bounded by
`capacity` per arena and per recorder, oldest first out.

Known degradations, recorded as `approx` instead of guessed: order-by/limit
queries, expired-probe join rows, join partners in windows without an
admission order (batch windows, tables, named windows), duplicate-timestamp
pattern captures, a host replay that desynchronizes, and evicted arena seqs
(resolved to the seq with `event: None`). A stream is walked back through a
producing query only when every stamped event is attributable to it;
multi-writer and externally co-fed streams are listed as `mixed`. Partitioned
queries are not recorded.

The host replay keeps the JAX package's records exactly; it reads each
step's lanes as Python lists (one conversion a lane), keeps the seq runs of
a window's membership incrementally, and keeps each record as a tuple the
garbage collector stops tracking (see QueryLineage), which is what holds it
up at 32,768-row batches.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Optional

import numpy as np

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import KIND_CURRENT, KIND_EXPIRED, KIND_RESET
from siddhi_tpu_torch.observability.flight import FlightRecorder, batch_to_host

# lane-name prefix of the lineage lanes a step produces
LIN = "__lin."

DEFAULT_CAPACITY = 1024
_MAX_CAPACITY = 1 << 20
_MODES = ("full", "sample")
DEFAULT_SAMPLE_EVERY = 16

# resolution expands at most this many seqs per input-stream set; wider sets
# stay as ranges with counts
_EXPAND_LIMIT = 512

# the thread's current publisher, set around a recorded query's insert-target
# publish (app_runtime._wire_insert): the arena stamp in
# StreamJunction.publish_batch attributes its seq range to that producer
_PUB_TLS = threading.local()


class publisher_context:
    """Marks (qid, recorder) as the publisher of every arena stamp inside the
    block. Re-entrant per thread (insert-into chains nest): the previous
    publisher is restored on exit."""

    __slots__ = ("_pub", "_prev")

    def __init__(self, qid: str, recorder):
        self._pub = (qid, recorder)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_PUB_TLS, "pub", None)
        _PUB_TLS.pub = self._pub
        return self

    def __exit__(self, *exc):
        _PUB_TLS.pub = self._prev
        return False


def current_publisher() -> Optional[tuple]:
    return getattr(_PUB_TLS, "pub", None)


class LineageConfig:
    __slots__ = ("capacity", "mode", "sample_every")

    def __init__(self, capacity: int = DEFAULT_CAPACITY, mode: str = "full",
                 sample_every: int = DEFAULT_SAMPLE_EVERY):
        self.capacity = int(capacity)
        self.mode = mode
        self.sample_every = int(sample_every)


def iter_lineage_annotation_problems(ann):
    """One message per malformed `@app:lineage` element."""
    for k, v in ann.elements:
        if k == "capacity" or (k is None and len(ann.elements) == 1):
            try:
                ok = 1 <= int(v) <= _MAX_CAPACITY
            except (TypeError, ValueError):
                ok = False
            if not ok:
                yield f"@app:lineage capacity '{v}' must be an integer in 1..{_MAX_CAPACITY}"
        elif k == "mode":
            if str(v) not in _MODES:
                yield f"@app:lineage mode '{v}' must be one of {'|'.join(_MODES)}"
        elif k == "sample.every":
            try:
                ok = int(v) >= 1
            except (TypeError, ValueError):
                ok = False
            if not ok:
                yield f"@app:lineage sample.every '{v}' must be a positive integer"
        else:
            yield (f"unknown @app:lineage option '{k if k is not None else v}' "
                   "(expected capacity, mode, sample.every)")


def resolve_lineage_annotation(ann) -> Optional[LineageConfig]:
    """LineageConfig from `@app:lineage(...)` (None when absent). Raises
    SiddhiAppCreationError on malformed options."""
    if ann is None:
        return None
    for problem in iter_lineage_annotation_problems(ann):
        raise SiddhiAppCreationError(problem)
    cap = ann.element("capacity")
    if cap is None and len(ann.elements) == 1 and ann.elements[0][0] is None:
        cap = ann.elements[0][1]
    return LineageConfig(
        capacity=int(cap) if cap is not None else DEFAULT_CAPACITY,
        mode=str(ann.element("mode") or "full"),
        sample_every=int(ann.element("sample.every") or DEFAULT_SAMPLE_EVERY),
    )


# ---------------------------------------------------------------------------
# reading the steps' lanes back
# ---------------------------------------------------------------------------


def read_lanes(steps: list) -> list:
    """Device lane dicts -> host numpy dicts, every lane of every dict in
    one device-to-host copy (the lanes viewed as bytes, side by side)."""
    import torch

    flat = [t for lanes in steps for t in lanes.values()]
    if not flat:
        return [{} for _ in steps]
    host = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in flat]).cpu().numpy()
    out, off = [], 0
    for lanes in steps:
        h = {}
        for k, t in lanes.items():
            nb = t.numel() * t.element_size()
            dt = torch.empty(0, dtype=t.dtype).numpy().dtype
            h[k] = host[off:off + nb].view(dt).reshape(tuple(t.shape))
            off += nb
        out.append(h)
    return out


def observe_steps(work: list, now: int) -> None:
    """Replay [(recorder, [(tag, device lanes), ...])] in order, after one
    readback of every lane. A failing observation is logged and dropped:
    provenance never breaks dispatch (the records show it). The cyclic
    garbage collector is paused meanwhile: a replay allocates a few objects
    an output and forms no cycle, and each collection it would trigger
    walks every young object."""
    import gc
    import logging

    hosts = iter(read_lanes([lanes for _lin, steps in work for _t, lanes in steps]))
    paused = gc.isenabled()
    gc.disable()
    try:
        for lin, steps in work:
            for tag, _lanes in steps:
                host = next(hosts)
                try:
                    lin.observe(host, now, tag)
                except Exception:
                    logging.getLogger(__name__).debug(
                        "lineage observe failed for query '%s'", lin.query_id, exc_info=True)
    finally:
        if paused:
            gc.enable()


# ---------------------------------------------------------------------------
# ingress stamping: the seq-addressable arena
# ---------------------------------------------------------------------------


class LineageArena(FlightRecorder):
    """Flight-recorder arena with sequence addressing: each recorded valid
    CURRENT event gets seq id = its position in the stream's publish order.
    `next_seq` is the stamp high-water; seq `s` is decodable while
    `next_seq - size <= s`. `last_range` is the (base, n) of the latest
    stamp."""

    def __init__(self, schema, interner, size: int):
        super().__init__(schema, interner, size)
        self.last_range: tuple[int, int] = (0, 0)
        # per-publish producer capture (base_seq, n, qid, pub_base), noted
        # when a recorded query's publish stamped the range: a multi-producer
        # stream resolves seq s to the producer whose publish covered it
        self.pub_log: deque = deque(maxlen=max(int(size), 64))

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._count

    def note_producer(self, base: int, n: int, qid: str, pub_base: int) -> None:
        with self._lock:
            self.pub_log.append((int(base), int(n), qid, int(pub_base)))

    def producer_for_seq(self, seq: int) -> Optional[tuple]:
        """(qid, producer pub_index) of the logged publish covering `seq`,
        or None (an input handler, a fused commit, or an evicted entry)."""
        s = int(seq)
        with self._lock:
            for base, n, qid, pub_base in reversed(self.pub_log):
                if base <= s < base + n:
                    return qid, pub_base + (s - base)
                if base + n <= s:
                    break  # the log is base-ordered
        return None

    def record_batch(self, batch) -> tuple[int, int]:
        """Stamp and record a device batch's valid CURRENT rows (one
        device-to-host copy); returns the (base_seq, n) assigned, n maybe 0.
        `last_range` is updated on every call."""
        ts, kind, valid, cols = batch_to_host(self.schema, batch)
        idx = np.nonzero(valid & (kind == KIND_CURRENT))[0]
        with self._lock:
            base = self._count
            if idx.size:
                self._write(ts[idx], None, {n: c[idx] for n, c in cols.items()}, idx.size)
            self.last_range = (base, int(idx.size))
        return self.last_range

    def record_columns(self, timestamps, cols, n: int) -> tuple[int, int]:
        """Stamp and record host columnar rows (the fused commit: every row
        is a valid CURRENT event)."""
        if n <= 0:
            with self._lock:
                self.last_range = (self._count, 0)
                return self.last_range
        ts = np.asarray(timestamps)[:n]
        host = {name: np.asarray(cols[name])[:n] for name in self._cols}
        with self._lock:
            base = self._count
            self._write(ts, None, host, n)
            self.last_range = (base, n)
        return (base, n)

    def events_for_seqs(self, seqs) -> dict:
        """Decode seq ids still in the ring to (timestamp, data tuple);
        evicted or future seqs map to None."""
        from siddhi_tpu_torch.core.event import rows_from_arrays

        want = sorted({int(s) for s in seqs if s is not None and s >= 0})
        out: dict = {int(s): None for s in seqs if s is not None}
        if not want:
            return out
        with self._lock:
            count = self._count
            live = [s for s in want if count - self.size <= s < count]
            if not live:
                return out
            # the slot from the write head, not seq % size: an oversized
            # publish trims to its tail, shifting the phase
            head = self._head
            slots = np.asarray([(head - (count - s)) % self.size for s in live])
            ts = self._ts[slots].copy()
            cols = {n: a[slots].copy() for n, a in self._cols.items()}
        kind = np.zeros((len(live),), np.int8)
        triples = rows_from_arrays(self.schema, ts, kind, cols, len(live), self.interner)
        for s, (t, _k, data) in zip(live, triples):
            out[s] = (t, data)
        return out

    def describe_state(self) -> dict:
        d = super().describe_state()
        d["next_seq"] = d.pop("total")
        return d


# ---------------------------------------------------------------------------
# seq-set compression
# ---------------------------------------------------------------------------


def _ranges(seqs) -> list[list[int]]:
    """Sorted seq ids -> inclusive [lo, hi] runs."""
    runs: list[list[int]] = []
    for s in seqs:
        s = int(s)
        if runs and s == runs[-1][1] + 1:
            runs[-1][1] = s
        elif runs and s == runs[-1][1]:
            continue
        else:
            runs.append([s, s])
    return runs


def _expand(runs, limit: int = _EXPAND_LIMIT) -> list[int]:
    out: list[int] = []
    for lo, hi in runs:
        for s in range(lo, hi + 1):
            out.append(s)
            if len(out) >= limit:
                return out
    return out


def _seqset(stream: str, seqs, truncated: bool = False) -> tuple:
    """A record's input set, kept compact: (stream, its runs flattened as
    (lo0, hi0, lo1, hi1, ...), the seq count, truncated)."""
    seqs = sorted({int(s) for s in seqs if s is not None and s >= 0})
    return (stream, tuple(itertools.chain.from_iterable(_ranges(seqs))), len(seqs),
            bool(truncated))


def _record_dict(rec: tuple) -> dict:
    """A kept record in JAX's form: {out_index, pub_index, ts, kind,
    inputs: [{stream, ranges: [[lo, hi], ...], n, truncated}], approx,
    trigger?}."""
    out_index, pub_index, ts, kind, inputs, approx, trigger = rec
    d = {
        "out_index": out_index,
        "pub_index": pub_index,
        "ts": ts,
        "kind": "CURRENT" if kind == KIND_CURRENT else "EXPIRED" if kind == KIND_EXPIRED else kind,
        "inputs": [{"stream": sid, "ranges": [[f[i], f[i + 1]] for i in range(0, len(f), 2)],
                    "n": n, "truncated": t} for sid, f, n, t in inputs],
        "approx": approx,
    }
    if trigger is not None:
        d["trigger"] = {"stream": trigger[0], "seq": trigger[1]}
    return d


class _Live:
    """A window's live members, oldest first, with their seq runs kept as
    members come and go (members join in increasing seq order, so the runs
    of the whole membership are `runs` itself)."""

    __slots__ = ("members", "runs")

    def __init__(self):
        self.members: deque = deque()
        self.runs: deque = deque()

    def __len__(self):
        return len(self.members)

    def __bool__(self):
        return bool(self.members)

    def __iter__(self):
        return iter(self.members)

    def append(self, e) -> None:
        self.members.append(e)
        runs = self.runs
        if runs and e.seq == runs[-1][1] + 1:
            runs[-1][1] = e.seq
        else:
            runs.append([e.seq, e.seq])

    def popleft(self):
        e = self.members.popleft()
        first = self.runs[0]
        if first[0] == first[1]:
            self.runs.popleft()
        else:
            first[0] += 1
        return e

    def clear(self) -> None:
        self.members.clear()
        self.runs.clear()

    def seqset(self, stream: str, truncated: bool) -> tuple:
        """The membership as `_seqset` forms it."""
        return (stream, tuple(itertools.chain.from_iterable(self.runs)), len(self.members),
                bool(truncated))


# ---------------------------------------------------------------------------
# per-query recorders
# ---------------------------------------------------------------------------


class _Entry:
    """One admitted input row in a recorder's shadow: (stream seq, event ts,
    window time, group key)."""

    __slots__ = ("seq", "ts", "wts", "key")

    def __init__(self, seq, ts, wts=None, key=None):
        self.seq = seq
        self.ts = ts
        self.wts = wts if wts is not None else ts
        self.key = key


class QueryLineage:
    """Base recorder: a bounded record ring and fan-in accounting.
    Subclasses implement `_observe` per runtime shape. Observation runs
    under the owning runtime's receive lock (per batch) or in the fused
    engine's in-order chunk loop; `_lock` also guards reads.

    The ring keeps each record as a tuple of ints, strings and tuples (see
    `_seqset`), which the garbage collector stops tracking after one look:
    a full ring of JAX's dicts and lists (about 30 containers a window
    record) made every later collection walk millions of objects. Readers
    get JAX's dicts (`records`, `record_for_*`, `last_record`)."""

    kind_name = "query"

    def __init__(self, cfg: LineageConfig, query_id: str, published_kinds):
        self.cfg = cfg
        self.query_id = query_id
        # kinds the query's insert-into publishes (all re-kinded CURRENT on
        # the target): maps the target's seq k to the k-th published record
        self.published_kinds = frozenset(published_kinds)
        self._records: deque = deque(maxlen=cfg.capacity)
        self.out_count = 0
        self.pub_count = 0
        self.total_inputs = 0
        self.max_inputs = 0
        self.approx_count = 0
        self.desync = False
        self._lock = threading.RLock()

    def observe(self, lanes: dict, now: int, tag=None) -> None:
        with self._lock:
            self._observe(lanes, now, tag)

    def _observe(self, lanes: dict, now: int, tag) -> None:
        raise NotImplementedError

    # -- recording ---------------------------------------------------------

    def _record(self, kind: int, ts, inputs: list, approx: bool, trigger=None) -> None:
        """One output: `inputs` are `_seqset` tuples, `trigger` a (stream,
        seq) pair or None."""
        out_index = self.out_count
        self.out_count += 1
        pub_index = None
        if kind in self.published_kinds:
            pub_index = self.pub_count
            self.pub_count += 1
        n_in = sum(s[2] for s in inputs)
        self.total_inputs += n_in
        if n_in > self.max_inputs:
            self.max_inputs = n_in
        if approx:
            self.approx_count += 1
        if self.cfg.mode == "sample" and out_index % self.cfg.sample_every != 0:
            return
        rec = (out_index, pub_index, int(ts), int(kind), tuple(inputs), bool(approx),
               None if trigger is None else (trigger[0], int(trigger[1])))
        with self._lock:
            self._records.append(rec)

    # -- reading -----------------------------------------------------------

    @property
    def records(self) -> list[dict]:
        """The kept records, oldest first, in JAX's form."""
        with self._lock:
            return [_record_dict(r) for r in self._records]

    def recent(self, n: int) -> list[dict]:
        """The newest `n` kept records, oldest first."""
        with self._lock:
            tail = list(itertools.islice(reversed(self._records), n))
        return [_record_dict(r) for r in reversed(tail)]

    def record_for_out_index(self, k: int) -> Optional[dict]:
        with self._lock:
            for rec in reversed(self._records):
                if rec[0] == k:
                    return _record_dict(rec)
        return None

    def record_for_pub_index(self, k: int) -> Optional[dict]:
        with self._lock:
            for rec in reversed(self._records):
                if rec[1] == k:
                    return _record_dict(rec)
        return None

    def last_record(self) -> Optional[dict]:
        with self._lock:
            return _record_dict(self._records[-1]) if self._records else None

    def fan_in(self) -> dict:
        n = self.out_count
        return {
            "outputs": n,
            "inputs": self.total_inputs,
            "avg_inputs_per_output": round(self.total_inputs / n, 3) if n else 0.0,
            "max_inputs_per_output": self.max_inputs,
        }

    def describe(self) -> dict:
        d = {"kind": self.kind_name, "mode": self.cfg.mode, "capacity": self.cfg.capacity,
             "recorded": len(self._records), "approx_records": self.approx_count}
        if self.desync:
            d["desync"] = True
        d.update(self.fan_in())
        return d


class SingleQueryLineage(QueryLineage):
    """Recorder for single-stream queries (filters, sliding and batch
    windows, group-by): an exact host replay of the device window's
    membership driven by the step's `__lin.*` lanes."""

    kind_name = "single"

    def __init__(self, cfg, query_id, published_kinds, *, input_stream: str, window=None,
                 grouped: bool = False, aggregated: bool = False, order_limited: bool = False):
        super().__init__(cfg, query_id, published_kinds)
        self.input_stream = input_stream
        self.window = window
        self.is_batch = bool(window is not None and window.is_batch)
        self.sliding = window is not None and not self.is_batch
        self.grouped = grouped
        self.aggregated = aggregated
        # order-by/limit permutes the out positions: records are step-level
        # approximations
        self.order_limited = order_limited
        self.in_seen = 0  # the stream seq high-water of this consumer
        self.pending: deque = deque()  # admitted, not yet born in the flow
        self.live = _Live()  # the current window or bucket members
        self.live_truncated = False

    def _observe(self, lanes: dict, now: int, tag) -> None:
        in_mask = lanes.get(LIN + "in")
        if in_mask is None:
            return
        in_ts = lanes[LIN + "in_ts"]
        admit = lanes.get(LIN + "admit", in_mask)
        keys = lanes.get(LIN + "key")
        wts = lanes.get(LIN + "wts")
        base = self.in_seen
        self.in_seen += int(in_mask.sum())

        # the admitted rows, in batch order, with their stream seqs
        rows = np.nonzero(admit & in_mask)[0]
        if rows.size:
            ranks = np.cumsum(in_mask, dtype=np.int64) - in_mask  # rank among the stream's rows
            seqs = (base + ranks[rows]).tolist()
            tss = in_ts[rows].tolist()
            wl = wts[rows].tolist() if wts is not None else [None] * rows.size
            kl = keys[rows].tolist() if keys is not None else [None] * rows.size
            self.pending.extend(map(_Entry, seqs, tss, wl, kl))

        w_valid = lanes[LIN + "w_valid"]
        out_valid = lanes[LIN + "out_valid"]
        pos = np.nonzero(w_valid | out_valid)[0]
        wv = w_valid[pos].tolist()
        wk = lanes[LIN + "w_kind"][pos].tolist()
        wt = lanes[LIN + "w_ts"][pos].tolist()
        ov = out_valid[pos].tolist()
        ok_ = lanes[LIN + "out_kind"][pos].tolist()
        gkey = lanes.get(LIN + "gkey")
        gk = gkey[pos].tolist() if gkey is not None else None
        bound = self.cfg.capacity
        live, pending = self.live, self.pending
        stateless = self.window is None and not self.aggregated and not self.grouped
        by_key = self.grouped and gk is not None
        stream = self.input_stream

        step_approx = self.order_limited
        for i in range(len(pos)):
            k = wk[i]
            e = None
            if wv[i]:
                if k == KIND_RESET:
                    if self.is_batch:
                        live.clear()
                        self.live_truncated = False
                    continue
                if k == KIND_CURRENT:
                    if pending:
                        e = pending.popleft()
                    else:
                        self.desync = True
                        step_approx = True
                    if e is not None:
                        live.append(e)
                        if len(live) > bound:
                            live.popleft()
                            self.live_truncated = True
                elif k == KIND_EXPIRED and self.sliding and live:
                    # sliding evictions are oldest first (the seq lane orders
                    # the candidates; capacity eviction rides the same path)
                    live.popleft()
            if not ov[i]:
                continue
            approx = step_approx
            trigger = (stream, e.seq) if e is not None else None
            if stateless:
                # the single admitted row is the provenance
                inputs = [_seqset(stream, [e.seq] if e is not None else [])]
                approx = approx or e is None
            else:
                if by_key:
                    kv = gk[i]
                    inputs = [_seqset(stream, [m.seq for m in live if m.key == kv],
                                      truncated=self.live_truncated)]
                else:
                    inputs = [live.seqset(stream, self.live_truncated)]
                approx = approx or self.live_truncated
            self._record(ok_[i], wt[i] if wv[i] else now, inputs, approx, trigger=trigger)
        if self.sliding or self.window is None:
            # sliding and stateless: every admitted row is born in the same
            # step; leftovers mean the replay desynchronized (an emission
            # buffer overflow) — absorb them so counts stay aligned, flagged
            while pending:
                self.desync = True
                live.append(pending.popleft())
                if len(live) > bound:
                    live.popleft()
                    self.live_truncated = True


class JoinQueryLineage(QueryLineage):
    """Recorder for two-sided joins: per matched output row the (left seq,
    right seq) pair, from the probe-row index and the partner ring's seq."""

    kind_name = "join"

    def __init__(self, cfg, query_id, published_kinds, *, left_stream: str,
                 right_stream: str, batch_capacity: int = 0):
        super().__init__(cfg, query_id, published_kinds)
        self.streams = {"l": left_stream, "r": right_stream}
        self.in_seen = {"l": 0, "r": 0}
        # per side, a shadow of the window keyed by the device's admission
        # seq (the SlidingWindow seq lane): window seq k is the k-th
        # filter-passing row the side admitted, in arrival order; the value
        # is its stream seq
        self.win: dict[str, dict[int, int]] = {"l": {}, "r": {}}
        self.win_count = {"l": 0, "r": 0}

    def _observe(self, lanes: dict, now: int, tag) -> None:
        side = tag if tag in ("l", "r") else "l"
        other = "r" if side == "l" else "l"
        in_mask = lanes.get(LIN + "in")
        if in_mask is None:
            return
        base = self.in_seen[side]
        self.in_seen[side] += int(in_mask.sum())
        ranks = np.cumsum(in_mask, dtype=np.int64) - in_mask

        admit = lanes.get(LIN + "admit")
        if admit is not None:
            shadow = self.win[side]
            rows = np.nonzero(admit & in_mask)[0]
            k, n, cap = self.win_count[side], int(rows.size), self.cfg.capacity
            shadow.update(zip(range(k, k + n), (base + ranks[rows]).tolist()))
            for old in range(max(k - cap, 0), max(k + n - cap, 0)):
                shadow.pop(old, None)  # bounded to the last `capacity` admissions
            self.win_count[side] = k + n

        out_valid = lanes.get(LIN + "out_valid")
        if out_valid is None:
            return
        pos = np.nonzero(out_valid)[0]
        kinds = lanes[LIN + "out_kind"][pos].tolist()
        tss = lanes[LIN + "out_ts"][pos].tolist()
        pis = lanes[LIN + "j_pi"][pos].tolist()
        pseqs = lanes[LIN + "j_pseq"][pos].tolist()
        n_rows = in_mask.shape[0]
        in_list = in_mask.tolist()
        partners = self.win[other]
        mine_sid, other_sid = self.streams[side], self.streams[other]
        for kind, ts, probe, pseq in zip(kinds, tss, pis, pseqs):
            approx = False
            my_seq = None
            if 0 <= probe < n_rows and in_list[probe]:
                my_seq = base + int(ranks[probe])
            else:
                approx = True  # an expired-probe row: not an input position
            partner = partners.get(pseq)
            mine: dict[str, list] = {}
            trigger = None
            if my_seq is not None:
                mine.setdefault(mine_sid, []).append(my_seq)
                trigger = (mine_sid, my_seq)
            if partner is not None:
                mine.setdefault(other_sid, []).append(partner)
            elif pseq >= 0:
                approx = True  # the partner left the bounded shadow
            elif pseq == -2:
                # a matched partner whose window keeps no admission order
                # (batch window, table, named window): flagged, never
                # guessed; -1 stays "outer join, no partner"
                approx = True
            inputs = [_seqset(sid, seqs) for sid, seqs in mine.items()]
            self._record(kind, ts, inputs, approx, trigger=trigger)


class PatternQueryLineage(QueryLineage):
    """Recorder for pattern and sequence NFAs: the per-ref capture
    timestamps of each match, resolved to seqs through a bounded per-stream
    (seq, ts) shadow."""

    kind_name = "pattern"

    def __init__(self, cfg, query_id, published_kinds, *, refs: list[tuple[str, str]]):
        super().__init__(cfg, query_id, published_kinds)
        self.refs = list(refs)  # [(ref name, stream id)] in linearized order
        self.in_seen: dict[str, int] = {}
        self.shadow: dict[str, deque] = {}
        # per stream: ts -> [entries in the shadow with that ts, newest seq]
        self._by_ts: dict[str, dict] = {}

    def _observe(self, lanes: dict, now: int, tag) -> None:
        stream_id = tag
        in_mask = lanes.get(LIN + "in")
        if in_mask is None:
            return
        if stream_id is not None and int(in_mask.sum()):
            in_ts = lanes[LIN + "in_ts"]
            base = self.in_seen.get(stream_id, 0)
            sh = self.shadow.get(stream_id)
            if sh is None:
                sh = self.shadow[stream_id] = deque(maxlen=self.cfg.capacity)
                self._by_ts[stream_id] = {}
            by_ts = self._by_ts[stream_id]
            cap = self.cfg.capacity
            for t in in_ts[np.nonzero(in_mask)[0]].tolist():
                if len(sh) == cap:  # the deque drops its oldest entry
                    _s, old = sh[0]
                    ent = by_ts[old]
                    ent[0] -= 1
                    if ent[0] == 0:
                        del by_ts[old]
                sh.append((base, t))
                ent = by_ts.get(t)
                if ent is None:
                    by_ts[t] = [1, base]
                else:
                    ent[0] += 1
                    ent[1] = base
                base += 1
            self.in_seen[stream_id] = base

        out_valid = lanes.get(LIN + "out_valid")
        if out_valid is None:
            return
        pos = np.nonzero(out_valid)[0]
        kinds = lanes[LIN + "out_kind"][pos].tolist()
        tss = lanes[LIN + "out_ts"][pos].tolist()
        caps = []
        for i, (_ref, sid) in enumerate(self.refs):
            n_lane = lanes.get(f"{LIN}p_n{i}")
            ts_lane = lanes.get(f"{LIN}p_ts{i}")
            if n_lane is None or ts_lane is None:
                continue
            caps.append((sid, n_lane[pos].tolist(), ts_lane[pos].tolist(),
                         self._by_ts.get(sid, {})))
        for j, (kind, ts) in enumerate(zip(kinds, tss)):
            per_stream: dict[str, list] = {}
            approx = False
            for sid, ns, tsr, by_ts in caps:
                row = tsr[j]
                for c in range(min(ns[j], len(row))):
                    ent = by_ts.get(row[c])
                    if ent is None:
                        approx = True
                    else:
                        per_stream.setdefault(sid, []).append(ent[1])
                        if ent[0] > 1:
                            # duplicate timestamps: the capture carries only
                            # ts, so the attribution is ambiguous — flagged
                            approx = True
            inputs = [_seqset(sid, seqs) for sid, seqs in per_stream.items()]
            self._record(kind, ts, inputs, approx)


class AggregationLineage:
    """Per-bucket provenance of an incremental aggregation: the
    contributing seq range and count per finest-duration bucket, for the
    last `capacity` buckets. Aggregations run per batch."""

    kind_name = "aggregation"

    def __init__(self, cfg: LineageConfig, agg_id: str, input_stream: str, duration):
        self.cfg = cfg
        self.agg_id = agg_id
        self.input_stream = input_stream
        self.duration = duration  # the finest Duration
        self.in_seen = 0
        self.buckets: dict = {}  # bucket start -> [lo, hi, count]
        self._order: deque = deque()
        self._lock = threading.Lock()

    def observe_ts(self, ts: np.ndarray) -> None:
        """The event times of one batch's valid CURRENT rows, in order."""
        import torch

        from siddhi_tpu_torch.ops.aggregation import align_bucket

        n = int(ts.shape[0])
        if n == 0:
            return
        base = self.in_seen
        self.in_seen += n
        bts = align_bucket(torch.from_numpy(np.asarray(ts, np.int64)),
                           self.duration.value).numpy().tolist()
        with self._lock:
            for i, b in enumerate(bts):
                ent = self.buckets.get(b)
                seq = base + i
                if ent is None:
                    self.buckets[b] = [seq, seq, 1]
                    self._order.append(b)
                    while len(self._order) > self.cfg.capacity:
                        self.buckets.pop(self._order.popleft(), None)
                else:
                    ent[0] = min(ent[0], seq)
                    ent[1] = max(ent[1], seq)
                    ent[2] += 1

    def describe(self) -> dict:
        with self._lock:
            return {
                "kind": self.kind_name,
                "stream": self.input_stream,
                "duration": getattr(self.duration, "name", str(self.duration)),
                "events": self.in_seen,
                "buckets": {str(b): {"seq_lo": e[0], "seq_hi": e[1], "count": e[2]}
                            for b, e in self.buckets.items()},
            }


# ---------------------------------------------------------------------------
# the per-app ledger: resolution and reports
# ---------------------------------------------------------------------------


class LineageLedger:
    """The app-level surface: owns the config, walks records backward
    through insert-into chains, renders the reports."""

    def __init__(self, runtime, cfg: LineageConfig):
        self.runtime = runtime
        self.cfg = cfg

    def recorders(self) -> dict:
        return {qid: qr.lineage for qid, qr in list(self.runtime.queries.items())
                if getattr(qr, "lineage", None) is not None}

    def agg_recorders(self) -> dict:
        return {aid: ar.lineage for aid, ar in getattr(self.runtime, "aggregations", {}).items()
                if getattr(ar, "lineage", None) is not None}

    def producers(self, stream_id: str) -> list[str]:
        """Recorded queries inserting into `stream_id`."""
        from siddhi_tpu_torch.query_api.execution import InsertIntoStream

        out = []
        for qid, qr in list(self.runtime.queries.items()):
            if getattr(qr, "lineage", None) is None:
                continue
            o = qr.query.output_stream
            if isinstance(o, InsertIntoStream) and o.target == stream_id:
                out.append(qid)
        return out

    def arena(self, stream_id: str) -> Optional[LineageArena]:
        j = self.runtime.junctions.get(stream_id)
        return getattr(j, "lineage", None) if j is not None else None

    def _sole_producer(self, stream_id: str, recs: dict):
        """(qid, producers) when every stamped event on `stream_id` is one
        recorded producer's: the junction seq k is then its k-th published
        record. Declined unless the arena's stamp count equals the
        producer's publish count exactly."""
        prods = self.producers(stream_id)
        if len(prods) != 1:
            return None, prods
        lin = recs.get(prods[0])
        arena = self.arena(stream_id)
        if lin is None or arena is None or arena.next_seq != lin.pub_count:
            return None, prods
        return prods[0], prods

    def resolve(self, target: str, index: Optional[int] = None, depth: int = 6) -> dict:
        """Explain output `index` of `target` (a query id or a stream id)
        back to the input events. Stream indices are the junction's seq ids
        (its valid CURRENT events in publish order)."""
        recs = self.recorders()
        if target in recs:
            rec = (recs[target].record_for_out_index(index) if index is not None
                   else recs[target].last_record())
            if rec is None:
                return {"query": target, "out_index": index,
                        "error": "no record (evicted, sampled out, or not yet emitted)"}
            return self._resolve_record(target, rec, depth, recs)
        if target in self.runtime.junctions:
            return self._resolve_stream(target, index, depth, recs)
        raise KeyError(f"'{target}' is neither a lineage-recorded query nor a stream")

    def _resolve_stream(self, stream_id: str, index: Optional[int], depth: int,
                        recs: Optional[dict] = None) -> dict:
        arena = self.arena(stream_id)
        if index is None:
            if arena is None or arena.next_seq == 0:
                return {"stream": stream_id, "error": "no events stamped"}
            index = arena.next_seq - 1
        node: dict = {"stream": stream_id, "seq": int(index)}
        if arena is not None:
            ev = arena.events_for_seqs([index]).get(int(index))
            if ev is not None:
                node["ts"], node["event"] = ev[0], list(ev[1])
            else:
                node["event"] = None
                node["evicted"] = index < arena.next_seq
        if recs is None:
            recs = self.recorders()
        sole, prods = self._sole_producer(stream_id, recs)
        if sole is not None and depth > 0:
            rec = recs[sole].record_for_pub_index(int(index))
            node["via"] = (self._resolve_record(sole, rec, depth - 1, recs) if rec is not None
                           else {"query": sole, "error": "record evicted or sampled out"})
        elif prods:
            # a multi-writer stream: the arena's producer log says which
            # recorded query stamped this seq; unlogged seqs list candidates
            hit = arena.producer_for_seq(int(index)) if arena is not None else None
            if hit is not None and hit[0] in recs and depth > 0:
                qid, pub_idx = hit
                node["producer"] = qid
                rec = recs[qid].record_for_pub_index(pub_idx)
                node["via"] = (self._resolve_record(qid, rec, depth - 1, recs)
                               if rec is not None
                               else {"query": qid, "error": "record evicted or sampled out"})
            else:
                node["producers"] = prods
                node["mixed"] = True
        return node

    def _resolve_record(self, qid: str, rec: dict, depth: int,
                        recs: Optional[dict] = None) -> dict:
        node = {"query": qid, "out_index": rec["out_index"], "ts": rec["ts"],
                "kind": rec["kind"], "approx": rec["approx"], "inputs": []}
        if "trigger" in rec:
            node["trigger"] = rec["trigger"]
        for ss in rec["inputs"]:
            sid = ss["stream"]
            entry: dict = {"stream": sid, "ranges": ss["ranges"], "n": ss["n"]}
            if ss.get("truncated"):
                entry["truncated"] = True
            seqs = _expand(ss["ranges"])
            arena = self.arena(sid)
            if arena is not None and seqs:
                evs = arena.events_for_seqs(seqs)
                entry["events"] = [
                    {"seq": s, **({"ts": evs[s][0], "event": list(evs[s][1])}
                                  if evs[s] is not None else {"event": None})}
                    for s in seqs
                ]
            if depth > 0:
                if recs is None:
                    recs = self.recorders()
                sole, _prods = self._sole_producer(sid, recs)
                ups = []
                if sole is not None:
                    for s in seqs[:8]:  # bound the recursive fan-out
                        up = recs[sole].record_for_pub_index(s)
                        if up is not None:
                            ups.append(self._resolve_record(sole, up, depth - 1, recs))
                else:
                    # a multi-producer upstream: each seq to its producer
                    for s in seqs[:8]:
                        hit = arena.producer_for_seq(s) if arena is not None else None
                        if hit is None or hit[0] not in recs:
                            continue
                        up = recs[hit[0]].record_for_pub_index(hit[1])
                        if up is not None:
                            ups.append(self._resolve_record(hit[0], up, depth - 1, recs))
                if ups:
                    entry["via"] = ups
            node["inputs"].append(entry)
        return node

    def report(self, resolve_recent: int = 1) -> dict:
        streams = {sid: j.lineage.describe_state()
                   for sid, j in list(self.runtime.junctions.items())
                   if getattr(j, "lineage", None) is not None}
        queries, recent = {}, {}
        recs = self.recorders()
        for qid, lin in recs.items():
            queries[qid] = lin.describe()
            if resolve_recent:
                chains = []
                for rec in lin.recent(resolve_recent):
                    try:
                        chains.append(self._resolve_record(qid, rec, 4, recs))
                    except Exception:  # resolution must never break a report
                        pass
                if chains:
                    recent[qid] = chains
        rep = {
            "config": {"capacity": self.cfg.capacity, "mode": self.cfg.mode},
            "streams": streams,
            "queries": queries,
            "aggregations": {aid: lin.describe() for aid, lin in self.agg_recorders().items()},
        }
        if recent:
            rep["recent"] = recent
        return rep


def render_lineage_text(reports: dict) -> str:
    """A human-readable summary (reports: app name -> ledger.report())."""
    lines: list[str] = []
    for app, rep in reports.items():
        lines.append(f"== app: {app} ==")
        cfg = rep.get("config", {})
        lines.append(f"  lineage capacity={cfg.get('capacity')} mode={cfg.get('mode')}")
        for sid, st in sorted(rep.get("streams", {}).items()):
            lines.append(f"  stream {sid}: next_seq={st.get('next_seq')} "
                         f"ring={st.get('recorded')}/{st.get('size')}")
        for qid, q in sorted(rep.get("queries", {}).items()):
            lines.append(
                f"  query {qid} [{q.get('kind')}]: outputs={q.get('outputs')}"
                f" fan-in avg={q.get('avg_inputs_per_output')}"
                f" max={q.get('max_inputs_per_output')}"
                f" recorded={q.get('recorded')}"
                + (" DESYNC" if q.get("desync") else "")
            )
        for aid, a in sorted(rep.get("aggregations", {}).items()):
            lines.append(f"  aggregation {aid}: events={a.get('events')} "
                         f"buckets={len(a.get('buckets') or {})}")
        for qid, chains in sorted(rep.get("recent", {}).items()):
            for ch in chains:
                lines.append(f"  last {qid}: {_chain_line(ch)}")
    return "\n".join(lines) + "\n"


def _chain_line(node: dict) -> str:
    parts = [f"out#{node.get('out_index')} ts={node.get('ts')} {node.get('kind')}"]
    for inp in node.get("inputs", ()):
        rng = ",".join(f"{lo}..{hi}" if lo != hi else str(lo) for lo, hi in inp.get("ranges", ()))
        parts.append(f"<- {inp['stream']}[{rng}] (n={inp['n']})")
    return " ".join(parts)
