"""The sort, frequent, lossyFrequent and cron window steps (K25-K28).

Each step walks a batch's rows in order, the JAX package's `lax.scan` of
`SortWindow.apply`, `FrequentWindow.apply`, `LossyFrequentWindow.apply` and
`CronWindow.apply` (siddhi_tpu/core/windows_special.py), and emits into a
fixed-capacity buffer: `_out_append` / `_out_append_many` there append at
the running count and drop (setting the overflow flag) past the capacity.

On the card each step is one hand-written CUDA kernel (csrc/special_window.cu)
that records where every output row and every state slot takes its data
from — a state slot, a batch row, or zeros (-1) — and one gather that fills
the column lanes from that map. Each `*_ref` beside a wrapper is its plain
version: the same walk over host lists, the same source map, gathered with
torch indexing. A wrapper takes it only for tensors on the CPU.

The frequent steps take the row keys precomputed (`key`, int64): the
window's key columns mixed by `ops/group.py` `mix_keys`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.event import (
    EventBatch,
    KIND_CURRENT,
    KIND_EXPIRED,
    KIND_RESET,
    KIND_TIMER,
)
from siddhi_tpu_torch.core.types import flush_subnormal
from siddhi_tpu_torch.ops.table import _Args

MAX_SORT_KEYS = 16  # kMaxSortKeys of csrc/special_window.cu
_KEY_TYPE = {torch.float32: 0, torch.int32: 1, torch.int64: 2, torch.bool: 3}


def sort_rows(bsz: int) -> int:
    return 2 * bsz


def frequent_rows(bsz: int, w: int) -> int:
    return 2 * bsz + w


def lossy_rows(bsz: int, c: int) -> int:
    return bsz + c


def cron_rows(bsz: int, w: int) -> int:
    return bsz + 2 * (2 * w + 1)  # room for two flushes a batch


# ---------------------------------------------------------------------------
# the plain side: the emission buffer and the gather
# ---------------------------------------------------------------------------


class _OutRef:
    """The JAX package's emission buffer as host lists: each row's source
    (an index into the sources laid end to end, -1 for zeros), ts and kind."""

    def __init__(self, cap: int):
        self.cap = cap
        self.src: list[int] = []
        self.ts: list[int] = []
        self.kind: list[int] = []
        self.ovf = False

    def append(self, src: int, ts: int, kind: int) -> None:  # _out_append
        if len(self.src) < self.cap:
            self.src.append(src)
            self.ts.append(ts)
            self.kind.append(kind)
        else:
            self.ovf = True

    def lanes(self, dev):
        n = len(self.src)
        pad = self.cap - n
        src = torch.tensor(self.src + [-1] * pad, dtype=torch.int64, device=dev)
        ts = torch.tensor(self.ts + [0] * pad, dtype=torch.int64, device=dev)
        kind = torch.tensor(self.kind + [0] * pad, dtype=torch.int8, device=dev)
        valid = torch.arange(self.cap, device=dev) < n
        return src, ts, kind, valid


def _gather_ref(sources: list, src: torch.Tensor) -> torch.Tensor:
    """Element i = the sources laid end to end at src[i], zero where -1."""
    cat = torch.cat([*sources, torch.zeros(1, dtype=sources[0].dtype, device=src.device)])
    return cat[torch.where(src < 0, cat.shape[0] - 1, src)]


def _flags(batch: EventBatch):
    cur = (batch.valid & (batch.kind == KIND_CURRENT)).tolist()
    timer = (batch.valid & (batch.kind == KIND_TIMER)).tolist()
    return cur, timer


def _out_batch(out: _OutRef, sources: dict, dev) -> EventBatch:
    src, ts, kind, valid = out.lanes(dev)
    return EventBatch(ts=ts, kind=kind, valid=valid,
                      cols={n: _gather_ref(s, src) for n, s in sources.items()})


# ---------------------------------------------------------------------------
# the card side: launch and gather
# ---------------------------------------------------------------------------


def _lanes_out(n: int, dev):
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int64, device=dev),
            torch.empty(n, dtype=torch.int8, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev))


def _gather(what: str, sources: list, idx: torch.Tensor, n0: int, n1: int) -> list:
    """One `sw_gather` launch set: per lane, up to three sources laid end to
    end (n0 and n1 rows long) read through idx."""
    outs = [torch.empty(idx.shape[0], dtype=s[0].dtype, device=idx.device) for s in sources]
    if not sources:
        return outs
    a = _Args()
    s2 = [s[2] if len(s) > 2 else s[-1] for s in sources]
    kernels.check(kernels.function("sw_gather")(
        len(sources), a.ptrs([s[0] for s in sources]), a.ptrs([s[1] for s in sources]),
        a.ptrs(s2), a.ptrs(outs), a.ints([s[0].element_size() for s in sources]),
        idx.data_ptr(), idx.shape[0], n0, n1, kernels.stream()), what)
    return outs


def _check_batch(what: str, batch: EventBatch, state_cols: dict, w: int) -> None:
    bsz = batch.capacity
    if (batch.ts.dtype, batch.kind.dtype, batch.valid.dtype) != (
            torch.int64, torch.int8, torch.bool):
        raise ValueError(f"{what}: batch lanes must be int64 ts, int8 kind, bool valid")
    if any(x.shape != (bsz,) for x in (batch.kind, batch.valid, *batch.cols.values())):
        raise ValueError(f"{what}: batch lanes must be [{bsz}]")
    if set(state_cols) != set(batch.cols) or any(
            state_cols[n].shape != (w,) or state_cols[n].dtype != a.dtype
            for n, a in batch.cols.items()):
        raise ValueError(f"{what}: each state column must be the batch column's dtype, [{w}]")
    if 2 * bsz + 4 * w + 2 >= 2**31:
        raise ValueError(f"{what}: batch {bsz} too large for int32 positions")


def _scratch(which: int, w: int, dev, k: int = 0) -> torch.Tensor:
    """The global scratch for a step's slot lanes, used when they do not fit
    in shared memory (0 sort, 1 frequent, 2 lossyFrequent, 3 cron)."""
    return torch.empty(kernels.function("sw_slot_bytes")(which, w, k), dtype=torch.uint8,
                       device=dev)


def _gather_slots(what, state, batch, new_src, out_src, w):
    """A sort/frequent/lossyFrequent step's columns from its source maps:
    the state's columns and ts through new_src, the output columns through
    out_src, each over [the w slots | the batch rows]."""
    names = list(batch.cols)
    pairs = [(state["cols"][n], batch.cols[n]) for n in names]
    st = _gather(what, pairs + [(state["ts"], batch.ts)], new_src, w, 1 << 30)
    out = _gather(what, pairs, out_src, w, 1 << 30)
    return dict(zip(names, st[:-1])), st[-1], dict(zip(names, out))


# ---------------------------------------------------------------------------
# K25: sort
# ---------------------------------------------------------------------------


def _sort_key_values(lane: torch.Tensor, desc: bool) -> list:
    """A key lane as the comparator sees it (JAX `_sort_keys`): bool as
    int32, `-c` for a descending key, wrapping on integers, a float's
    subnormals as zeros (XLA's comparisons flush them)."""
    if lane.dtype == torch.float32:
        vals = flush_subnormal(lane).tolist()
        return [-v for v in vals] if desc else vals
    vals = [int(v) for v in lane.tolist()]
    if not desc:
        return vals
    bits = 64 if lane.dtype == torch.int64 else 32
    half, full = 1 << (bits - 1), 1 << bits
    return [((-v + half) % full) - half for v in vals]


def _greater(a: tuple, b: tuple) -> bool:
    """JAX's lexicographic `gt` over (keys..., seq): `a > b` decides at the
    first key that is not equal; NaN is neither greater nor equal."""
    for x, y in zip(a, b):
        if x > y:
            return True
        if not x == y:
            return False
    return False


def sort_window_step_ref(state: dict, batch: EventBatch, now: torch.Tensor,
                         keys: list, w: int):
    """Plain version of `sort_window_step`: SortWindow.apply's scan."""
    dev = batch.ts.device
    bsz = batch.capacity
    cur, _ = _flags(batch)
    ts = batch.ts.tolist()
    t_now = int(now)
    key_rows = list(zip(*[_sort_key_values(batch.cols[n], d) for n, d in keys]))
    slot_keys = [list(k) for k in zip(*[_sort_key_values(state["cols"][n], d) for n, d in keys])]
    seq = state["seq"].tolist()
    occ = state["occ"].tolist()
    nxt = int(state["next"])
    src = list(range(w))
    out = _OutRef(sort_rows(bsz))
    for r in range(bsz):
        if not cur[r]:
            continue
        out.append(w + r, ts[r], KIND_CURRENT)
        arrival = tuple(key_rows[r]) + (nxt,)
        if all(occ):
            # the fold over w slots + the arrival: best moves to i when i is
            # greater (every candidate is occupied here)
            cands = [tuple(slot_keys[j]) + (seq[j],) for j in range(w)] + [arrival]
            best = 0
            for i in range(1, w + 1):
                if _greater(cands[i], cands[best]):
                    best = i
            out.append(w + r if best == w else src[best], t_now, KIND_EXPIRED)
            slot = best if best < w else None
        else:
            slot = occ.index(False)
        if slot is not None:
            slot_keys[slot] = list(key_rows[r])
            seq[slot] = nxt
            src[slot] = w + r
            occ[slot] = True
        nxt += 1
    names = list(batch.cols)
    sources = {n: [state["cols"][n], batch.cols[n]] for n in names}
    ssrc = torch.tensor(src, dtype=torch.int64, device=dev)
    new_state = {
        "cols": {n: _gather_ref(sources[n], ssrc) for n in names},
        "ts": _gather_ref([state["ts"], batch.ts], ssrc),
        "occ": torch.tensor(occ, dtype=torch.bool, device=dev),
        "seq": torch.tensor(seq, dtype=torch.int64, device=dev),
        "next": torch.tensor(nxt, dtype=torch.int64, device=dev),
    }
    return new_state, _out_batch(out, sources, dev), torch.tensor(out.ovf, device=dev)


def sort_window_step(state: dict, batch: EventBatch, now: torch.Tensor, keys: list, w: int):
    """One sort(w, keys) window step (K25).

    state: {"cols": {name: [w]}, "ts": [w] int64, "occ": [w] bool,
            "seq": [w] int64, "next": 0-d int64}
    keys:  [(attr, desc)] — the comparator, least significant last
    returns (new_state, out, overflow): out is the [2B] emission buffer
    (each CURRENT arrival, then the evicted greatest as EXPIRED at `now`)."""
    if batch.ts.device.type == "cpu":
        return sort_window_step_ref(state, batch, now, keys, w)
    what = "sort_window_step"
    lanes = [batch.ts, batch.kind, batch.valid, *batch.cols.values(), state["ts"], state["occ"],
             state["seq"], state["next"], now, *state["cols"].values()]
    kernels.require_cuda(what, *lanes)
    _check_batch(what, batch, state["cols"], w)
    if not 1 <= len(keys) <= MAX_SORT_KEYS:
        raise ValueError(f"{what}: 1 to {MAX_SORT_KEYS} sort keys, got {len(keys)}")
    bsz, dev, k = batch.capacity, batch.ts.device, len(keys)
    out_src, out_ts, out_kind, out_valid = _lanes_out(sort_rows(bsz), dev)
    new_src = torch.empty(w, dtype=torch.int32, device=dev)
    new_occ = torch.empty(w, dtype=torch.bool, device=dev)
    new_seq = torch.empty(w, dtype=torch.int64, device=dev)
    new_next = torch.empty((), dtype=torch.int64, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    scratch = _scratch(0, w, dev, k)
    a = _Args()
    kernels.check(kernels.function("sw_sort")(
        bsz, w, k, a.ptrs([state["cols"][n] for n, _ in keys]),
        a.ptrs([batch.cols[n] for n, _ in keys]),
        a.ints([_KEY_TYPE[batch.cols[n].dtype] for n, _ in keys]),
        a.ints([int(d) for _, d in keys]),
        batch.valid.data_ptr(), batch.kind.data_ptr(), batch.ts.data_ptr(),
        state["occ"].data_ptr(), state["seq"].data_ptr(), state["next"].data_ptr(),
        now.data_ptr(), scratch.data_ptr(), out_src.data_ptr(), out_ts.data_ptr(),
        out_kind.data_ptr(), out_valid.data_ptr(), new_src.data_ptr(), new_occ.data_ptr(),
        new_seq.data_ptr(), new_next.data_ptr(), ovf.data_ptr(), kernels.stream()), what)
    cols, ts, out_cols = _gather_slots(what, state, batch, new_src, out_src, w)
    new_state = {"cols": cols, "ts": ts, "occ": new_occ, "seq": new_seq, "next": new_next}
    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid, cols=out_cols)
    kernels.launches[what] += 1
    return new_state, out, ovf


# ---------------------------------------------------------------------------
# K26: frequent (Misra-Gries)
# ---------------------------------------------------------------------------


def _slot_of_key(occ: list, keys: list) -> dict:
    """key -> its occupied slot. Neither window stores a key twice (a key
    is inserted only when no occupied slot holds it), so this is the first
    hit of the JAX package's `argmax(occ & key == k)`."""
    hit = {}
    for s, (o, k) in enumerate(zip(occ, keys)):
        if o:
            hit.setdefault(k, s)
    return hit


def frequent_window_step_ref(state: dict, batch: EventBatch, key: torch.Tensor,
                             now: torch.Tensor, w: int):
    """Plain version of `frequent_window_step`: FrequentWindow.apply's scan."""
    dev = batch.ts.device
    bsz = batch.capacity
    cur, _ = _flags(batch)
    ts, rkey, t_now = batch.ts.tolist(), key.tolist(), int(now)
    occ, skey, cnt = state["occ"].tolist(), state["key"].tolist(), state["cnt"].tolist()
    src = list(range(w))
    hit = _slot_of_key(occ, skey)
    n_occ = sum(occ)
    out = _OutRef(frequent_rows(bsz, w))
    for r in range(bsz):
        if not cur[r]:
            continue
        k = rkey[r]
        slot = hit.get(k)
        exists = slot is not None
        if not exists:
            if n_occ == w:
                # every count drops by one; the zeros leave, in slot order
                for s in range(w):
                    if occ[s]:
                        cnt[s] -= 1
                        if cnt[s] == 0:
                            out.append(src[s], t_now, KIND_EXPIRED)
                            occ[s] = False
                            n_occ -= 1
                            if hit.get(skey[s]) == s:
                                del hit[skey[s]]
            if n_occ < w:
                slot = occ.index(False)
                n_occ += 1
        if slot is None:
            continue  # a new key with no slot: dropped, not passed on
        out.append(w + r, ts[r], KIND_CURRENT)
        src[slot], occ[slot], skey[slot] = w + r, True, k
        cnt[slot] = cnt[slot] + 1 if exists else 1
        hit[k] = slot
    names = list(batch.cols)
    sources = {n: [state["cols"][n], batch.cols[n]] for n in names}
    ssrc = torch.tensor(src, dtype=torch.int64, device=dev)
    new_state = {
        "cols": {n: _gather_ref(sources[n], ssrc) for n in names},
        "ts": _gather_ref([state["ts"], batch.ts], ssrc),
        "occ": torch.tensor(occ, dtype=torch.bool, device=dev),
        "key": torch.tensor(skey, dtype=torch.int64, device=dev),
        "cnt": torch.tensor(cnt, dtype=torch.int32, device=dev),
    }
    return new_state, _out_batch(out, sources, dev), torch.tensor(out.ovf, device=dev)


def frequent_window_step(state: dict, batch: EventBatch, key: torch.Tensor, now: torch.Tensor,
                         w: int):
    """One frequent(w) window step (K26).

    state: {"cols": {name: [w]}, "ts": [w] int64, "occ": [w] bool,
            "key": [w] int64, "cnt": [w] int32}
    key:   [B] int64 row keys
    returns (new_state, out, overflow): out is the [2B + w] buffer (the
    evictions of a full table as EXPIRED at `now`, in slot order, then the
    kept arrival as CURRENT)."""
    if batch.ts.device.type == "cpu":
        return frequent_window_step_ref(state, batch, key, now, w)
    what = "frequent_window_step"
    kernels.require_cuda(what, batch.ts, batch.kind, batch.valid, *batch.cols.values(), key, now,
                         state["ts"], state["occ"], state["key"], state["cnt"],
                         *state["cols"].values())
    _check_batch(what, batch, state["cols"], w)
    if key.shape != batch.ts.shape or key.dtype != torch.int64 or state["cnt"].dtype != torch.int32:
        raise ValueError(f"{what}: key must be [B] int64 and cnt int32")
    bsz, dev = batch.capacity, batch.ts.device
    out_src, out_ts, out_kind, out_valid = _lanes_out(frequent_rows(bsz, w), dev)
    new_src = torch.empty(w, dtype=torch.int32, device=dev)
    new_occ = torch.empty(w, dtype=torch.bool, device=dev)
    new_key = torch.empty(w, dtype=torch.int64, device=dev)
    new_cnt = torch.empty(w, dtype=torch.int32, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    scratch = _scratch(1, w, dev)
    kernels.check(kernels.function("sw_frequent")(
        bsz, w, batch.valid.data_ptr(), batch.kind.data_ptr(), batch.ts.data_ptr(),
        key.data_ptr(), state["occ"].data_ptr(), state["key"].data_ptr(),
        state["cnt"].data_ptr(), now.data_ptr(), scratch.data_ptr(), out_src.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(), new_src.data_ptr(),
        new_occ.data_ptr(), new_key.data_ptr(), new_cnt.data_ptr(), ovf.data_ptr(),
        kernels.stream()), what)
    cols, ts, out_cols = _gather_slots(what, state, batch, new_src, out_src, w)
    new_state = {"cols": cols, "ts": ts, "occ": new_occ, "key": new_key, "cnt": new_cnt}
    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid, cols=out_cols)
    kernels.launches[what] += 1
    return new_state, out, ovf


# ---------------------------------------------------------------------------
# K27: lossyFrequent (lossy counting)
# ---------------------------------------------------------------------------


def lossy_threshold(support: float, error: float) -> np.float32:
    """(s - e) as the JAX package multiplies it into a float32 total: a
    weakly typed Python float, formed in double and rounded once."""
    return np.float32(support - error)


def lossy_frequent_window_step_ref(state: dict, batch: EventBatch, key: torch.Tensor,
                                   now: torch.Tensor, c: int, width: int, support: float,
                                   error: float, cap: Optional[int] = None):
    """Plain version of `lossy_frequent_window_step`:
    LossyFrequentWindow.apply's scan (into `cap` output rows: the batch's
    own B + c by default; a partition's step passes the whole batch's)."""
    dev = batch.ts.device
    bsz = batch.capacity
    cur, _ = _flags(batch)
    ts, rkey, t_now = batch.ts.tolist(), key.tolist(), int(now)
    occ, skey = state["occ"].tolist(), state["key"].tolist()
    cnt, bucket = state["cnt"].tolist(), state["bucket"].tolist()
    total = int(state["total"])
    se = lossy_threshold(support, error)
    src = list(range(c))
    hit = _slot_of_key(occ, skey)
    n_occ = sum(occ)
    out = _OutRef(lossy_rows(bsz, c) if cap is None else cap)
    for r in range(bsz):
        if not cur[r]:
            continue
        k = rkey[r]
        total += 1
        cur_bucket = 1 if total <= 1 else (total + width - 1) // width
        slot = hit.get(k)
        exists = slot is not None
        if not exists:
            if n_occ < c:
                slot = occ.index(False)
                n_occ += 1
                cnt[slot], bucket[slot] = 1, cur_bucket - 1
            else:
                out.ovf = True  # no slot for a new key: the row is lost
        else:
            cnt[slot] += 1
        if slot is not None:
            src[slot], occ[slot], skey[slot] = c + r, True, k
            hit[k] = slot
            if np.float32(cnt[slot]) >= np.float32(se * np.float32(total)):
                out.append(c + r, ts[r], KIND_CURRENT)
        if total % width == 0:
            for s in range(c):  # the prune, in slot order
                if occ[s] and cnt[s] + bucket[s] <= cur_bucket:
                    out.append(src[s], t_now, KIND_EXPIRED)
                    occ[s] = False
                    n_occ -= 1
                    if hit.get(skey[s]) == s:
                        del hit[skey[s]]
    names = list(batch.cols)
    sources = {n: [state["cols"][n], batch.cols[n]] for n in names}
    ssrc = torch.tensor(src, dtype=torch.int64, device=dev)
    new_state = {
        "cols": {n: _gather_ref(sources[n], ssrc) for n in names},
        "ts": _gather_ref([state["ts"], batch.ts], ssrc),
        "occ": torch.tensor(occ, dtype=torch.bool, device=dev),
        "key": torch.tensor(skey, dtype=torch.int64, device=dev),
        "cnt": torch.tensor(cnt, dtype=torch.int64, device=dev),
        "bucket": torch.tensor(bucket, dtype=torch.int64, device=dev),
        "total": torch.tensor(total, dtype=torch.int64, device=dev),
    }
    return new_state, _out_batch(out, sources, dev), torch.tensor(out.ovf, device=dev)


def lossy_frequent_window_step(state: dict, batch: EventBatch, key: torch.Tensor,
                               now: torch.Tensor, c: int, width: int, support: float,
                               error: float):
    """One lossyFrequent(support, error) window step over c key slots (K27).

    state: {"cols": {name: [c]}, "ts": [c] int64, "occ": [c] bool,
            "key"/"cnt"/"bucket": [c] int64, "total": 0-d int64}
    returns (new_state, out, overflow): out is the [B + c] buffer (each
    arrival whose count meets (s - e)·total as CURRENT, then at each bucket
    boundary the pruned slots as EXPIRED at `now`, in slot order)."""
    if batch.ts.device.type == "cpu":
        return lossy_frequent_window_step_ref(state, batch, key, now, c, width, support, error)
    what = "lossy_frequent_window_step"
    kernels.require_cuda(what, batch.ts, batch.kind, batch.valid, *batch.cols.values(), key, now,
                         state["ts"], state["occ"], state["key"], state["cnt"], state["bucket"],
                         state["total"], *state["cols"].values())
    _check_batch(what, batch, state["cols"], c)
    if key.shape != batch.ts.shape or key.dtype != torch.int64:
        raise ValueError(f"{what}: key must be [B] int64")
    bsz, dev = batch.capacity, batch.ts.device
    out_src, out_ts, out_kind, out_valid = _lanes_out(lossy_rows(bsz, c), dev)
    new_src = torch.empty(c, dtype=torch.int32, device=dev)
    new_occ = torch.empty(c, dtype=torch.bool, device=dev)
    new_key, new_cnt, new_bucket = (torch.empty(c, dtype=torch.int64, device=dev)
                                    for _ in range(3))
    new_total = torch.empty((), dtype=torch.int64, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    scratch = _scratch(2, c, dev)
    kernels.check(kernels.function("sw_lossy")(
        bsz, c, width, float(lossy_threshold(support, error)), batch.valid.data_ptr(),
        batch.kind.data_ptr(), batch.ts.data_ptr(), key.data_ptr(), state["occ"].data_ptr(),
        state["key"].data_ptr(), state["cnt"].data_ptr(), state["bucket"].data_ptr(),
        state["total"].data_ptr(), now.data_ptr(), scratch.data_ptr(), out_src.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(), new_src.data_ptr(),
        new_occ.data_ptr(), new_key.data_ptr(), new_cnt.data_ptr(), new_bucket.data_ptr(),
        new_total.data_ptr(), ovf.data_ptr(), kernels.stream()), what)
    cols, ts, out_cols = _gather_slots(what, state, batch, new_src, out_src, c)
    new_state = {"cols": cols, "ts": ts, "occ": new_occ, "key": new_key, "cnt": new_cnt,
                 "bucket": new_bucket, "total": new_total}
    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid, cols=out_cols)
    kernels.launches[what] += 1
    return new_state, out, ovf


# ---------------------------------------------------------------------------
# K28: cron
# ---------------------------------------------------------------------------


def cron_window_step_ref(state: dict, batch: EventBatch, now: torch.Tensor, w: int,
                         cap: Optional[int] = None):
    """Plain version of `cron_window_step`: CronWindow.apply's scan (into
    `cap` output rows, by default the batch's own B + 2(2w + 1)). Sources
    laid end to end: the open bucket's w slots, the previous bucket's w
    slots, the batch rows."""
    dev = batch.ts.device
    bsz = batch.capacity
    cur, timer = _flags(batch)
    t_now = int(now)
    cur_n, prev_n = int(state["cur_n"]), int(state["prev_n"])
    cur_src, prev_src = list(range(w)), [w + j for j in range(w)]
    ts_all = state["cur_ts"].tolist() + state["prev_ts"].tolist() + batch.ts.tolist()
    out = _OutRef(cron_rows(bsz, w) if cap is None else cap)
    for r in range(bsz):
        if timer[r] and cur_n > 0:
            # the previous bucket EXPIRED, one RESET (its slot 0), the open
            # bucket CURRENT with the rows' own ts
            for j in range(prev_n):
                out.append(prev_src[j], t_now, KIND_EXPIRED)
            out.append(prev_src[0], t_now, KIND_RESET)
            for j in range(cur_n):
                s = cur_src[j]
                out.append(s, ts_all[s] if s >= 0 else 0, KIND_CURRENT)
            prev_src, prev_n = cur_src, cur_n
            cur_src, cur_n = [-1] * w, 0
        if cur[r]:
            if cur_n < w:
                cur_src[cur_n] = 2 * w + r
                cur_n += 1
            else:
                out.ovf = True
    names = list(batch.cols)
    sources = {n: [state["cur_cols"][n], state["prev_cols"][n], batch.cols[n]] for n in names}
    ts_sources = [state["cur_ts"], state["prev_ts"], batch.ts]
    csrc = torch.tensor(cur_src, dtype=torch.int64, device=dev)
    psrc = torch.tensor(prev_src, dtype=torch.int64, device=dev)
    new_state = {
        "cur_cols": {n: _gather_ref(sources[n], csrc) for n in names},
        "cur_ts": _gather_ref(ts_sources, csrc),
        "cur_n": torch.tensor(cur_n, dtype=torch.int32, device=dev),
        "prev_cols": {n: _gather_ref(sources[n], psrc) for n in names},
        "prev_ts": _gather_ref(ts_sources, psrc),
        "prev_n": torch.tensor(prev_n, dtype=torch.int32, device=dev),
    }
    return new_state, _out_batch(out, sources, dev), torch.tensor(out.ovf, device=dev)


def cron_window_step(state: dict, batch: EventBatch, now: torch.Tensor, w: int):
    """One cron window step over a w-slot bucket (K28).

    state: {"cur_cols"/"prev_cols": {name: [w]}, "cur_ts"/"prev_ts": [w]
            int64, "cur_n"/"prev_n": 0-d int32}
    returns (new_state, out, overflow): out is the [B + 2(2w + 1)] buffer;
    each TIMER row with a non-empty bucket flushes (previous bucket EXPIRED
    at `now`, a RESET, the bucket CURRENT) and each CURRENT row joins the
    open bucket."""
    if batch.ts.device.type == "cpu":
        return cron_window_step_ref(state, batch, now, w)
    what = "cron_window_step"
    kernels.require_cuda(what, batch.ts, batch.kind, batch.valid, *batch.cols.values(), now,
                         state["cur_ts"], state["cur_n"], state["prev_ts"], state["prev_n"],
                         *state["cur_cols"].values(), *state["prev_cols"].values())
    _check_batch(what, batch, state["cur_cols"], w)
    _check_batch(what, batch, state["prev_cols"], w)
    if (state["cur_n"].dtype, state["prev_n"].dtype) != (torch.int32, torch.int32):
        raise ValueError(f"{what}: cur_n and prev_n must be int32")
    bsz, dev = batch.capacity, batch.ts.device
    out_src, out_ts, out_kind, out_valid = _lanes_out(cron_rows(bsz, w), dev)
    new_cur, new_prev = (torch.empty(w, dtype=torch.int32, device=dev) for _ in range(2))
    new_cur_n, new_prev_n = (torch.empty((), dtype=torch.int32, device=dev) for _ in range(2))
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    scratch = _scratch(3, w, dev)
    kernels.check(kernels.function("sw_cron")(
        bsz, w, batch.valid.data_ptr(), batch.kind.data_ptr(), batch.ts.data_ptr(),
        state["cur_ts"].data_ptr(), state["cur_n"].data_ptr(), state["prev_ts"].data_ptr(),
        state["prev_n"].data_ptr(), now.data_ptr(), scratch.data_ptr(), out_src.data_ptr(),
        out_ts.data_ptr(), out_kind.data_ptr(), out_valid.data_ptr(), new_cur.data_ptr(),
        new_prev.data_ptr(), new_cur_n.data_ptr(), new_prev_n.data_ptr(), ovf.data_ptr(),
        kernels.stream()), what)
    names = list(batch.cols)
    sources = [(state["cur_cols"][n], state["prev_cols"][n], batch.cols[n]) for n in names]
    sources.append((state["cur_ts"], state["prev_ts"], batch.ts))
    cur = _gather(what, sources, new_cur, w, w)
    prev = _gather(what, sources, new_prev, w, w)
    new_state = {
        "cur_cols": dict(zip(names, cur[:-1])), "cur_ts": cur[-1], "cur_n": new_cur_n,
        "prev_cols": dict(zip(names, prev[:-1])), "prev_ts": prev[-1], "prev_n": new_prev_n,
    }
    out = EventBatch(ts=out_ts, kind=out_kind, valid=out_valid,
                     cols=dict(zip(names, _gather(what, sources[:-1], out_src, w, w))))
    kernels.launches[what] += 1
    return new_state, out, ovf
