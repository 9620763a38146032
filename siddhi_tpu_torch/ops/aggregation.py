"""The incremental aggregation's duration-chain step (K44) and the in-flight
merge of a find (K45).

The JAX package (siddhi_tpu/core/aggregation.py) keeps one bucket store a
duration (sec ... year): `[G]` group keys, used flags and one `[G]` lane a
base (sum/count, min, max, last), and the open bucket's start. Its step
(`_step_impl`) scans the batch's rows in order and, for each row and each
duration, closes the open bucket when the row's aligned bucket passes it
(the store is copied into the step's spill buffer, reset, and rolled up
into the next coarser duration) and absorbs the row, or the child's
closed store, through `_merge_into` (a masked [G, G] merge: each source
group finds its key among the used slots, misses take new slots in order,
overflow past G is dropped and flagged). A find (`_find_impl`) merges the
finest .. `per` stores into one store aligned to `per`.

Here the state is the same, stacked: every store lane [D, G] (D durations),
the buckets [D], the spills [D, S, G] with their start times [D, S] and
counts [D] (S = SPILLS_PER_BATCH closes a duration a step; past it a close
still rolls up but is not spilled, and the flag is set). On the card each
step is one hand-written CUDA kernel (csrc/aggregation.cu): one block walks
the rows in order, its threads over the G slots; each `*_ref` beside a
wrapper is its plain version (the same walk over host arrays, the JAX
scan's order, so float sums come out bit for bit), which the wrapper takes
only for tensors on the CPU. The bucket alignment, with the civil calendar
for months and years, is `align_bucket` (int64 torch on either device,
and the same integer arithmetic in the kernel).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.types import FLT_MIN
from siddhi_tpu_torch.ops.table import _Args

SPILLS_PER_BATCH = 4  # kSpills of csrc/aggregation.cu
MAX_BASES = 32  # kMaxBases
MAX_DURATIONS = 6
_DAY_MS = 86_400_000
# a duration as the kernel takes it: its millis, or -2 months, -1 years
# (query_api Duration's values)
_MONTHS, _YEARS = -2, -1
_OP = {"sum": 0, "count": 0, "min": 1, "max": 2, "last": 3}
_TYPE = {torch.float32: 0, torch.int32: 1, torch.int64: 2, torch.bool: 3}


# ---------------------------------------------------------------------------
# the civil calendar (Howard Hinnant's algorithms, integer only)
# ---------------------------------------------------------------------------


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    return y + (m <= 2).to(torch.int64), m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d) -> torch.Tensor:
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def align_bucket(ts: torch.Tensor, duration: int) -> torch.Tensor:
    """The start (epoch ms, GMT) of the bucket of `duration` (its millis,
    or -2 months, -1 years) holding each ts (reference:
    IncrementalTimeConverterUtil.getStartTimeOfAggregates); int64,
    wrapping as the JAX package's int64 does."""
    ts = ts.to(torch.int64)
    if duration > 0:
        return _fdiv(ts, duration) * duration
    days = _fdiv(ts, _DAY_MS)
    y, m, _d = _civil_from_days(days)
    start = _days_from_civil(y, m if duration == _MONTHS else torch.ones_like(m), 1)
    return start * _DAY_MS


def _align1(ts: int, duration: int) -> int:
    return int(align_bucket(torch.tensor([ts], dtype=torch.int64), duration)[0])


def base_init(op: str, dtype: torch.dtype):
    """The empty store's value of a base lane: +inf / the type's max for
    min, -inf / its min for max, else zero."""
    if op == "min":
        return math.inf if dtype == torch.float32 else torch.iinfo(dtype).max
    if op == "max":
        return -math.inf if dtype == torch.float32 else torch.iinfo(dtype).min
    return 0


def _init_bits(op: str, dtype: torch.dtype) -> int:
    v = torch.tensor([base_init(op, dtype)], dtype=dtype)
    if dtype == torch.float32:
        return int(v.view(torch.int32)[0])
    return int(v.to(torch.int64)[0])


# ---------------------------------------------------------------------------
# the plain side: `_merge_into` over host arrays
# ---------------------------------------------------------------------------


def _fmin(a, b):
    """XLA's scatter-min on float32: NaN wins; of -0.0 and 0.0, -0.0."""
    if a != a:
        return a
    if b != b:
        return b
    if a < b:
        return a
    if b < a:
        return b
    return a if math.copysign(1.0, a) < 0 else b


def _fmax(a, b):
    """XLA's scatter-max on float32: NaN wins; of -0.0 and 0.0, 0.0."""
    if a != a:
        return a
    if b != b:
        return b
    if a > b:
        return a
    if b > a:
        return b
    return b if math.copysign(1.0, a) < 0 else a


def _fl(x):
    """A float32 scalar as XLA's CPU code reads it: a subnormal as a zero
    of its sign (core/types.py flush_subnormal)."""
    return x * np.float32(0) if abs(x) < FLT_MIN else x


def _fold(op: str, is_float: bool, dst, src):
    if is_float and op != "last":
        # XLA's scatter-add/min/max read subnormals as zeros; a float32 sum
        # below FLT_MIN is exact, and flushed as well
        dst, src = _fl(dst), _fl(src)
    if op in ("sum", "count"):
        r = dst + src  # numpy scalars: float32 / wrapping int64 arithmetic
        return _fl(r) if is_float else r
    if op == "min":
        return _fmin(dst, src) if is_float else min(dst, src)
    if op == "max":
        return _fmax(dst, src) if is_float else max(dst, src)
    return src


class _Store:
    """One store's lanes as host arrays (views into the [D, G] arrays)."""

    def __init__(self, keys, used, vals: dict):
        self.keys, self.used, self.vals = keys, used, vals


def _first_slots(st: _Store) -> dict:
    """key -> the first used slot holding it (the `argmax` of the merge)."""
    first = {}
    for j in np.flatnonzero(st.used).tolist():
        first.setdefault(int(st.keys[j]), j)
    return first


def _merge_ref(dst: _Store, n_used: int, first: dict, src: _Store, src_used, ops: dict, g: int):
    """`_merge_into`: each used source slot (in slot order) to the first
    used destination slot holding its key (`first`, kept up to date), else
    to slot n_used + (misses before it), dropped (flag set) at G or past.
    Returns (n_used', flag). The used slots of a store are a prefix (they
    fill in order and a close empties the store), so n_used' counts the
    slots taken; a source's keys are distinct, so a key taken by this merge
    is never looked up again in it."""
    ovf = False
    rank = 0
    n0 = n_used
    for i in np.flatnonzero(src_used).tolist():
        k = int(src.keys[i])
        slot = first.get(k)
        if slot is None:
            slot = n0 + rank
            rank += 1
            if slot >= g:
                ovf = True
                continue
            dst.keys[slot] = k
            dst.used[slot] = True
            first[k] = slot
            n_used += 1
        for b, op in ops.items():
            dv = dst.vals[b]
            dv[slot] = _fold(op, dv.dtype == np.float32, dv[slot], src.vals[b][i])
    return n_used, ovf


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def agg_step_ref(state: dict, ts: torch.Tensor, live: torch.Tensor, timer: torch.Tensor,
                 key: torch.Tensor, contribs: dict, ops: dict, durations: list):
    """Plain version of `agg_step`: the JAX scan's body row by row over host
    arrays (`do_close`, `_merge_into`)."""
    dev = ts.device
    keys, used = _host(state["keys"]), _host(state["used"])
    n_dur, g = keys.shape
    vals = {b: _host(v) for b, v in state["vals"].items()}
    bucket = state["bucket"].tolist()
    n_used = used.sum(1).tolist()
    s = SPILLS_PER_BATCH
    sp_ts = np.zeros((n_dur, s), np.int64)
    sp_keys = np.zeros((n_dur, s, g), np.int64)
    sp_used = np.zeros((n_dur, s, g), bool)
    sp_vals = {b: np.zeros((n_dur, s, g), v.dtype) for b, v in vals.items()}
    sn = [0] * n_dur
    ovf = False
    init = {b: np.array(base_init(op, state["vals"][b].dtype), vals[b].dtype)
            for b, op in ops.items()}
    stores = [_Store(keys[d], used[d], {b: vals[b][d] for b in ops}) for d in range(n_dur)]
    index = [_first_slots(st) for st in stores]
    rows_ts = ts.tolist()
    nb_all = [align_bucket(ts, d).tolist() for d in durations]
    live_l, timer_l, key_l = live.tolist(), timer.tolist(), key.tolist()
    con = {b: _host(c) for b, c in contribs.items()}

    def close(d: int, nb: int):
        """do_close: spill (or flag), snapshot, reset; returns the snapshot
        and the closed bucket."""
        nonlocal ovf
        st = stores[d]
        snap = _Store(st.keys.copy(), st.used.copy(), {b: v.copy() for b, v in st.vals.items()})
        if sn[d] < s:
            sp_ts[d, sn[d]] = bucket[d]
            sp_keys[d, sn[d]] = st.keys
            sp_used[d, sn[d]] = st.used
            for b in ops:
                sp_vals[b][d, sn[d]] = st.vals[b]
        else:
            ovf = True
        sn[d] += 1
        closed = bucket[d]
        st.keys[:] = 0
        st.used[:] = False
        for b in ops:
            st.vals[b][:] = init[b]
        bucket[d] = nb
        n_used[d] = 0
        index[d] = {}
        return snap, closed

    row = _Store(np.zeros(1, np.int64), np.zeros(1, bool), {})
    for r in range(len(rows_ts)):
        t = rows_ts[r]
        adv = live_l[r] or timer_l[r]
        snap, roll_ts = None, t
        for d in range(n_dur):
            nb = nb_all[d][r]
            if d == 0:
                # the row belongs to the new bucket: close, then absorb
                closing = adv and bucket[0] >= 0 and nb > bucket[0]
                closed = None
                if closing:
                    snap, closed = close(0, nb)
                if bucket[0] < 0:
                    bucket[0] = nb
                if live_l[r]:
                    row.keys[0] = key_l[r]
                    row.vals = {b: con[b][r:r + 1] for b in ops}
                    n_used[0], mo = _merge_ref(stores[0], n_used[0], index[0], row,
                                               np.ones(1, bool), ops, g)
                    ovf = ovf or mo
                roll_ts = closed if closing else t
            else:
                # a child rollup belongs to the open bucket: absorb, then
                # close on the row's own time
                if snap is not None:
                    n_used[d], mo = _merge_ref(stores[d], n_used[d], index[d], snap, snap.used,
                                               ops, g)
                    ovf = ovf or mo
                if bucket[d] < 0:
                    bucket[d] = nb if roll_ts == t else _align1(roll_ts, durations[d])
                closing = adv and bucket[d] >= 0 and nb > bucket[d]
                snap = None
                if closing:
                    snap, closed = close(d, nb)
                    roll_ts = closed
                else:
                    roll_ts = t

    def t_(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    new_state = {
        "keys": t_(keys), "used": t_(used), "vals": {b: t_(v) for b, v in vals.items()},
        "bucket": torch.tensor(bucket, dtype=torch.int64, device=dev),
        "spill": {"ts": t_(sp_ts), "keys": t_(sp_keys), "used": t_(sp_used),
                  "vals": {b: t_(v) for b, v in sp_vals.items()}},
        "spill_n": torch.tensor(sn, dtype=torch.int32, device=dev),
    }
    return new_state, torch.tensor(ovf, device=dev)


def agg_find_merge_ref(state: dict, n_stores: int, per: int, ops: dict):
    """Plain version of `agg_find_merge`."""
    dev = state["keys"].device
    g = state["keys"].shape[1]
    temp = _Store(np.zeros(g, np.int64), np.zeros(g, bool),
                  {b: np.full(g, base_init(op, state["vals"][b].dtype),
                              _host(state["vals"][b]).dtype) for b, op in ops.items()})
    bucket, n_used, ovf, first = -1, 0, False, {}
    keys, used = _host(state["keys"]), _host(state["used"])
    vals = {b: _host(v) for b, v in state["vals"].items()}
    buckets = state["bucket"].tolist()
    for d in range(n_stores):
        has = buckets[d] >= 0
        aligned = _align1(max(buckets[d], 0), per) if has else -1
        src = _Store(keys[d], used[d], {b: vals[b][d] for b in ops})
        n_used, mo = _merge_ref(temp, n_used, first, src, used[d] & has, ops, g)
        ovf = ovf or mo
        if bucket < 0:
            bucket = aligned
    return ({"keys": torch.from_numpy(temp.keys).to(dev),
             "used": torch.from_numpy(temp.used).to(dev),
             "vals": {b: torch.from_numpy(v).to(dev) for b, v in temp.vals.items()},
             "bucket": torch.tensor(bucket, dtype=torch.int64, device=dev)},
            torch.tensor(ovf, device=dev))


# ---------------------------------------------------------------------------
# the card side
# ---------------------------------------------------------------------------


def _check(what: str, state: dict, ops: dict, n_dur: int, durations=()) -> int:
    if not 1 <= n_dur <= MAX_DURATIONS or not 1 <= len(ops) <= MAX_BASES:
        raise ValueError(f"{what}: 1 to {MAX_DURATIONS} durations and 1 to {MAX_BASES} bases")
    if any(not (d > 0 or d in (_MONTHS, _YEARS)) or d >= 2**31 for d in durations):
        raise ValueError(f"{what}: durations are millis, {_MONTHS} (months) or {_YEARS} (years)")
    g = state["keys"].shape[1]
    if state["keys"].shape != (n_dur, g) or state["keys"].dtype != torch.int64 or \
            state["used"].shape != (n_dur, g) or state["used"].dtype != torch.bool or \
            state["bucket"].shape != (n_dur,) or state["bucket"].dtype != torch.int64 or \
            set(state["vals"]) != set(ops) or any(
                v.shape != (n_dur, g) or v.dtype not in _TYPE for v in state["vals"].values()):
        raise ValueError(f"{what}: store lanes must be [{n_dur}, G] and one a base")
    return g


def _bases(a: _Args, ops: dict, vals: dict):
    names = list(ops)
    return (len(names), a.ints([_OP[ops[b]] for b in names]),
            a.ints([_TYPE[vals[b].dtype] for b in names]), names)


def _init_arr(a: _Args, ops: dict, vals: dict) -> int:
    """The bases' empty values as a C long long array (kept alive by `a`)."""
    arr = (ctypes.c_longlong * len(ops))(*[_init_bits(op, vals[b].dtype)
                                           for b, op in ops.items()])
    a._keep.append(arr)
    return ctypes.addressof(arr)


def agg_step(state: dict, ts: torch.Tensor, live: torch.Tensor, timer: torch.Tensor,
             key: torch.Tensor, contribs: dict, ops: dict, durations: list):
    """One step of the duration chain over a batch of B rows (K44).

    state:     {"keys": [D, G] int64, "used": [D, G] bool, "vals": {base:
               [D, G]}, "bucket": [D] int64} (spill lanes are rebuilt)
    ts:        [B] int64 each row's event time (`aggregate by` or its ts; a
               TIMER row its ts); live [B] bool (valid CURRENT, past the
               filters); timer [B] bool (valid TIMER)
    key:       [B] int64 each row's group key; contribs {base: [B]} of the
               base's dtype
    ops:       {base: "sum" | "count" | "min" | "max" | "last"}, in order
    durations: D duration codes, finest first (millis; -2 months, -1 years)
    returns (new_state with "spill": {"ts": [D, S] int64, "keys": [D, S, G],
    "used": [D, S, G], "vals": {base: [D, S, G]}} and "spill_n": [D] int32,
    overflow): for each row in order and each duration, the open bucket
    closes when the row's aligned bucket passes it (the finest closes, then
    absorbs the row; a coarser one absorbs its child's closed store, then
    closes on the row's own time). One block walks the rows
    (csrc/aggregation.cu `agg_step`)."""
    if ts.device.type == "cpu":
        return agg_step_ref(state, ts, live, timer, key, contribs, ops, durations)
    what = "agg_step"
    n_dur = len(durations)
    g = _check(what, state, ops, n_dur, durations)
    b = ts.shape[0]
    kernels.require_cuda(what, ts, live, timer, key, state["keys"], state["used"],
                         state["bucket"], *state["vals"].values(), *contribs.values())
    if any(x.shape != (b,) for x in (live, timer, key, *contribs.values())) or any(
            contribs[n].dtype != state["vals"][n].dtype for n in ops) or \
            (ts.dtype, key.dtype, live.dtype, timer.dtype) != (
                torch.int64, torch.int64, torch.bool, torch.bool):
        raise ValueError(f"{what}: row lanes must be [{b}] of the bases' dtypes")
    dev, s = ts.device, SPILLS_PER_BATCH
    vals = state["vals"]
    new_keys = torch.empty_like(state["keys"])
    new_used = torch.empty_like(state["used"])
    new_vals = {n: torch.empty_like(v) for n, v in vals.items()}
    new_bucket = torch.empty_like(state["bucket"])
    sp_ts = torch.empty((n_dur, s), dtype=torch.int64, device=dev)
    sp_keys = torch.empty((n_dur, s, g), dtype=torch.int64, device=dev)
    sp_used = torch.empty((n_dur, s, g), dtype=torch.bool, device=dev)
    sp_vals = {n: torch.empty((n_dur, s, g), dtype=v.dtype, device=dev) for n, v in vals.items()}
    spill_n = torch.empty(n_dur, dtype=torch.int32, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty(g * (9 + 8 * len(ops)) + 64, dtype=torch.uint8, device=dev)
    a = _Args()
    nb, op_arr, type_arr, names = _bases(a, ops, vals)
    init = _init_arr(a, ops, vals)
    kernels.check(kernels.function("agg_step")(
        b, g, n_dur, nb, op_arr, type_arr, init, a.ints(list(durations)),
        ts.data_ptr(), live.data_ptr(), timer.data_ptr(), key.data_ptr(),
        a.ptrs([contribs[n] for n in names]), state["keys"].data_ptr(),
        state["used"].data_ptr(), a.ptrs([vals[n] for n in names]),
        state["bucket"].data_ptr(), new_keys.data_ptr(), new_used.data_ptr(),
        a.ptrs([new_vals[n] for n in names]), new_bucket.data_ptr(), sp_ts.data_ptr(),
        sp_keys.data_ptr(), sp_used.data_ptr(), a.ptrs([sp_vals[n] for n in names]),
        spill_n.data_ptr(), scratch.data_ptr(), ovf.data_ptr(), kernels.stream()), what)
    kernels.launches[what] += 1
    new_state = {"keys": new_keys, "used": new_used, "vals": new_vals, "bucket": new_bucket,
                 "spill": {"ts": sp_ts, "keys": sp_keys, "used": sp_used, "vals": sp_vals},
                 "spill_n": spill_n}
    return new_state, ovf


def agg_find_merge(state: dict, n_stores: int, per: int, ops: dict):
    """The in-flight stores of a find merged into one (K45): the stores
    0 .. n_stores - 1 (finest .. `per`), each with an open bucket, folded in
    order into an empty store through `_merge_into`, its bucket the first
    open one's start aligned to `per` (-1 if none is open).

    state: `agg_step`'s stores; per: the duration code of `per`
    returns ({"keys": [G], "used": [G], "vals": {base: [G]}, "bucket": 0-d},
    overflow). One block (csrc/aggregation.cu `agg_find`)."""
    if state["keys"].device.type == "cpu":
        return agg_find_merge_ref(state, n_stores, per, ops)
    what = "agg_find_merge"
    n_dur = state["keys"].shape[0]
    g = _check(what, state, ops, n_dur)
    if not 1 <= n_stores <= n_dur:
        raise ValueError(f"{what}: {n_stores} stores of {n_dur}")
    _check(what, state, ops, n_dur, (per,))
    kernels.require_cuda(what, state["keys"], state["used"], state["bucket"],
                         *state["vals"].values())
    dev, vals = state["keys"].device, state["vals"]
    out = {"keys": torch.empty(g, dtype=torch.int64, device=dev),
           "used": torch.empty(g, dtype=torch.bool, device=dev),
           "vals": {n: torch.empty(g, dtype=v.dtype, device=dev) for n, v in vals.items()},
           "bucket": torch.empty((), dtype=torch.int64, device=dev)}
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    a = _Args()
    nb, op_arr, type_arr, names = _bases(a, ops, vals)
    init = _init_arr(a, ops, vals)
    kernels.check(kernels.function("agg_find")(
        g, n_stores, per, nb, op_arr, type_arr, init, state["keys"].data_ptr(),
        state["used"].data_ptr(), a.ptrs([vals[n] for n in names]), state["bucket"].data_ptr(),
        out["keys"].data_ptr(), out["used"].data_ptr(), a.ptrs([out["vals"][n] for n in names]),
        out["bucket"].data_ptr(), ovf.data_ptr(), kernels.stream()), what)
    kernels.launches[what] += 1
    return out, ovf
