"""Keyed (group-by) batch reductions and the device group-slot assignment.

The reference keeps one aggregator-state object per group key in a HashMap
(reference: query/selector/GroupByKeyGenerator.java,
GroupByAggregationAttributeExecutor.java). Here group state is a
fixed-capacity `[G]` array indexed by a slot, and the slot comes from a probe
of a persistent int64 key table.

The JAX package groups a batch's rows with one sort by (active, reset era,
key, row) and runs every keyed reduction as a segmented scan over that
sorted view. The port keeps only what the downstream reductions need from
that view: `Groups.first`, each active row's segment id, which is the first
row of its (era, key). Any grouping of the rows by (active, era, key) that is
stable by row gives the same results, so the card builds it with no sort
(a hash table of row indices, csrc/group_assign.cu).

Six hand-written CUDA kernels run on the card:
- `assign_slots` (csrc/group_assign.cu, K7), and inside a partition
  `partition_assign_slots` (the same source, K33: P tables of G, one a
  partition);
- `keyed_running_sum` (csrc/keyed_running_sum.cu, K8);
- `keyed_running_extreme` (csrc/running_extreme.cu, K19);
- `keep_last` behind `keep_last_in_sorted` / `keep_last_per_group`
  (csrc/keep_last.cu, K9);
- `mix_keys`, the composite group key (csrc/mix_keys.cu, K47).
Each `*_ref` beside them is its plain PyTorch version, which the wrapper
takes only for tensors on the CPU. The JAX package's `permute_by` (a
payload sort standing in for a gather on the TPU) has no counterpart: its
callers' kernels gather by index (K7, K9, K17).
"""

from __future__ import annotations

import dataclasses

import torch

from siddhi_tpu_torch import kernels
from siddhi_tpu_torch.core.event import KIND_EXPIRED
from siddhi_tpu_torch.core.types import flush_subnormal
from siddhi_tpu_torch.ops.prefix import (
    add,
    extreme_identity,
    extreme_op,
    last_reset_index,
    segmented_carry,
    segmented_cum_extreme,
    segmented_cumsum,
)
from siddhi_tpu_torch.ops.scatter import set_at

# 64-bit mixing constants (splitmix64 finalizer) for combining composite keys
_MIX1 = -7046029254386353131  # 0x9E3779B97F4A7C15 as signed
_MIX2 = -4658895280553007687  # 0xBF58476D1CE4E5B9 as signed

# kTile / kHash of csrc/keyed_running_sum.cu (kKeyTile / kHash of
# csrc/running_extreme.cu): rows per tile, and slots per tile table
_SUM_TILE = 512
_SUM_HASH = 1024


# csrc/mix_keys.cu's column type codes, and its most columns
_KEY_CODE = {torch.int32: 0, torch.int64: 1, torch.bool: 2, torch.float32: 3}
_MAX_KEY_COLS = 8


def _widen(c: torch.Tensor) -> torch.Tensor:
    """A key column as int64: a float32 by its int32 bits (as the callers'
    `_as_key_col` encodes floats), anything else by value."""
    if c.dtype == torch.float32:
        return c.contiguous().view(torch.int32).to(torch.int64)
    return c.to(torch.int64)


def mix_keys_ref(cols: list[torch.Tensor]) -> torch.Tensor:
    """Plain version of `mix_keys`: the JAX package's splitmix64 rounds
    (wrapping int64 multiply, arithmetic right shift)."""
    if len(cols) == 1:
        return _widen(cols[0])
    h = torch.zeros_like(torch.broadcast_tensors(*cols)[0], dtype=torch.int64)
    for c in cols:
        h = (h ^ _widen(c)) * _MIX1
        h = (h ^ (h >> 29)) * _MIX2
    return h


def mix_keys(cols: list[torch.Tensor]) -> torch.Tensor:
    """Combine one or more integer-encoded key columns (int32, int64, bool,
    or float32 by its bits; broadcast to one shape) into one int64 key.

    A single column passes through unchanged; composite keys are mixed with
    the JAX package's splitmix64 rounds, bit for bit: K47 on the card."""
    if len(cols) == 1 or cols[0].device.type == "cpu":
        return mix_keys_ref(cols)
    if len(cols) > _MAX_KEY_COLS or any(c.dtype not in _KEY_CODE for c in cols):
        raise ValueError(f"mix_keys: at most {_MAX_KEY_COLS} int32/int64/bool/float32 "
                         f"columns, got {[c.dtype for c in cols]}")
    cols = [c.contiguous() for c in torch.broadcast_tensors(*cols)]
    kernels.require_cuda("mix_keys", *cols)
    out = torch.empty(cols[0].shape, dtype=torch.int64, device=cols[0].device)
    n = out.numel()
    pad = _MAX_KEY_COLS - len(cols)
    kernels.check(kernels.function("mk_mix")(
        n, len(cols), *[c.data_ptr() for c in cols], *[None] * pad,
        *[_KEY_CODE[c.dtype] for c in cols], *[0] * pad, out.data_ptr(), kernels.stream()),
        "mix_keys")
    kernels.launches["mix_keys"] += 1
    return out


@dataclasses.dataclass
class Groups:
    """A batch's rows grouped by (active, reset era, key), stable by row.

    first:  [rows] int32 — for an active row, the first row of its
            (era, key); an inactive row is a group of its own (first = row)
    bounds: [2] int32 — the first and the last RESET row (rows and -1 when
            there is none)
    """

    first: torch.Tensor
    bounds: torch.Tensor


def _reset_bounds(reset: torch.Tensor) -> torch.Tensor:
    rows = reset.shape[0]
    idx = torch.arange(rows, dtype=torch.int32, device=reset.device)
    fr = torch.where(reset, idx, rows).min()
    lr = torch.where(reset, idx, -1).max()
    return torch.stack([fr, lr]).to(torch.int32)


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by keys[0], then keys[1], ...,
    stable by row (successive stable sorts, least significant key first)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def assign_slots_ref(table_keys, used, n_used, batch_keys, active, reset):
    """Plain version of `assign_slots`, in the JAX package's formulation:
    a stable sort by (inactive, era, key), the segment heads carried across
    each segment, a [rows, G] equality probe of the old table, allocation
    ranks by cumsum, and scatter-sets of the new table."""
    g = table_keys.shape[0]
    b = batch_keys.shape[0]
    dev = batch_keys.device
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    glr = torch.where(reset, idx, -1).max()
    any_reset = glr >= 0
    post = idx > glr
    era = torch.cumsum(reset.to(torch.int32), 0, dtype=torch.int32)

    inact = (~active).to(torch.int32)
    perm = _stable_order(inact, era, batch_keys)
    sk, se, sa = batch_keys[perm], era[perm], inact[perm]
    seg_start = torch.ones(b, dtype=torch.bool, device=dev)
    seg_start[1:] = (sk[1:] != sk[:-1]) | (se[1:] != se[:-1]) | (sa[1:] != sa[:-1])
    first = torch.empty(b, dtype=torch.int32, device=dev)
    first[perm] = segmented_carry(perm.to(torch.int32), seg_start)
    first = torch.where(active, first, idx)

    eq = used[None, :] & (table_keys[None, :] == batch_keys[:, None])  # [rows, G]
    in_t = eq.any(dim=1) & active
    t_slot = eq.to(torch.uint8).argmax(dim=1).to(torch.int32)

    fl = first.long()
    is_alloc = active & ~in_t & (first == idx)
    ia = is_alloc.to(torch.int32)
    alloc_rank = torch.cumsum(ia, 0, dtype=torch.int32) - ia
    slot_new = n_used + alloc_rank
    old_overflow = (torch.where(is_alloc, slot_new, 0) >= g).any()
    sn_first = slot_new[fl]
    old_slot = torch.where(in_t, t_slot, torch.where(sn_first < g, sn_first, g))

    post_active = active & post
    is_alloc_f = post_active & (first == idx)
    iaf = is_alloc_f.to(torch.int32)
    rank_f = torch.cumsum(iaf, 0, dtype=torch.int32) - iaf
    fresh_overflow = (torch.where(is_alloc_f, rank_f, 0) >= g).any()
    rf_first = rank_f[fl]
    fresh_slot = torch.where(post_active & (rf_first < g), rf_first, g)

    slot = torch.where(any_reset & post, fresh_slot, old_slot)
    slot = torch.where(active, slot, g).to(torch.int32)
    overflow = torch.where(any_reset, fresh_overflow, old_overflow)

    ones = torch.ones((), dtype=torch.bool, device=dev)
    scatter_old = torch.where(is_alloc & (slot_new < g) & ~any_reset, slot_new, g)
    keys_old = set_at(table_keys, scatter_old, batch_keys)
    used_old = set_at(used, scatter_old, ones)
    n_old = torch.clamp(n_used + ia.sum(dtype=torch.int32), max=g)
    scatter_f = torch.where(is_alloc_f & (rank_f < g) & any_reset, rank_f, g)
    keys_f = set_at(torch.zeros_like(table_keys), scatter_f, batch_keys)
    used_f = set_at(torch.zeros_like(used), scatter_f, ones)
    n_f = torch.clamp(iaf.sum(dtype=torch.int32), max=g)

    new_keys = torch.where(any_reset, keys_f, keys_old)
    new_used = torch.where(any_reset, used_f, used_old)
    new_n = torch.where(any_reset, n_f, n_old).to(torch.int32)
    return new_keys, new_used, new_n, slot, Groups(first, _reset_bounds(reset)), overflow


def assign_slots(table_keys, used, n_used, batch_keys, active, reset):
    """Map each active row to a stable slot in [0, G); allocate new slots in
    first-appearance order. Inactive rows get slot == G (the dead lane).

    table_keys [G] int64, used [G] bool, n_used 0-d int32: the persistent
    key table; batch_keys [rows] int64, active [rows] bool, reset [rows]
    bool. A RESET kills every group's carry: rows after the batch's last
    reset allocate into a fresh table; rows before it resolve against the
    old one (allocation ranks count first appearances in every era, so a
    pre-reset row may get a slot of a table that is never written — the JAX
    package's exact behaviour). Keys beyond capacity get the dead lane and
    raise the overflow flag.

    Returns (new_keys, new_used, new_n, slot [rows] int32, Groups,
    overflow 0-d bool); nothing is read back to the host.
    """
    if batch_keys.device.type == "cpu":
        return assign_slots_ref(table_keys, used, n_used, batch_keys, active, reset)
    kernels.require_cuda("assign_slots", table_keys, used, n_used, batch_keys, active, reset)
    g, rows = table_keys.shape[0], batch_keys.shape[0]
    if (
        table_keys.dtype != torch.int64 or used.shape != (g,) or used.dtype != torch.bool
        or n_used.shape != () or n_used.dtype != torch.int32
        or batch_keys.dtype != torch.int64 or batch_keys.dim() != 1
        or active.shape != (rows,) or active.dtype != torch.bool
        or reset.shape != (rows,) or reset.dtype != torch.bool
        or not 0 < g < 2**30 or not 0 < rows < 2**29
    ):
        raise ValueError(
            "assign_slots takes a [G] int64 table, [G] bool used, 0-d int32 n_used and "
            f"[rows] int64 keys / bool active / bool reset; got {table_keys.dtype}"
            f"{list(table_keys.shape)}, {batch_keys.dtype}{list(batch_keys.shape)}"
        )
    dev = batch_keys.device
    hsize = 1024
    while hsize < 2 * rows:
        hsize *= 2
    tsize = 16
    while tsize < 2 * g:
        tsize *= 2

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    new_keys = torch.empty_like(table_keys)
    new_used = torch.empty_like(used)
    new_n = torch.empty_like(n_used)
    slot, first, bounds = i32(rows), i32(rows), i32(2)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    era, hpos, tslot, rank_a, rank_f = i32(rows), i32(rows), i32(rows), i32(rows), i32(rows)
    flags = torch.empty(rows, dtype=torch.int8, device=dev)
    row_hash, tab_hash = i32(hsize), i32(tsize)
    err = kernels.function("group_assign")(
        table_keys.data_ptr(), used.data_ptr(), n_used.data_ptr(), batch_keys.data_ptr(),
        active.data_ptr(), reset.data_ptr(), g, rows, hsize, tsize,
        new_keys.data_ptr(), new_used.data_ptr(), new_n.data_ptr(), slot.data_ptr(),
        first.data_ptr(), bounds.data_ptr(), overflow.data_ptr(), era.data_ptr(),
        hpos.data_ptr(), tslot.data_ptr(), flags.data_ptr(), rank_a.data_ptr(),
        rank_f.data_ptr(), row_hash.data_ptr(), tab_hash.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "assign_slots")
    kernels.launches["assign_slots"] += 1
    return new_keys, new_used, new_n, slot, Groups(first, bounds), overflow


def _sorted_view(grp: Groups):
    """(order, seg_start): rows sorted by segment id, stable by row."""
    order = torch.sort(grp.first, stable=True).indices
    sf = grp.first[order]
    seg_start = torch.ones_like(sf, dtype=torch.bool)
    seg_start[1:] = sf[1:] != sf[:-1]
    return order, seg_start


def keyed_running_sum_ref(contrib, grp: Groups, reset, carry, slot):
    """Plain version of `keyed_running_sum`: a segmented scan over the rows
    sorted by segment, the carry gathered where no reset came before, and
    the segment ends of the final era written into the new carry; float32
    contributions and sums with subnormals as zeros (XLA's CPU code)."""
    g = carry.shape[0]
    rows = contrib.shape[0]
    order, seg_start = _sorted_view(grp)
    run_s = segmented_cumsum(flush_subnormal(contrib)[order], seg_start)
    run = torch.empty_like(run_s)
    run[order] = run_s
    lr = last_reset_index(reset)
    zero = torch.zeros((), dtype=carry.dtype, device=carry.device)
    sl = slot.clamp(0, g - 1).long()
    gathered = torch.where(slot < g, carry[sl], zero)
    run = add(run, torch.where(lr < 0, gathered, zero))

    glr = lr[-1]
    post = torch.arange(rows, dtype=torch.int32, device=contrib.device) > glr
    base = torch.where(reset.any(), torch.zeros_like(carry), carry)
    seg_end = torch.ones_like(seg_start)
    seg_end[:-1] = seg_start[1:]
    slot_s, post_s = slot[order], post[order]
    writer = seg_end & post_s & (slot_s < g)
    base_s = torch.where(slot_s < g, base[slot_s.clamp(0, g - 1).long()], zero)
    newval = add(base_s, run_s).to(carry.dtype)
    new_carry = set_at(base, torch.where(writer, slot_s, g), newval)
    return run, new_carry


def keyed_running_sum(contrib, grp: Groups, reset, carry, slot):
    """Per-row running sum within each (era, key) group; returns
    ([rows] run, [G] new carry).

    contrib: [rows] float32/int64 (0 on inactive rows); grp, slot: from
    `assign_slots` over the same rows and reset lane; carry: [G], same
    dtype. A row's value adds its group's carry when no reset came before
    it; the new carry is written by the one row that ends each group of the
    final era (the base is zeroed when the batch holds a reset).
    """
    if contrib.device.type == "cpu":
        return keyed_running_sum_ref(contrib, grp, reset, carry, slot)
    kernels.require_cuda("keyed_running_sum", contrib, grp.first, grp.bounds, reset, carry, slot)
    rows, g = contrib.shape[0], carry.shape[0]
    suffix = {torch.float32: "f32", torch.int64: "i64"}.get(contrib.dtype)
    if (
        suffix is None or contrib.dim() != 1 or rows == 0 or carry.dtype != contrib.dtype
        or carry.dim() != 1 or g == 0 or grp.first.shape != (rows,)
        or grp.first.dtype != torch.int32 or grp.bounds.shape != (2,)
        or slot.shape != (rows,) or slot.dtype != torch.int32 or rows >= 2**30
    ):
        raise ValueError(
            "keyed_running_sum takes [rows] float32/int64 contrib, a [G] carry of the "
            f"same dtype and [rows] int32 segment ids and slots; got {contrib.dtype}"
            f"{list(contrib.shape)}, {carry.dtype}{list(carry.shape)}"
        )
    dev = contrib.device
    tiles = -(-rows // _SUM_TILE)
    run = torch.empty_like(contrib)
    new_carry = torch.empty_like(carry)
    part = torch.empty_like(contrib)
    seg_last = torch.empty(rows, dtype=torch.int32, device=dev)
    tab_key = torch.empty(tiles * _SUM_HASH, dtype=torch.int32, device=dev)
    tab_val = torch.empty(tiles * _SUM_HASH, dtype=contrib.dtype, device=dev)
    err = kernels.function(f"keyed_running_sum_{suffix}")(
        contrib.data_ptr(), grp.first.data_ptr(), grp.bounds.data_ptr(), carry.data_ptr(),
        slot.data_ptr(), rows, g, run.data_ptr(), new_carry.data_ptr(), part.data_ptr(),
        seg_last.data_ptr(), tab_key.data_ptr(), tab_val.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "keyed_running_sum")
    kernels.launches["keyed_running_sum"] += 1
    return run, new_carry


def keyed_running_extreme_ref(values, active, grp: Groups, reset, carry, slot, is_min):
    """Plain version of `keyed_running_extreme`: the JAX package's keyed
    running min/max over the rows sorted by segment, the carry folded in
    where no reset came before, and the final era's segment ends written
    into the new carry; a float32 subnormal value reads as a zero of its
    sign (XLA's CPU code)."""
    g = carry.shape[0]
    rows = values.shape[0]
    ident = extreme_identity(values.dtype, is_min).to(values.device)
    op = extreme_op(values.dtype, is_min)
    masked = torch.where(active, flush_subnormal(values), ident)
    order, seg_start = _sorted_view(grp)
    run_s = segmented_cum_extreme(masked[order], seg_start, is_min)
    run = torch.empty_like(run_s)
    run[order] = run_s
    lr = last_reset_index(reset)
    sl = slot.clamp(0, g - 1).long()
    run = op(run, torch.where((slot < g) & (lr < 0), flush_subnormal(carry)[sl], ident))

    post = torch.arange(rows, dtype=torch.int32, device=values.device) > lr[-1]
    base = torch.where(reset.any(), ident.expand(g), carry)
    seg_end = torch.ones_like(seg_start)
    seg_end[:-1] = seg_start[1:]
    slot_s, post_s = slot[order], post[order]
    writer = seg_end & post_s & (slot_s < g)
    # one slot may end several segments when `reset` omits the resets the
    # segments split at (the forever forms): the last in order writes, as
    # the JAX package's scatter keeps it
    at = torch.arange(rows, device=values.device)
    last = torch.full((g + 1,), -1, dtype=torch.int64, device=values.device).scatter_reduce(
        0, torch.where(writer, slot_s, g).long(), at, reduce="amax")
    writer = writer & (last[slot_s.clamp(0, g).long()] == at)
    base_s = torch.where(slot_s < g, flush_subnormal(base)[slot_s.clamp(0, g - 1).long()], ident)
    new_carry = set_at(base, torch.where(writer, slot_s, g), op(base_s, run_s))
    return run, new_carry


def keyed_running_extreme(values, active, grp: Groups, reset, carry, slot, is_min: bool):
    """Per-row running min/max within each (era, key) group (no removal);
    returns ([rows] run, [G] new carry).

    values: [rows] float32/int32/int64; active: [rows] bool (valid CURRENT
    rows; the others read as the identity); grp, slot: from `assign_slots`
    over the rows (their segments may split at resets that `reset` omits:
    the forever forms zero it); carry: [G], same dtype. As
    `keyed_running_sum`, with min/max for the sum and the identity for zero;
    NaN propagates. Where one slot ends several final-era segments, the
    latest one writes its carry.
    """
    if values.device.type == "cpu":
        return keyed_running_extreme_ref(values, active, grp, reset, carry, slot, is_min)
    kernels.require_cuda("keyed_running_extreme", values, active, grp.first, reset, carry,
                         slot)
    rows, g = values.shape[0], carry.shape[0]
    suffix = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64"}.get(values.dtype)
    if (
        suffix is None or values.dim() != 1 or rows == 0 or carry.dtype != values.dtype
        or carry.dim() != 1 or g == 0 or grp.first.shape != (rows,)
        or grp.first.dtype != torch.int32 or reset.shape != (rows,)
        or reset.dtype != torch.bool or active.shape != (rows,) or active.dtype != torch.bool
        or slot.shape != (rows,) or slot.dtype != torch.int32 or rows >= 2**30
    ):
        raise ValueError(
            "keyed_running_extreme takes [rows] float32/int32/int64 values, [rows] bool "
            f"active, a [G] carry of the same dtype and [rows] int32 segment ids and slots; "
            f"got {values.dtype}{list(values.shape)}, {carry.dtype}{list(carry.shape)}"
        )
    dev = values.device
    tiles = -(-rows // _SUM_TILE)
    run = torch.empty_like(values)
    new_carry = torch.empty_like(carry)
    part = torch.empty_like(values)
    seg_last = torch.empty(rows, dtype=torch.int32, device=dev)
    tab_key = torch.empty(tiles * _SUM_HASH, dtype=torch.int32, device=dev)
    tab_val = torch.empty(tiles * _SUM_HASH, dtype=values.dtype, device=dev)
    slot_win = torch.empty(g, dtype=torch.int32, device=dev)
    bounds = torch.empty(2, dtype=torch.int32, device=dev)
    err = kernels.function(f"keyed_running_extreme_{suffix}")(
        values.data_ptr(), active.data_ptr(), grp.first.data_ptr(), reset.data_ptr(),
        carry.data_ptr(), slot.data_ptr(), rows, g, int(is_min), run.data_ptr(),
        new_carry.data_ptr(), part.data_ptr(), seg_last.data_ptr(), tab_key.data_ptr(),
        tab_val.data_ptr(), slot_win.data_ptr(), bounds.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "keyed_running_extreme")
    kernels.launches["keyed_running_extreme"] += 1
    return run, new_carry


def keep_last_ref(ids: torch.Tensor, kind_bit: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain version of `keep_last`, as the JAX package forms it: sort by
    (id, kind bit), stable by row; a reverse segmented max of the valid
    rows' indices; back to row order and compare."""
    rows = ids.shape[0]
    idx = torch.arange(rows, dtype=torch.int32, device=ids.device)
    key = ids.to(torch.int64) * 2 + kind_bit.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    seg_end = torch.ones(rows, dtype=torch.bool, device=ids.device)
    seg_end[:-1] = sk[1:] != sk[:-1]
    marked = torch.where(valid[order], order.to(torch.int32), -1)
    last_s = segmented_cum_extreme(marked.flip(0), seg_end.flip(0), is_min=False).flip(0)
    last = torch.empty_like(last_s)
    last[order] = last_s
    return valid & (last == idx)


def keep_last(ids: torch.Tensor, kind_bit: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[rows] bool: the valid rows that are the last valid row of their
    (id, kind bit). ids: [rows] int32 in [0, rows]; kind_bit: [rows] bool."""
    if ids.device.type == "cpu":
        return keep_last_ref(ids, kind_bit, valid)
    kernels.require_cuda("keep_last", ids, kind_bit, valid)
    rows = ids.shape[0]
    if (
        ids.dtype != torch.int32 or ids.dim() != 1 or rows == 0 or rows >= 2**29
        or kind_bit.shape != (rows,) or kind_bit.dtype != torch.bool
        or valid.shape != (rows,) or valid.dtype != torch.bool
    ):
        raise ValueError("keep_last takes [rows] int32 ids in [0, rows] and [rows] bool lanes")
    out = torch.empty_like(valid)
    scratch = torch.empty(2 * (rows + 1), dtype=torch.int32, device=ids.device)
    err = kernels.function("keep_last")(
        ids.data_ptr(), kind_bit.data_ptr(), valid.data_ptr(), rows, scratch.data_ptr(),
        out.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "keep_last")
    kernels.launches["keep_last"] += 1
    return out


def keep_last_in_sorted(grp: Groups, kind: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[rows] bool: valid rows that are the LAST valid row of their
    (group, kind) — the batch-mode group-by collapse. `valid` must be
    pre-masked to CURRENT|EXPIRED rows."""
    return keep_last(grp.first, kind == KIND_EXPIRED, valid)


def keep_last_per_group(seg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[rows] bool: valid rows that are the LAST valid row of their `seg`
    value (seg: [rows] int32 in [0, rows]) — the ungrouped batch collapse."""
    return keep_last(seg.to(torch.int32), torch.zeros_like(valid), valid)



def partition_assign_slots_ref(table_keys, used, n_used, batch_keys, active, reset, pslot,
                               p: int):
    """Plain version of `partition_assign_slots`: `assign_slots_ref` once
    per partition on the rows of that partition (its active and RESET rows,
    in row order), as the JAX package's vmap runs `assign_slots` per
    partition under a mask."""
    g = table_keys.shape[1]
    rows = batch_keys.shape[0]
    dev = batch_keys.device
    new_keys, new_used, new_n = table_keys.clone(), used.clone(), n_used.clone()
    slot = torch.full((rows,), g, dtype=torch.int32, device=dev)
    first = torch.arange(rows, dtype=torch.int32, device=dev)
    overflow = torch.zeros(p, dtype=torch.bool, device=dev)
    member = (active | reset) & (pslot >= 0) & (pslot < p)
    for q in torch.unique(pslot[member]).tolist():
        r = torch.nonzero(member & (pslot == q)).flatten()
        nk, nu, nn, s, grp, ovf = assign_slots_ref(table_keys[q], used[q], n_used[q],
                                                   batch_keys[r], active[r], reset[r])
        new_keys[q], new_used[q], new_n[q], overflow[q] = nk, nu, nn, ovf
        slot[r] = s
        first[r] = r[grp.first.long()].to(torch.int32)
    return new_keys, new_used, new_n, slot, first, overflow


def partition_assign_slots(table_keys, used, n_used, batch_keys, active, reset, pslot, p: int):
    """`assign_slots` in P independent tables, one a partition: each row
    of partition pslot[r] in [0, P) takes a slot of its partition's [G]
    table, allocating in its partition's own first-appearance order, with
    its partition's own RESET eras and overflow at G.

    table_keys [P, G] int64, used [P, G] bool, n_used [P] int32: the
    tables; batch_keys [rows] int64, active / reset [rows] bool, pslot
    [rows] int32 (P: no partition). Returns (new_keys, new_used, new_n,
    slot [rows] int32 (G: dead lane), first [rows] int32 (each active row's
    first row of its (partition, era, key), the row itself otherwise),
    overflow [P] bool); nothing is read back to the host."""
    if batch_keys.device.type == "cpu":
        return partition_assign_slots_ref(table_keys, used, n_used, batch_keys, active, reset,
                                          pslot, p)
    kernels.require_cuda("partition_assign_slots", table_keys, used, n_used, batch_keys, active,
                         reset, pslot)
    g, rows = table_keys.shape[-1], batch_keys.shape[0]
    if (
        table_keys.shape != (p, g) or table_keys.dtype != torch.int64
        or used.shape != (p, g) or used.dtype != torch.bool
        or n_used.shape != (p,) or n_used.dtype != torch.int32
        or batch_keys.dtype != torch.int64 or batch_keys.dim() != 1
        or any(x.shape != (rows,) for x in (active, reset, pslot))
        or active.dtype != torch.bool or reset.dtype != torch.bool
        or pslot.dtype != torch.int32 or not 0 < g < 2**30 or not 0 < rows < 2**29 or p < 1
    ):
        raise ValueError(
            "partition_assign_slots takes [P, G] int64 keys / bool used, [P] int32 counts and "
            f"[rows] int64 keys, bool active / reset, int32 partition slots; got "
            f"{table_keys.dtype}{list(table_keys.shape)}, {batch_keys.dtype}"
            f"{list(batch_keys.shape)}, P {p}")
    dev = batch_keys.device

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    new_keys, new_used, new_n = torch.empty_like(table_keys), torch.empty_like(used), \
        torch.empty_like(n_used)
    slot, first = i32(rows), i32(rows)
    overflow = torch.empty(p, dtype=torch.bool, device=dev)
    rank, rowlist, part_start, counters, tslot = i32(rows), i32(rows), i32(p + 1), i32(p + 1), \
        i32(rows)
    hsize = 2 * rows + p
    hrow, hera, halloc_a, halloc_f = i32(hsize), i32(hsize), i32(hsize), i32(hsize)
    err = kernels.function("pg_assign")(
        table_keys.data_ptr(), used.data_ptr(), n_used.data_ptr(), batch_keys.data_ptr(),
        active.data_ptr(), reset.data_ptr(), pslot.data_ptr(), p, g, rows, rank.data_ptr(),
        rowlist.data_ptr(), part_start.data_ptr(), counters.data_ptr(), new_keys.data_ptr(),
        new_used.data_ptr(), new_n.data_ptr(), slot.data_ptr(), first.data_ptr(),
        overflow.data_ptr(), tslot.data_ptr(), hrow.data_ptr(), hera.data_ptr(),
        halloc_a.data_ptr(), halloc_f.data_ptr(), kernels.stream())
    kernels.check(err, "partition_assign_slots")
    kernels.launches["partition_assign_slots"] += 1
    return new_keys, new_used, new_n, slot, first, overflow
