"""Carry query state and interned strings in and out of the engine as numpy.

A query's state is a tree of dicts and lists whose leaves are arrays:
`{"chain": ..., "sel": {"aggs": [...], "group": {"keys", "used", "n"}}}`
for a single-stream query and `{"join": {"l": ..., "r": ...}, "sel": ...}`
for a join, `{"tok": {"active", "slot", "start_ts", "entry_ts", "caps": [{"n",
"ts", "cols"}, ...], "fwd"}, "sel": ..., "timer_ts"}` for a pattern (its token
table, one capture entry per state ref, "fwd" only for a sequence with a
count state; "timer_ts" the max TIMER timestamp processed), where "chain"
and each join side is a
sliding window's ring
(`{"cols": {...}, "ts", "wts", "seq", "total"}`: length, time, timeLength
and externalTime alike; a time ring may hold holes, seq -1), a batch
window's buffers (`{"cur_cols", "cur_ts", "cur_n", "prev_cols", "prev_ts",
"prev_n", "bucket_start", "timeout_deadline"}`: lengthBatch, timeBatch and
externalTimeBatch alike; the time-driven two use the open bucket's start
and the idle deadline), `{}` for a join side without a window, or `()` for
a chain without one; "group" is the group-by key table. Each aggregator's
entry in "aggs" is its carry: a scalar for sum/count, `{"sum", "count"}`
for avg, `{"sum", "sumsq", "count"}` for stdDev, the running extreme for
min/max (the unused identity under a window) and an unused scalar for
distinctCount; each carry gains a leading [G] axis under a group-by (but
distinctCount's). A table's state (`runtime.tables[id].state`) is
`{"cols": {...}, "ts", "valid", "seq", "next"}` with, per indexed column,
`"ix_order.<col>"`, `"ix_sorted.<col>"` and `"ix_dups.<col>"`.
The special windows' "chain" is `{"cols": {...}, "ts", "occ", "seq",
"next"}` for sort, `{"cols": {...}, "ts", "occ", "key", "cnt"}` for
frequent (cnt int32), the same with int64 cnt plus "bucket" and "total" for
lossyFrequent, and `{"cur_cols", "cur_ts", "cur_n", "prev_cols", "prev_ts",
"prev_n"}` for cron.
The JAX engine (`siddhi_tpu`) keeps the same layout, so a state
taken there as numpy maps onto this engine leaf for leaf with dtype and
shape unchanged. A rate limiter's buffered rows and counters are host
state of the same shape in both engines (`rate_limiter_state`,
`load_rate_limiter_state`). Pending timers are host state and do not
travel. A partition's queries keep their state [P]-tiled in both engines
(every leaf gains a leading [P] axis: rings [P, W], totals and carries
[P]); `partition_state_from_jax` takes a JAX partition block's key table
and its queries' states. An aggregation's stores are a list of one dict a
duration in the JAX engine and stacked [D, ...] lanes here
(`aggregation_state_from_jax`). Under `@app:shard` a key-sharded group-by's
state gains a leading [D] device axis in both engines
(`keyshard_state_from_jax`), and a sharded partitioned query's [P] state
keeps the mesh's block layout (`sharded_partition_state_from_jax`).
"""

from __future__ import annotations

import copy
from typing import Any, Sequence

import numpy as np
import torch

from siddhi_tpu_torch.core.types import InternTable


def state_from_numpy(tree: Any, device) -> Any:
    """numpy tree -> the same tree of torch tensors on `device` (exact copy)."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    arr = np.array(tree, copy=True)  # owns its memory, writable
    return torch.from_numpy(arr).to(device)


def state_to_numpy(tree: Any) -> Any:
    """Tree of torch tensors -> the same tree of numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def interned_values(interner: InternTable) -> list:
    """The id table: element i is the value interned as id i (0 = null)."""
    return [interner.lookup(i) for i in range(len(interner))]


def load_interned(interner: InternTable, values: Sequence) -> None:
    """Intern `values` (an id table, element 0 = null) so each keeps its id.
    The interner must hold no ids beyond those it shares with `values`."""
    for i, v in enumerate(values[1:], start=1):
        got = interner.intern(v)
        if got != i:
            raise ValueError(
                f"interned value {v!r} has id {got} here but {i} in the table"
            )


def rate_limiter_state(limiter) -> dict:
    """A query's rate limiter's buffered or held `(ts, kind, data, key)` rows
    and its counters (`query.rate_limiter`, either engine), copied."""
    return copy.deepcopy(vars(limiter))


def load_rate_limiter_state(limiter, state: dict) -> None:
    """Give `limiter` the rows and counters `rate_limiter_state` took from a
    limiter of the same kind."""
    if set(state) != set(vars(limiter)):
        raise ValueError(f"rate limiter state {sorted(state)} does not fit "
                         f"{type(limiter).__name__} {sorted(vars(limiter))}")
    for k, v in copy.deepcopy(state).items():
        setattr(limiter, k, v)


def partition_state_from_jax(ptable: dict, states: dict, device) -> tuple:
    """A JAX `PartitionRuntime`'s key table (`{"keys": [P] int64, "used":
    [P] bool, "n": int32}`) and its `PartitionedQueryRuntime` states by
    query id (the [P]-tiled trees), as numpy, turned into this engine's:
    `(ptable, {query id: state})` for `PartitionRuntime.ptable` and each
    query's `state`. A partitioned pattern's state is its `{"tok", "sel",
    "timer_ts"}` with the [P] axis on every leaf (token lanes [P, T],
    captures [P, T, K], clocks [P]); a partitioned join's is `{"join":
    {"l", "r"}, "sel"}`, each side's window lanes [P, W] (`{}` for a side
    without one); a sort or frequent window's lanes are [P, N] ("next"
    [P]). The keyed step indexes the same [P] axis by slot, so every leaf
    keeps its dtype and shape."""
    return (state_from_numpy(ptable, device),
            {qid: state_from_numpy(st, device) for qid, st in states.items()})


def aggregation_state_from_jax(state: dict, device) -> dict:
    """A JAX `AggregationRuntime.state` as numpy (`{"stores": [D x {"keys":
    [G], "used", "vals": {base: [G]}, "bucket": 0-d}], "spill": [D x {"ts":
    [S], "keys": [S, G], "used", "vals"}], "spill_n": [D x 0-d int32]}`) in
    this engine's stacked layout: `{"keys": [D, G], "used", "vals": {base:
    [D, G]}, "bucket": [D], "spill": {"ts": [D, S], "keys": [D, S, G],
    "used", "vals"}, "spill_n": [D]}`. A duration table's state is a
    table's (`runtime.tables["<id>_<DURATION>"].state`)."""
    stores, spill = state["stores"], state["spill"]

    def stack(items, leaf):
        return np.stack([np.asarray(leaf(x)) for x in items])

    return state_from_numpy({
        "keys": stack(stores, lambda x: x["keys"]),
        "used": stack(stores, lambda x: x["used"]),
        "vals": {b: stack(stores, lambda x, _b=b: x["vals"][_b]) for b in stores[0]["vals"]},
        "bucket": stack(stores, lambda x: x["bucket"]),
        "spill": {"ts": stack(spill, lambda x: x["ts"]),
                  "keys": stack(spill, lambda x: x["keys"]),
                  "used": stack(spill, lambda x: x["used"]),
                  "vals": {b: stack(spill, lambda x, _b=b: x["vals"][_b])
                           for b in spill[0]["vals"]}},
        "spill_n": stack(state["spill_n"], lambda x: x),
    }, device)


def keyshard_state_from_jax(state: dict, device) -> dict:
    """A JAX `KeyShardedGroupExec` query's state as numpy (every leaf of the
    unsharded `{"chain", "sel"}` tree with a leading [D] device axis: group
    tables [D, G], aggregator carries [D, G]) as this engine's
    `KeyShardedGroupExec` state: the same layout, leaf for leaf."""
    return state_from_numpy(state, device)


def sharded_partition_state_from_jax(ptable: dict, state: dict, device) -> tuple:
    """A JAX `ShardedPartitionedQuery`'s key table and [P] state as numpy
    (`sq._ptable`, `sq.state`) as this engine's `(ptable, state)` for
    `parallel.mesh.shard_partitioned_query(..., ptable=, state=)`: the same
    block layout, the routed step's striped one included (state row
    d * P/D + l holds slot l * D + d)."""
    return state_from_numpy(ptable, device), state_from_numpy(state, device)
