"""Times, with `--sets pr21` (the default), K16 (`pattern_scan`) at paths L's
and A's data steps, K37 (`partition_pattern_scan`) at path PPA's data step,
K24 (`table_upsert_scan`) at path TAB-UPSERT's step, and the events/s of
paths L, A, PPA and TAB-UPSERT; in a checkout whose K16 takes its design
steps apart (`core/pattern.py` SCAN_OPT), K16 with each subset of them too.
K16's inputs are chip_smoke.py's `scan_timing_inputs`; K37's and K24's are
the first full-width step of their path, caught by a hook on the wrapper
and timed inside it (the call is pure but for its emission lanes, which
each call rewrites alike). With `--sets pr20` it times the ring view
(K11 `ring_view`, with K48's seq lane at LIN's shape),
the row lists (`partition_rows`, which K31, K32 and K37 share), the keyed
ring view (K38 `partition_ring_view` at path PJ's P=1,024, W=50), K49's fold
(`fold_rows` at SH-KEYS' B=32,768, D=8, given each shard's own lanes: a
checkout whose fold takes them stacked is given them stacked) and its
caller's whole merge (`parallel/mesh.py` `_merge_positional` over the
shards' output batches, the stacks included where a checkout stacks), and
the main path (chip_smoke.py's filter_window_avg and filter_window_minmax
apps, fused and per batch) and paths PJ and SH-KEYS of one checkout of the
port on the card. The kernels are timed three ways each: `ms` the whole
call, `device_ms` its device work alone, `kernel_ms` torch.profiler's sum of
every kernel the call launches; each the median of five runs. The paths
give events/s, the median of three runs. The yardstick, the shapes and the
inputs are this checkout's chip_smoke.py (`time_ms`, `device_all_ms`,
`device_ms`, `view_timing_rings`, `rows_timing_batches`, `keyed_ring`,
`fold_timing_inputs`, `run_app`, `run_streams`, `run_sh`), so two checkouts
are timed alike on the same work.

Run on the card from the repository root, once a checkout, in turns (two
checkouts compare only within one call):

    python3 tools/redesign_times.py --root DIR --label parent [--sets pr21|pr20]

It builds the checkout's kernels (its own `kernels.build_all`) and prints one
JSON line. A slow call is timed fewer times (REPS, down to two a run, about
0.3 s a run).
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 200


def fold_one_buffer(torch, kernels, lanes: dict, owner, valid):
    """`fold_rows`' launch (csrc/keyshard.cu `ks_fold`) with every output
    lane and `valid` carved from one uint8 allocation, 8-byte aligned."""
    import ctypes

    b = owner.shape[0]
    names = list(lanes)
    dtypes = [lanes[n][0].dtype for n in names] + [torch.bool]
    sizes = [torch.empty(0, dtype=dt).element_size() for dt in dtypes]
    offs, at = [], 0
    for sz in sizes:
        offs.append(at)
        at += -(-b * sz // 8) * 8
    buf = torch.empty(at, dtype=torch.uint8, device=owner.device)
    outs = [buf[o:o + b * sz].view(dt) for o, sz, dt in zip(offs, sizes, dtypes)]
    table = [x.data_ptr() for n in names for x in lanes[n]] + [v.data_ptr() for v in valid]
    args = [x.data_ptr() for x in outs[:-1]] + sizes[:-1] + table
    c_args = (ctypes.c_longlong * len(args))(*args)
    kernels.check(kernels.function("ks_fold")(
        len(names), len(valid), b, ctypes.addressof(c_args), owner.data_ptr(),
        outs[-1].data_ptr(), None, kernels.stream()), "fold_rows")
    return dict(zip(names, outs[:-1])), outs[-1]


def caught(module, name: str, when, timed) -> dict:
    """Runs `timed(fn, args, kwargs)` inside the first call of module.name
    whose arguments satisfy `when(args)`; returns what it gave ({} until
    then). The hook stays until restored by the caller."""
    orig = getattr(module, name)
    got = {}

    def hook(*a, **kw):
        r = orig(*a, **kw)
        if not got and when(a):
            got.update(timed(orig, a, kw))
        return r

    setattr(module, name, hook)
    return got


def pr21_times(cs, torch, three) -> dict:
    """K16 at L's and A's data steps (each subset of its design steps where
    the checkout has them), K37 at PPA's data step, K24 at TAB-UPSERT's step,
    and paths L, A, PPA and TAB-UPSERT's events/s (medians of 3)."""
    from siddhi_tpu_torch.core import pattern as PM
    from siddhi_tpu_torch.core import pattern_runtime
    from siddhi_tpu_torch.ops import table as TK

    out = {}
    steps = cs.scan_timing_inputs(torch, "cuda")
    opts = (7, 0, 1, 2, 4, 3, 5) if hasattr(PM, "SCAN_OPT") else (None,)
    for label, call in steps.items():
        for opt in opts:
            if opt is not None:
                PM.SCAN_OPT = opt
            key = f"K16_{label}" + ("" if opt in (None, 7) else f"_opt{opt}")
            out[key] = three(call)
            print(f"{key}: {out[key]['ms']:.4f} ms", flush=True)
        if opt is not None:
            PM.SCAN_OPT = 7
    b = cs.MAIN_BATCH

    # path L: 1,000,000 events fused, calls of 8 batches (the first of 4)
    data = cs.stock_data(cs.LOGICAL_EVENTS, seed=7)
    app = cs.LOGICAL_APP.format(batch=b)
    cs.run_app("cuda", app, data, 4 * b, 2 * b, 2 * b)  # warm-up
    runs = [cs.LOGICAL_EVENTS / cs.run_app("cuda", app, data, cs.LOGICAL_EVENTS, 8 * b, 4 * b)[2]
            for _ in range(3)]
    out["path_L"] = {"events_per_s": float(np.median(runs)), "runs": runs}
    # path A: ABSENT_BATCHES batches under playback, one a call, with their TIMER steps
    n = cs.ABSENT_BATCHES * b
    data = cs.stock_data(n, seed=7)
    app = cs.ABSENT_APP.format(batch=b)
    cs.run_app("cuda", app, data, 2 * b, b, b, fused=False)  # warm-up
    runs = [n / cs.run_app("cuda", app, data, n, b, b, fused=False)[2] for _ in range(3)]
    out["path_A"] = {"events_per_s": float(np.median(runs)), "runs": runs}
    # path PPA, and K37 at its first full-width data step
    data, names = cs.pp_data(cs.PP_EVENTS)
    app = cs.partition_pattern_app("PPA", b, cs.PT_CAP)
    got = caught(pattern_runtime, "partition_pattern_scan",
                 lambda a: a[3].shape[0] == b and bool((a[4] == 0).any()),
                 lambda fn, a, kw: {"K37_PPA": three(lambda: fn(*a, **kw))})
    try:
        cs.run_app("cuda", app, data, b, b, b, fused=False, symbols=names)  # warm-up
    finally:
        pattern_runtime.partition_pattern_scan = PM.partition_pattern_scan
    out.update(got)
    n = cs.PPA_BATCHES * b
    runs = [n / cs.run_app("cuda", app, data, n, b, b, fused=False, symbols=names)[2]
            for _ in range(3)]
    out["path_PPA"] = {"events_per_s": float(np.median(runs)), "runs": runs}
    # path TAB-UPSERT, and K24 at its first step (the table half full)
    orig = TK.table_upsert_scan
    got = caught(TK, "table_upsert_scan",
                 lambda a: a[3].shape[0] == cs.TAB_BATCH,
                 lambda fn, a, kw: {"K24_TAB-UPSERT": three(lambda: fn(*a, **kw))})
    try:
        cs.run_table_path("cuda", "TAB-UPSERT", cs.TAB_N["TAB-UPSERT"], cs.TAB_BATCH, 2)
    finally:
        TK.table_upsert_scan = orig
    out.update(got)
    runs = []
    for _ in range(3):
        r = cs.run_table_path("cuda", "TAB-UPSERT", cs.TAB_N["TAB-UPSERT"], cs.TAB_BATCH,
                              cs.TAB_BATCHES)
        runs.append(cs.TAB_BATCH * cs.TAB_BATCHES / r["seconds"])
    out["path_TAB-UPSERT"] = {"events_per_s": float(np.median(runs)), "runs": runs}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="the checkout whose port is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--sets", default="pr21", help="pr21 (K16, K37, K24 and their paths) or "
                    "pr20 (K11, the row lists, K38, K49's fold and their paths)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the yardstick: this checkout's, whatever --root is

    sys.path.insert(0, os.path.abspath(args.root))  # the port: --root's
    import torch

    if not torch.cuda.is_available():
        print("redesign_times: no card", file=sys.stderr)
        return 1
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.event import EventBatch
    from siddhi_tpu_torch.core.windows import ring_view
    from siddhi_tpu_torch.ops.partition import partition_ring_view, partition_rows
    from siddhi_tpu_torch.parallel import keyshard, mesh

    kernels.build_all()

    def kernel_ms(fn, reps):
        # torch.profiler records no device time now and then on the card:
        # such a run counts for nothing
        try:
            return cs.device_ms(torch, lambda: None, fn, reps, None)
        except AssertionError:
            return None

    def three(fn) -> dict:
        reps = max(2, min(REPS, int(300 / max(cs.time_ms(torch, fn, 1), 1e-3))))
        runs = {"ms": [cs.time_ms(torch, fn, reps) for _ in range(5)],
                "device_ms": [cs.device_all_ms(torch, fn, reps) for _ in range(5)]}
        runs["kernel_ms"] = [x for x in (kernel_ms(fn, max(1, reps // 4)) for _ in range(5))
                             if x is not None]
        out = {k: float(np.median(v)) if v else None for k, v in runs.items()}
        out["ms_runs"] = runs["ms"]  # the whole call, on the host's clock, spreads the most
        return out

    out = {"label": args.label, "root": args.root, "card": cs.card_line()}
    if args.sets == "pr21":
        out.update(pr21_times(cs, torch, three))
        print(json.dumps(out), flush=True)
        return 0
    j_ring, t_ring = cs.view_timing_rings(torch, np.random.default_rng(cs.VIEW_SEED), "cuda")
    out.update({
           "J": three(lambda: ring_view(j_ring)),
           "T": three(lambda: ring_view(t_ring)),
           "LIN": three(lambda: ring_view(j_ring, with_seq=True))})
    for label, (bt, slot) in cs.rows_timing_batches(torch, "cuda", 1024).items():
        out[f"rows_{label}"] = three(lambda: partition_rows(bt, slot, 1024))
    pj_ring = cs.keyed_ring(torch, np.random.default_rng(cs.PJ_VIEW_SEED), "cuda", cs.PT_CAP,
                            cs.PJ_W)
    out["K38"] = three(lambda: partition_ring_view(pj_ring))
    lanes, valid, owner = cs.fold_timing_inputs(torch, "cuda")
    if not hasattr(keyshard, "_FOLD_TABLE_BY_VALUE"):  # a fold of [D, B] stacks
        lanes = {k: torch.stack(v) for k, v in lanes.items()}
        valid = torch.stack(valid)
    out["fold"] = three(lambda: keyshard.fold_rows(lanes, owner, valid))
    if hasattr(keyshard, "_FOLD_TABLE_BY_VALUE"):
        # the same launch with the outputs carved from one allocation: the
        # wrapper keeps the faster of the two layouts
        out["fold_one_buffer"] = three(lambda: fold_one_buffer(torch, kernels, lanes, owner,
                                                               valid))
    shards = cs.fold_timing_inputs(torch, "cuda")
    outs = [EventBatch(ts=shards[0]["n"][d], kind=shards[0]["symbol"][d].to(torch.int8),
                       valid=shards[1][d], cols={k: v[d] for k, v in shards[0].items()})
            for d in range(cs.SH_SHARDS)]
    out["merge"] = three(lambda: mesh._merge_positional(outs, shards[2]))

    b, data = cs.MAIN_BATCH, cs.stock_data(cs.MAIN_EVENTS, seed=7)
    cs.run_app("cuda", cs.main_app(cs.MINMAX), data, 4 * b, 2 * b, 2 * b)  # warm-up
    for name, extra in (("filter_window_avg", ""), ("filter_window_minmax", cs.MINMAX)):
        app = cs.main_app(extra)
        fused = [cs.MAIN_EVENTS / cs.run_app("cuda", app, data, cs.MAIN_EVENTS, 8 * b, 4 * b)[2]
                 for _ in range(3)]
        per_batch = [20 * b / cs.run_app("cuda", app, data, 20 * b, 8 * b, 4 * b,
                                         fused=False)[2] for _ in range(3)]
        out[name] = {"events_per_s": float(np.median(fused)), "runs": fused,
                     "per_batch_events_per_s": float(np.median(per_batch)),
                     "per_batch_runs": per_batch}

    # path PJ: PJ_CALLS calls of a batch a stream, events over both streams
    trades, names = cs.pp_data(cs.PJ_CALLS * b)
    quotes = cs.stock_data(cs.PJ_CALLS * b, seed=8)
    quotes["symbol"] = np.random.default_rng(8).integers(
        1, cs.PT_SYMBOLS + 1, size=cs.PJ_CALLS * b).astype(np.int32)
    app = cs.partition_join_app("PJ", b, cs.PT_CAP)
    feeds = [("Trades", trades), ("Quotes", quotes)]
    cs.run_streams("cuda", app, feeds, b, 1, names)  # warm-up
    pj = [2 * cs.PJ_CALLS * b / cs.run_streams("cuda", app, feeds, b, cs.PJ_CALLS, names)[2]
          for _ in range(3)]
    out["PJ"] = {"events_per_s": float(np.median(pj)), "runs": pj}
    # path SH-KEYS: 8 shards on the card, SH_BATCHES calls of a batch
    data, names = cs.sh_data(cs.SH_BATCHES * b)
    os.environ["XLA_FLAGS"] = cs.SH_FLAG
    keys = cs.SH_KEYS_APP.format(batch=b, head="{head}").replace("{head}", cs.sh_head("keys"))
    calls = [(i * b, (i + 1) * b) for i in range(cs.SH_BATCHES)]
    cs.run_sh("cuda", keys, data, names, calls[:1])  # warm-up
    sh = [cs.SH_BATCHES * b / sum(cs.run_sh("cuda", keys, data, names, calls)["seconds"])
          for _ in range(3)]
    out["SH-KEYS"] = {"events_per_s": float(np.median(sh)), "runs": sh}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
