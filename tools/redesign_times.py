"""Times the ring view (K11 `ring_view`, with K48's seq lane at LIN's shape),
the row lists (`partition_rows`, which K31, K32 and K37 share) and the main
path (chip_smoke.py's filter_window_avg and filter_window_minmax apps, fused
and per batch) of one checkout of the port on the card. The kernels are timed
three ways each: `ms` the whole call, `device_ms` its device work alone,
`kernel_ms` torch.profiler's sum of every kernel the call launches; each the
median of five runs. The main path gives events/s, the median of three runs.
The yardstick, the shapes and the inputs are this checkout's chip_smoke.py
(`time_ms`, `device_all_ms`, `device_ms`, `view_timing_rings`,
`rows_timing_batches`, `run_app`), so two checkouts are timed alike on the
same work.

Run on the card from the repository root, once a checkout, in turns (two
checkouts compare only within one call):

    python3 tools/redesign_times.py --root DIR --label parent

It builds the checkout's kernels (its own `kernels.build_all`) and prints one
JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 200


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="the checkout whose port is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the yardstick: this checkout's, whatever --root is

    sys.path.insert(0, os.path.abspath(args.root))  # the port: --root's
    import torch

    if not torch.cuda.is_available():
        print("redesign_times: no card", file=sys.stderr)
        return 1
    from siddhi_tpu_torch import kernels
    from siddhi_tpu_torch.core.windows import ring_view
    from siddhi_tpu_torch.ops.partition import partition_rows

    kernels.build_all()

    def three(fn) -> dict:
        runs = {"ms": [cs.time_ms(torch, fn, REPS) for _ in range(5)],
                "device_ms": [cs.device_all_ms(torch, fn, REPS) for _ in range(5)],
                "kernel_ms": [cs.device_ms(torch, lambda: None, fn, REPS // 4, None)
                              for _ in range(5)]}
        out = {k: float(np.median(v)) for k, v in runs.items()}
        out["ms_runs"] = runs["ms"]  # the whole call, on the host's clock, spreads the most
        return out

    j_ring, t_ring = cs.view_timing_rings(torch, np.random.default_rng(cs.VIEW_SEED), "cuda")
    out = {"label": args.label, "root": args.root, "card": cs.card_line(),
           "J": three(lambda: ring_view(j_ring)),
           "T": three(lambda: ring_view(t_ring)),
           "LIN": three(lambda: ring_view(j_ring, with_seq=True))}
    for label, (bt, slot) in cs.rows_timing_batches(torch, "cuda", 1024).items():
        out[f"rows_{label}"] = three(lambda: partition_rows(bt, slot, 1024))

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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
