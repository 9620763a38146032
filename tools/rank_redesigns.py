"""Ranks the port's kernels for the next redesign from a run of chip_smoke.py:
each kernel's launches on its path times the gap between its time and its
bound (ms - bound_ms), the largest first, and the ratio of its time to the
library call's where chip_smoke.py times one.

    python3 tools/rank_redesigns.py [chiprun_out/chip_smoke.json]

Reads the JSON chip_smoke.py writes (its "kernels" table and "card" line)
and prints one line a kernel.
"""

import json
import sys


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/chip_smoke.json"
    with open(path) as f:
        run = json.load(f)
    print(run["card"])
    rows = []
    for k in run["kernels"]:
        gap = k["launches"] * (k["ms"] - k["bound_ms"])
        lib = k["library_ms"]
        rows.append((gap, k["name"], k["launches"], k["ms"], k["bound_ms"],
                     None if not lib else k["ms"] / lib))
    for gap, name, n, ms, bound, ratio in sorted(rows, reverse=True):
        vs = "" if ratio is None else f" {ratio:.2f}x the library call"
        print(f"{name}: {n} launches x ({ms:.4f} - {bound:.6f}) ms = {gap:.1f} ms{vs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
