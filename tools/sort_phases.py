"""Where the time of the port's grid radix sort goes, on the card.

`siddhi_tpu_torch/csrc/radix_sort.cuh` sorts above 2,048 rows in one
cooperative launch whose phases are separated by grid barriers. This script
builds copies of `csrc/order_limit.cu` (K46) and `csrc/table_index.cu` (K22's
build) with timestamps (`%globaltimer`, ns) taken by each block's thread 0 at
the phase edges, and runs them at the shapes `chip_smoke.py` times:

  K46 at path NW's board (32,768 rows, `v desc, venue`), K46 with one int64
  key of every byte (32,768 rows), K22's build of phase 2's table (10^6
  slots half empty, stale keys up to 2^40) and of 131,073 slots of it.

For each case: the device ms (torch.profiler, every kernel of the call)
and, over the blocks, the latest
time (us from the earliest start) past: 1 the encode's barrier, 2 the
counts' barrier, then per pass k at 3 + 4k the tile's loads, 4 + 4k its ranks,
5 + 4k its look-back, 6 + 4k its write-out (a block's first tile). The
stamped builds' outputs are held against the plain versions.

    python3 tools/sort_phases.py

needs a card and `nvcc`; prints one line a case and writes
chiprun_out/sort_phases.json.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from siddhi_tpu_torch import kernels  # noqa: E402
from siddhi_tpu_torch.core import selector as S  # noqa: E402
from siddhi_tpu_torch.ops import table as K  # noqa: E402

OUT = ROOT / "siddhi_tpu_torch" / "_build" / "phases"
STAMP = ('if (threadIdx.x == 0{cond}) {{ unsigned long long _t; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(_t)); '
         'g_stamp[blockIdx.x * 64 + ({idx})] = _t; }}')
PASS = "(k < 14 ? k : 14)"


def _insert(src: str, anchor: str, text: str, after: bool = True) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"sort_phases: anchor not found once: {anchor!r}")
    return src.replace(anchor, anchor + text if after else text + anchor)


def stamped_header(src: str) -> str:
    """radix_sort.cuh with the phase stamps."""
    any_block = STAMP.replace("{cond}", "")
    first_tile = STAMP.replace("{cond}", " && tile == (int)blockIdx.x")
    src = _insert(src, "namespace cg = cooperative_groups;\n",
                  "__device__ unsigned long long g_stamp[1024 * 64];\n")
    row0 = "  const int row0 = blockIdx.x * kSortThreads, row_step = G * kSortThreads;\n"
    src = _insert(src, row0, "  " + any_block.format(idx=0) + "\n")
    src = _insert(src, "  grid.sync();\n\n  // 2. the pass list", "").replace(
        "  grid.sync();\n\n  // 2. the pass list",
        "  grid.sync();\n  " + any_block.format(idx=1) + "\n\n  // 2. the pass list")
    src = _insert(src, "  // 3. the passes", "  " + any_block.format(idx=2) + "\n", after=False)
    src = _insert(src, "      tile_rank<kSortThreads, kSortIPT>(d, pos, s.u.t, &cnt);\n",
                  "      " + first_tile.format(idx=f"4 + 4 * {PASS}") + "\n")
    src = _insert(src, "      tile_rank<kSortThreads, kSortIPT>(d, pos, s.u.t, &cnt);\n",
                  "      " + first_tile.format(idx=f"3 + 4 * {PASS}") + "\n", after=False)
    src = _insert(src, "      s.gofs[tid] = dbase + prefix - s.u.t.dstart[tid];\n",
                  "      " + first_tile.format(idx=f"5 + 4 * {PASS}") + "\n")
    src = _insert(src, "    if (!last) {\n      dbase =",
                  "    { const int tile = blockIdx.x; "
                  + first_tile.format(idx=f"6 + 4 * {PASS}") + " }\n", after=False)
    return src


def build() -> Path:
    """The two libraries, stamped, built as `kernels.build_all` builds
    them; prints each grid kernel's registers and spills."""
    d = OUT
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kernels.CSRC, d / "csrc")
    h = d / "csrc" / "radix_sort.cuh"
    h.write_text(stamped_header(h.read_text()))
    procs = []
    for name in ("order_limit", "table_index"):
        f = d / "csrc" / f"{name}.cu"
        text = f.read_text()
        text += ('\nextern "C" int stamps_read(void* dst) { return (int)cudaMemcpyFromSymbol('
                 'dst, g_stamp, sizeof(g_stamp)); }\n'
                 'extern "C" int stamps_clear() { static unsigned long long z[1024 * 64]; '
                 'return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z)); }\n')
        f.write_text(text)
        cmd = kernels.nvcc_command(f, d / f"lib{name}.so", "-Xptxas", "-v")
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "grid_kernel" in line and "Compiling" in line:
                facts = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                         if "registers" in x or "spill" in x]
                print(f"{name}: {'; '.join(facts)}", flush=True)
    return d


def use(d: Path) -> None:
    kernels._libs.clear()
    kernels._lib_path = lambda name, d=d: d / f"lib{name}.so"


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call (a CUDA-only profile: every event in it
    is device activity or a runtime call of no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps


def stamps(lib: str, fn) -> dict:
    """One call's stamps: the latest over the blocks of each edge, in us
    from the earliest start."""
    f_clear = kernels._library(lib).stamps_clear
    f_read = kernels._library(lib).stamps_read
    f_read.argtypes = [ctypes.c_void_p]
    torch.cuda.synchronize()
    if f_clear() != 0:
        raise RuntimeError("stamps_clear failed")
    fn()
    torch.cuda.synchronize()
    buf = np.zeros(1024 * 64, np.uint64)
    if f_read(buf.ctypes.data) != 0:
        raise RuntimeError("stamps_read failed")
    t = buf.reshape(1024, 64).astype(np.int64)
    t = t[t[:, 0] > 0]
    t0 = t[:, 0].min()
    edges = {int(i): round(float(t[:, i][t[:, i] > 0].max() - t0) / 1e3, 2)
             for i in range(1, 64) if (t[:, i] > 0).any()}
    return {"blocks": int(len(t)), "edges_us": edges}


def cases():
    rng = np.random.default_rng(7)
    dev = "cuda"
    r = 32768
    v = torch.ones(r, dtype=torch.bool, device=dev)
    board = [torch.from_numpy(rng.integers(1, 40_000, r).astype(np.int64)).to(dev),
             torch.from_numpy(rng.integers(1, 1001, r).astype(np.int32)).to(dev)]
    ev = torch.from_numpy(rng.random(r) < 0.85).to(dev)
    ek = [torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, r, endpoint=True)).to(dev)]
    c = 1_000_000
    valid = np.zeros(c, bool)
    valid[rng.permutation(c)[: c // 2]] = True
    k = np.zeros(c, np.int64)
    k[valid] = np.arange(c // 2)
    k[~valid] = rng.integers(0, 1 << 40, int((~valid).sum()))
    keys, vm = torch.from_numpy(k).to(dev), torch.from_numpy(valid).to(dev)
    k2, v2 = keys[:131_073].clone(), vm[:131_073].clone()
    return {
        "K46 board": ("order_limit", lambda: S.order_limit(v, board, [True, False], 0, 10),
                      lambda: S.order_limit_ref(v.cpu(), [x.cpu() for x in board],
                                                [True, False], 0, 10)),
        "K46 int64 every byte": ("order_limit", lambda: S.order_limit(ev, ek, [False], 0, 10),
                                 None),
        "K22 build 10^6": ("table_index", lambda: K.table_index_build(keys, vm),
                           lambda: K.table_index_build_ref(keys.cpu(), vm.cpu())),
        "K22 build 131,073": ("table_index", lambda: K.table_index_build(k2, v2), None),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("sort_phases: no card", file=sys.stderr)
        return 1
    res = {}
    out = {"card": torch.cuda.get_device_name(0), "cases": res}
    use(build())
    for case, (lib, fn, plain) in cases().items():
        if plain is not None:
            got, want = fn(), plain()
            for g, w in zip(got, want):
                if g is not None and not torch.equal(g.cpu().to(w.dtype), w):
                    raise AssertionError(f"{case}: differs from its plain version")
        res[case] = {"device_ms": device_ms(fn), **stamps(lib, fn)}
        print(f"{case}: {json.dumps(res[case])}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "sort_phases.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
