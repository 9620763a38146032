"""Build, load and count the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers) and is
compiled at first use with `nvcc` for Hopper (`sm_90a`) into a shared library
under `_build/`, named by a hash of its source and of the headers `csrc/*.cuh`
(the block scan and gather the sources share, the table programs'
interpreter, the radix sort of K22, K46 and the row lists) so an edited
kernel is rebuilt.
`build_all()` starts one `nvcc` per source, all at once. The libraries are
loaded with `ctypes`; every pointer and the stream travel as `c_void_p`, and
each entry point returns its `cudaError_t`, which `check()` turns into an
exception (`sw_slot_bytes` and the `RESTYPES` sizes excepted).

`launches` counts, per kernel wrapper, the calls that launched the kernel on
the card (plain-version calls on CPU tensors do not count).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "_build"
SOURCES = ("length_window", "running_sum", "window_extreme", "wire_decode", "deliver_pack",
           "batch_window", "group_assign", "keyed_running_sum", "keep_last", "time_window",
           "ring_view", "join_probe", "pattern_advance", "pattern_count", "pattern_emit",
           "pattern_scan", "running_extreme", "distinct_count", "table_write", "table_index",
           "table_match", "table_scan", "special_window", "partition_window",
           "partition_time", "partition_batch", "partition_pattern", "partition_join",
           "aggregation", "mix_keys", "order_limit", "keyshard", "shard_route")

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
_GATHER = [P, P, P, P, I, I, P]
_RUNNING_SUM = [P] * 7 + [I, P]
_EXTREME = [P, P, P, P, I, I, I, LL, P]
_EXTREME_KEYED = [P] * 6 + [I, I, I, LL, P]
_RUNNING_EXTREME = [P] * 8 + [I, I, P]
_KEYED_EXTREME = [P] * 6 + [I, I, I] + [P] * 8 + [P]
_DISTINCT = [P] * 6 + [I, I, I] + [P] * 11 + [P]
_BW_GATHER = [P] * 5 + [I, I, P]
_KEYED_SUM = [P] * 5 + [I, I] + [P] * 6 + [P]
_RV_GATHER = [P, P, P, I, P]
_JP_PARTNER = [P, P, LL, P, I, I, P]
_PW_EXTREME = [P] * 7 + [I] * 4 + [LL, P]
_PB_GATHER = [P] * 5 + [I, I, I, P]
# C entry points: name -> (source, argtypes). The last argument is the stream.
SIGNATURES = {
    "lw_prepare": ("length_window", [P] * 5 + [I, I] + [P] * 12 + [P]),
    "lw_gather_1": ("length_window", _GATHER),
    "lw_gather_4": ("length_window", _GATHER),
    "lw_gather_8": ("length_window", _GATHER),
    "running_sum_f32": ("running_sum", _RUNNING_SUM),
    "running_sum_i64": ("running_sum", _RUNNING_SUM),
    "window_extreme_f32": ("window_extreme", _EXTREME),
    "window_extreme_i32": ("window_extreme", _EXTREME),
    "window_extreme_i64": ("window_extreme", _EXTREME),
    "window_extreme_keyed_f32": ("window_extreme", _EXTREME_KEYED),
    "window_extreme_keyed_i32": ("window_extreme", _EXTREME_KEYED),
    "window_extreme_keyed_i64": ("window_extreme", _EXTREME_KEYED),
    "wire_decode": ("wire_decode", [P, P, P, I, LL, I, I, P, P, P, P, P, P]),
    "deliver_pack": ("deliver_pack", [P, I, I, I, P, P, P, I, I, P, P, P, P, P]),
    "bw_prepare": ("batch_window", [P] * 6 + [I] * 4 + [P] * 17 + [P]),
    "bw_gather_1": ("batch_window", _BW_GATHER),
    "bw_gather_4": ("batch_window", _BW_GATHER),
    "bw_gather_8": ("batch_window", _BW_GATHER),
    "group_assign": ("group_assign", [P] * 6 + [I] * 4 + [P] * 15 + [P]),
    "keyed_running_sum_f32": ("keyed_running_sum", _KEYED_SUM),
    "keyed_running_sum_i64": ("keyed_running_sum", _KEYED_SUM),
    "keep_last": ("keep_last", [P, P, P, I, P, P, P]),
    "tw_prepare": ("time_window", [P] * 7 + [I, I, I, LL] + [P] * 21 + [P]),
    "rv_view": ("ring_view", [P, P, I, P, I, P, P, P, P, P, P]),
    "rv_gather_1": ("ring_view", _RV_GATHER),
    "rv_gather_4": ("ring_view", _RV_GATHER),
    "rv_gather_8": ("ring_view", _RV_GATHER),
    "jp_compact": ("join_probe", [P, P, I, I, I, I] + [P] * 7 + [P]),
    "jp_partner_1": ("join_probe", _JP_PARTNER),
    "jp_partner_4": ("join_probe", _JP_PARTNER),
    "jp_partner_8": ("join_probe", _JP_PARTNER),
    "pa_step": ("pattern_advance", [P] * 9 + [LL, LL] + [I] * 7 + [LL] + [P] * 10 + [I] + [P] * 4
                + [P]),
    "pc_step": ("pattern_count", [P] * 9 + [I] * 8 + [P] * 10 + [I] + [P] * 7 + [P]),
    "pe_emit": ("pattern_emit", [P] * 4 + [I, I, P, P, I] + [P] * 3 + [I] + [P] * 4 + [I, P, I, P, I]
                + [P] * 4 + [P]),
    "ps_scan": ("pattern_scan", [P, I, I, I, I] + [P] * 13 + [I] + [P] * 9 + [P] * 4 + [I, P]
                + [P, P, I] + [P] * 5 + [I, I, P]),
    "tb_prepare": ("batch_window", [P] * 10 + [I, I, I, I, LL, I, LL, I, LL] + [P] * 20 + [P]),
    "running_extreme_f32": ("running_extreme", _RUNNING_EXTREME),
    "running_extreme_i32": ("running_extreme", _RUNNING_EXTREME),
    "running_extreme_i64": ("running_extreme", _RUNNING_EXTREME),
    "keyed_running_extreme_f32": ("running_extreme", _KEYED_EXTREME),
    "keyed_running_extreme_i32": ("running_extreme", _KEYED_EXTREME),
    "keyed_running_extreme_i64": ("running_extreme", _KEYED_EXTREME),
    "distinct_count_f32": ("distinct_count", _DISTINCT),
    "distinct_count_i32": ("distinct_count", _DISTINCT),
    "distinct_count_i64": ("distinct_count", _DISTINCT),
    "distinct_count_b8": ("distinct_count", _DISTINCT),
    "tw_insert": ("table_write", [P, I, I, P, I] + [P] * 6 + [I] + [P] * 10),
    "ti_build": ("table_index", [P, I, P, I] + [P] * 5),
    "ti_build_workspace": ("table_index", [I]),
    "ti_probe": ("table_index", [P, I, P, P, P, I, P, P, I, P, I, P, P, P]),
    "tm_match": ("table_match", [P, I, I, P, P, I, P, P, P, P, P, I, I, I, P, P]),
    "tsc_scan": ("table_scan", [I, P, P, P, P, I, I, P, P, I, P, P, P, I, I, I, I, P, I, I]
                 + [P] * 8 + [I, P]),
    "tsc_workspace": ("table_scan", [I, I]),
    "sw_sort": ("special_window", [I] * 3 + [P] * 21 + [P]),
    "sw_frequent": ("special_window", [I, I] + [P] * 18 + [P]),
    "sw_lossy": ("special_window", [I, I, LL, ctypes.c_float] + [P] * 22 + [P]),
    "sw_cron": ("special_window", [I, I] + [P] * 18 + [P]),
    "sw_gather": ("special_window", [I] + [P] * 6 + [I, I, I, P]),
    "sw_slot_bytes": ("special_window", [I, I, I]),
    "pw_rank": ("partition_window", [P] * 4 + [I] * 3 + [P] * 10 + [P]),
    "pw_emit": ("partition_window", [P] * 4 + [I] * 3 + [P] * 17 + [P]),
    "pw_gather_1": ("partition_window", _GATHER),
    "pw_gather_4": ("partition_window", _GATHER),
    "pw_gather_8": ("partition_window", _GATHER),
    "pw_extreme_f32": ("partition_window", _PW_EXTREME),
    "pw_extreme_i32": ("partition_window", _PW_EXTREME),
    "pw_extreme_i64": ("partition_window", _PW_EXTREME),
    "pt_rows": ("partition_time", [P] * 3 + [I, I] + [P] * 7 + [P]),
    "pt_rows_workspace": ("partition_time", [I, I]),
    "pt_step": ("partition_time", [P] * 4 + [I, I, I, LL] + [P] * 16 + [P]),
    "pt_place": ("partition_time", [I] + [P] * 6 + [P]),
    "pt_emit": ("partition_time", [P, P, I, I, I, I] + [P] * 19 + [P]),
    "pt_gather_1": ("partition_time", _GATHER),
    "pt_gather_4": ("partition_time", _GATHER),
    "pt_gather_8": ("partition_time", _GATHER),
    "pb_step": ("partition_batch", [I] * 8 + [LL] * 3 + [P] * 23 + [P]),
    "pb_place": ("partition_batch", [I] + [P] * 6 + [P]),
    "pb_emit": ("partition_batch", [P] * 4 + [I] * 6 + [P] * 18 + [P]),
    "pb_gather_1": ("partition_batch", _PB_GATHER),
    "pb_gather_4": ("partition_batch", _PB_GATHER),
    "pb_gather_8": ("partition_batch", _PB_GATHER),
    "pg_assign": ("group_assign", [P] * 7 + [I] * 3 + [P] * 15 + [P]),
    "pps_scan": ("pattern_scan", [P, I, I, I, I] + [P] * 13 + [I] + [P] * 9 + [P] * 4 + [I, P]
                 + [P, P, I] + [P, P, I, I] + [P] * 9 + [I, P]),
    "pp_chunks": ("partition_pattern", [P, P, I, I, I] + [P] * 7 + [P]),
    "pp_advance": ("partition_pattern", [P] * 8 + [LL, LL] + [I] * 8 + [LL] + [P] * 5 + [I]
                   + [P] * 2 + [I] + [P] * 4 + [P]),
    "pp_count": ("partition_pattern", [P] * 10 + [I] * 9 + [P] * 5 + [I] + [P] * 2 + [I] + [P] * 6
                 + [P]),
    "pp_emit": ("partition_pattern", [P] * 4 + [I, I, P, I, I] + [P] * 7 + [I, P, I] + [P] * 5
                + [I, P, I] + [P] * 4 + [P]),
    "pp_place": ("partition_pattern", [I] + [P] * 8 + [P]),
    "pp_place_rows": ("partition_pattern", [I, I] + [P] * 8 + [P]),
    "pp_gather": ("partition_pattern", [P, P, P, I, I, I, P]),
    "pj_view": ("partition_join", [P, P, I, I, P, I, P, P, P]),
    "pj_plan": ("partition_join", [P] * 3 + [I] * 5 + [P] * 13 + [P]),
    "pj_fill": ("partition_join", [P] * 3 + [I] * 6 + [P] * 9 + [P]),
    "sw_psort": ("special_window", [I] * 5 + [P] * 22 + [P]),
    "sw_pfrequent": ("special_window", [I] * 4 + [P] * 19 + [P]),
    "sw_plossy": ("special_window", [I, I, I, LL, ctypes.c_float] + [P] * 23 + [P]),
    "sw_pcron": ("special_window", [I, I] + [P] * 23 + [P]),
    "agg_step": ("aggregation", [I] * 4 + [P] * 24 + [P]),
    "agg_find": ("aggregation", [I] * 4 + [P] * 12 + [P]),
    "mk_mix": ("mix_keys", [I, I] + [P] * 8 + [I] * 8 + [P, P]),
    "ol_order": ("order_limit", [I] * 6 + [P] * 2 + [P] * 8 + [P] * 3 + [P]),
    "ol_workspace": ("order_limit", [I] * 4),
    "ks_owner": ("keyshard", [P, I, I, P, P]),
    "ks_fold": ("keyshard", [I, I, I, P, P, P, P, P]),
    "sr_route": ("shard_route", [I, I, I, P, P, P, I, P, P, P, P, P, P, P]),
}

# entry points that return a size (long long) instead of a cudaError_t
RESTYPES = {"ti_build_workspace": LL, "ol_workspace": LL, "pt_rows_workspace": LL,
            "tsc_workspace": LL}

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # included by the sources
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def nvcc_command(src: Path, out: Path, *extra: str) -> list[str]:
    """The nvcc command line that builds one source into a shared library
    for Hopper (`extra`: further flags)."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", *extra, "-o", str(out), str(src)]


def build_all() -> float:
    """Compile every source whose library is missing, one `nvcc` process per
    source, all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD.mkdir(exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = _lib_path(source)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for fn, (src, argtypes) in SIGNATURES.items():
                if src == source:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = RESTYPES.get(fn, I)
            _libs[source] = lib
        return lib


def function(name: str):
    """The ctypes entry point `name` (building its library at first use)."""
    return getattr(_library(SIGNATURES[name][0]), name)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the card and is contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
