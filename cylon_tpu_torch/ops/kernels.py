"""Hand-written Hopper kernels of the main path, their plain PyTorch
versions, their launch counters and their build (counterpart of
cylon_tpu.ops.tpu_kernels).

| kernel             | replaces (cylon_tpu/ops/tpu_kernels.py) | source               |
| ------------------ | --------------------------------------- | -------------------- |
| K1 partition_hist  | partition_hist (:1010)                  | csrc/partition.cu    |
| K2 partition_scatter | partition_scatter (:1053)             | csrc/partition.cu    |
| K3 join_plan_stream | join_plan_stream (:317)                | csrc/join_stream.cu  |
| K4 join_expand_stream | join_expand_stream (:706)            | csrc/join_stream.cu  |
| K5 setop_stream    | setop_stream (:544)                     | csrc/setop_stream.cu |
| K6 stream_compact  | stream_compact (:241)                   | csrc/stream_compact.cu |
| K7 segment_sum     | float SUM of cylon_tpu/ops/groupby.py:140 | csrc/segment_sum.cu |
| K8 join_hash_keys  | none: XLA's fusion of cylon_tpu/ops/join.py:598-631 | csrc/join_hash_keys.cu |
| K9 setop_hash_rows | none: XLA's fusion of cylon_tpu/ops/setops.py:183 and cylon_tpu/ops/hash.py:91 | csrc/setop_hash_rows.cu |
| K10 permute_rows   | none: the payload operands of XLA's jax.lax.sort, cylon_tpu/ops/join.py:632, :645 and cylon_tpu/ops/setops.py:239 | csrc/permute_rows.cu |

Each wrapper takes tensors with a leading shard dimension ``[W, n]`` (one
launch covers every shard of the virtual world) and 32-bit streams as
int32 tensors carrying the uint32 bits. On a CPU tensor a wrapper runs
its plain version; on a CUDA tensor it launches its kernel or raises —
there is no fallback. Each launch adds one to ``LAUNCHES[name]``. The
kernel notes in the .cu sources state what bounds each kernel on the
card and what the design does about it.

The sources build at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into shared libraries with a plain C
interface under ``cylon_tpu_torch/_build/`` (named by the hash of the
source and the shared headers, so an edited source rebuilds), loaded with
ctypes. The loader is memoized by ``telemetry.counted_cache``: each build
or load of a library counts once in
``cylon_kernel_factory_builds_total{factory="load_library"}``, and the
fault injector's ``compile`` site fires there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from ..status import Code, CylonError
from ..telemetry.metrics import counted_cache
from .hash import as_i32, hash2_streams
from .order import unsigned

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = {"partition": CSRC / "partition.cu",
           "join_stream": CSRC / "join_stream.cu",
           "setop_stream": CSRC / "setop_stream.cu",
           "stream_compact": CSRC / "stream_compact.cu",
           "segment_sum": CSRC / "segment_sum.cu",
           "join_hash_keys": CSRC / "join_hash_keys.cu",
           "setop_hash_rows": CSRC / "setop_hash_rows.cu",
           "permute_rows": CSRC / "permute_rows.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

PARTITION_TILE = 4096   # rows per K1/K2 tile (csrc/partition.cu TILE)
MAX_SCATTER_LEGS = 32   # K2 legs per pass (csrc/partition.cu MAX_LEGS)
MAX_BUCKETS = 256       # K1/K2 bucket limit (csrc/partition.cu)
PLAN_TILE = 2816        # elements per K3 tile (csrc/join_stream.cu TILE)
EXPAND_TILE = 2048      # outputs per K4 tile (csrc/join_stream.cu EX_TILE)
SETOP_TILE = 2816       # elements per K5 tile (csrc/setop_stream.cu TILE)
MAX_PLAN_LANES = 8      # K3 payload and verify lane limit (join_stream.cu)
COMPACT_TILE = 4096     # elements per K6 tile (csrc/stream_compact.cu TILE)
IDX_MASK = (1 << 29) - 1  # the row index field of a stream tag
MAX_HASH_LANES = 6      # K8 key columns and u32 lanes (join_hash_keys.cu)
MAX_SETOP_LANES = 12    # K9 columns and u32 lanes (setop_hash_rows.cu MAXL)
MAX_ROW_WORDS = 17      # K10 words a row (permute_rows.cu MAXW): the join's
                        # 3 + 6 key lanes + 8 shared lanes

KERNELS = ("partition_hist", "partition_scatter", "join_plan_stream",
           "join_expand_stream", "setop_stream", "stream_compact",
           "segment_sum", "join_hash_keys", "setop_hash_rows",
           "permute_rows")
# launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "partition": {
        "launch_partition_hist": [_P, _P, _I, _L, _I, _I, _P],
        "launch_partition_scatter": [_P, _P, _I, _P, _P, _I, _L, _I, _I, _P,
                                     _P],
    },
    "join_stream": {
        "launch_plan_stream": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _L,
                               _I, _I, _L, _L, _P, _P, _P, _P, _P],
        "launch_join_expand": [_P, _P, _I, _L, _P, _I, _L, _I, _L, _P, _P,
                               _P, _P, _P],
    },
    "setop_stream": {
        "launch_setop_stream": [_P, _P, _P, _I, _I, _L, _I, _I, _P, _P, _P,
                                _P],
    },
    "stream_compact": {
        "launch_stream_compact": [_P, _P, _I, _I, _L, _L, _I, _I,
                                  ctypes.c_uint, _P, _P, _P, _P],
    },
    "segment_sum": {
        "launch_segment_sum": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _L,
                               _L, _P, _P],
    },
    "join_hash_keys": {
        "launch_join_hash_keys": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "setop_hash_rows": {
        "launch_setop_hash_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                   _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "permute_rows": {
        "launch_permute_rows": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _P],
    },
}
# the 64-bit words of a single-pass kernel's tile state: (W, tiles) -> n,
# and (W, tiles, nbuckets) -> n for K2
_STATE_WORDS = {"join_stream": ("plan_state_words", [_I, _I]),
                "setop_stream": ("setop_state_words", [_I, _I]),
                "stream_compact": ("compact_state_words", [_I, _I]),
                "partition": ("scatter_state_words", [_I, _I, _I]),
                "segment_sum": ("sum_state_words", [_I, _L, _I])}


def nvcc_path() -> str:
    """The CUDA compiler, from PATH or the toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise CylonError(Code.ExecutionError,
                     "nvcc not found: the CUDA kernels cannot be built")


# nvcc wall seconds of each library this process built (build())
BUILD_SECONDS: Dict[str, float] = {}


def _lib_path(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(SOURCES[name].read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc per source, all started together. Returns the seconds each
    took (0.0 for one already built). The compiler's report (registers,
    shared memory, spills) goes to ``_build/<name>.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    procs = {}
    t0 = time.perf_counter()
    if todo:
        nvcc = nvcc_path()
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            log = open(BUILD_DIR / f"{n}.log", "w")
            procs[n] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
    seconds = {n: 0.0 for n in names}
    failed = []
    for n, (p, tmp, log) in procs.items():
        rc = p.wait()
        log.close()
        seconds[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(n)
            continue
        os.replace(tmp, _lib_path(n))
        BUILD_SECONDS[n] = seconds[n]
    if failed:
        report = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                           for n in failed)
        raise CylonError(Code.ExecutionError,
                         f"nvcc failed for {failed}:\n{report}")
    return seconds


@counted_cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, its C launchers
    typed. Memoized: one build or load a library a process. The handle
    carries what the compile profiler reads (telemetry/profiler.py):
    ``cylon_library`` (the name), ``cylon_build_s`` (this process's nvcc
    wall for it, 0.0 when it was loaded from ``_build/``) and
    ``cylon_build_log`` (the ``-Xptxas -v`` report of its build)."""
    build([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    lib.cylon_library = name
    lib.cylon_build_s = BUILD_SECONDS.get(name, 0.0)
    lib.cylon_build_log = str(BUILD_DIR / f"{name}.log")
    for fn, args in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    if name in _STATE_WORDS:
        fn, args = _STATE_WORDS[name]
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = ctypes.c_longlong
    return lib


def _launch(lib_name: str, fn: str, *args) -> None:
    """Call a C launcher (it returns cudaGetLastError after the launch)
    and raise on any error."""
    lib = load_library(lib_name)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise CylonError(Code.ExecutionError,
                         f"{fn} failed: CUDA error {rc} ({msg})")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _ptrs(xs: Sequence[Optional[torch.Tensor]]):
    """A C array of the tensors' device pointers (a kernel's lane table;
    None is a null pointer)."""
    return (ctypes.c_void_p * max(len(xs), 1))(*[_ptr(x) for x in xs])


def _ints(vals: Sequence[int]):
    """A C array of ints (a kernel's per-column codes)."""
    return (ctypes.c_int * max(len(vals), 1))(*vals)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(x: torch.Tensor, what: str, dtype=torch.int32,
           shape=None) -> None:
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous() \
            or (shape is not None and x.shape != shape):
        raise CylonError(Code.Invalid,
                         f"{what}: want a contiguous [W, n] {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")


def _check_streams(streams: torch.Tensor, shape, what: str) -> None:
    if streams.dtype != torch.int32 or streams.dim() != 3 \
            or tuple(streams.shape[1:]) != tuple(shape) \
            or not streams.is_contiguous():
        raise CylonError(Code.Invalid,
                         f"{what}: want contiguous int32 [L, W, n] with [W, "
                         f"n] = {list(shape)}, got {tuple(streams.shape)} "
                         f"{streams.dtype}")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    x = x & 0xFFFFFFFF
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# K1 partition_hist
# ---------------------------------------------------------------------------


def _tiles(n: int, tile: int) -> int:
    return max(-(-n // tile), 1)


def plain_partition_hist(t: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """Plain version of K1: int32 [W, tiles, nbuckets], ``out[w, b, k]`` =
    rows of tile b of shard w with id k; ids outside [0, nbuckets) are
    never counted."""
    w, n = t.shape
    tiles = _tiles(n, PARTITION_TILE)
    tl = t.to(torch.int64)
    ok = (tl >= 0) & (tl < nbuckets)
    tile_of = torch.arange(n, device=t.device) // PARTITION_TILE
    dest = torch.where(ok, tile_of * nbuckets + tl, tiles * nbuckets)
    out = torch.zeros(w, tiles * nbuckets + 1, dtype=torch.int64,
                      device=t.device)
    out.scatter_add_(1, dest, torch.ones_like(dest))
    return out[:, :-1].view(w, tiles, nbuckets).to(torch.int32)


def partition_hist(t: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """K1: per-tile bucket histogram of [W, n] int32 target ids (tiles of
    PARTITION_TILE rows). Summed over tiles it is the counts vector, whose
    live buckets are K2's ``counts``. On the card: one launch, a block per
    tile."""
    _check(t, "partition_hist ids")
    if not t.is_cuda:
        return plain_partition_hist(t, nbuckets)
    if not 1 <= nbuckets <= MAX_BUCKETS:
        raise CylonError(Code.Invalid, f"partition_hist takes 1..{MAX_BUCKETS}"
                                       f" buckets, got {nbuckets}")
    w, n = t.shape
    tiles = _tiles(n, PARTITION_TILE)
    out = torch.empty(w, tiles, nbuckets, dtype=torch.int32, device=t.device)
    _launch("partition", "launch_partition_hist", _ptr(t), _ptr(out), w, n,
            tiles, nbuckets, _stream(t))
    LAUNCHES["partition_hist"] += 1
    return out


# ---------------------------------------------------------------------------
# K2 partition_scatter
# ---------------------------------------------------------------------------


def _leg_list(legs, shape, what: str) -> List[torch.Tensor]:
    """K2's legs as a list of [W, n] int32 tensors: a stacked [L, W, n]
    tensor, or a sequence of [W, n] tensors, each checked."""
    if isinstance(legs, torch.Tensor):
        _check_streams(legs, shape, what)
        return list(legs.unbind(0))
    legs = list(legs)
    for i, x in enumerate(legs):
        _check(x, f"{what} {i}", shape=shape)
    return legs


def plain_partition_scatter(t: torch.Tensor, legs, nbuckets: int,
                            counts: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: every leg (a stacked [L, W, n] tensor or a
    sequence of [W, n] tensors) permuted by the stable sort of its
    shard's ids, as one int32 [L, W, n] tensor."""
    del nbuckets, counts  # every id lies in [0, nbuckets)
    legs = _leg_list(legs, t.shape, "partition_scatter legs")
    if not legs:
        return torch.empty(0, *t.shape, dtype=torch.int32, device=t.device)
    stack = torch.stack(legs)
    perm = torch.sort(t, dim=1, stable=True).indices
    return stack.gather(2, perm.unsqueeze(0).expand_as(stack))


def partition_scatter(t: torch.Tensor, legs, nbuckets: int,
                      counts: torch.Tensor) -> torch.Tensor:
    """K2: stable counting scatter of int32 legs into bucket-contiguous
    order by [W, n] ids in [0, nbuckets) — per shard, bit for bit the
    stable sort by id, the last (dead) bucket included. ``legs`` is a
    sequence of [W, n] tensors (read in place) or a stacked [L, W, n]
    tensor; ``counts`` int32 [W, nbuckets - 1] holds each shard's live
    bucket totals (the ids' histogram without its last bucket). Returns
    int32 [L, W, n]. On the card: one memset and one launch (per
    MAX_SCATTER_LEGS legs)."""
    _check(t, "partition_scatter ids")
    legs = _leg_list(legs, t.shape, "partition_scatter legs")
    w, n = t.shape
    _check(counts, "partition_scatter counts", shape=(w, nbuckets - 1))
    if not t.is_cuda:
        return plain_partition_scatter(t, legs, nbuckets, counts)
    if not 1 <= nbuckets <= MAX_BUCKETS:
        raise CylonError(Code.Invalid, f"partition_scatter takes 1.."
                                       f"{MAX_BUCKETS} buckets, got {nbuckets}")
    if any(x.device != t.device for x in [counts, *legs]):
        raise CylonError(Code.Invalid, "partition_scatter: ids, legs and "
                                       "counts must be on one device")
    out = torch.empty(len(legs), w, n, dtype=torch.int32, device=t.device)
    tiles = _tiles(n, PARTITION_TILE)
    lib = load_library("partition")
    state = torch.empty(lib.scatter_state_words(w, tiles, nbuckets),
                        dtype=torch.int64, device=t.device)
    _launch("partition", "launch_partition_scatter", _ptr(t), _ptrs(legs),
            len(legs), _ptr(out), _ptr(counts), w, n, tiles, nbuckets,
            _ptr(state), _stream(t))
    LAUNCHES["partition_scatter"] += 1
    return out


# ---------------------------------------------------------------------------
# K3 join_plan_stream
# ---------------------------------------------------------------------------


def _u(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def plain_join_plan_stream(bits_s, tag_s, na: int, nb: int,
                           emit_unmatched_a: bool, lanes=(),
                           n_a_lanes: Optional[int] = None,
                           n_b_lanes: Optional[int] = None, bits2_s=None,
                           verify_lanes=()):
    """Plain version of K3 (see ``join_plan_stream``): the TPU kernel's
    per-element arithmetic as whole-tensor scans."""
    w, n = bits_s.shape
    dev = bits_s.device
    La = len(lanes) if n_a_lanes is None else n_a_lanes
    Lb = len(lanes) if n_b_lanes is None else n_b_lanes
    tag = _u(tag_s)
    neq = torch.ones(w, n, dtype=torch.bool, device=dev)
    neq[:, 1:] = bits_s[:, 1:] != bits_s[:, :-1]
    if bits2_s is not None:
        neq[:, 1:] |= bits2_s[:, 1:] != bits2_s[:, :-1]
    side = ((tag >> 31) & 1) == 1
    emit = ((tag >> 30) & 1) == 1
    live = ((tag >> 29) & 1) == 1
    idx = tag & ((1 << 29) - 1)
    coll = torch.zeros(w, dtype=torch.int64, device=dev)
    if len(verify_lanes):
        diff = torch.zeros(w, n, dtype=torch.bool, device=dev)
        for v in verify_lanes:
            diff[:, 1:] |= v[:, 1:] != v[:, :-1]
        prev_live = torch.zeros_like(live)
        prev_live[:, 1:] = live[:, :-1]
        coll = ((diff | ~prev_live) & ~neq & live).sum(1)
    ib = (~side & live).to(torch.int64)
    cumb = torch.cumsum(ib, 1)
    headv = torch.where(neq, cumb - ib, 0)
    bb = torch.cummax(headv, 1).values
    eff_m = torch.where(live, cumb - bb, 0)
    if emit_unmatched_a:
        mm = torch.where(side & emit, eff_m.clamp(min=1), 0)
    else:
        mm = torch.where(side & live, eff_m, 0)
    offv = torch.cumsum(mm, 1)
    start = offv - mm
    delta2 = (bb - start) * 2 + (eff_m > 0).to(torch.int64)

    def compact(mask, vals, cap):
        pos = torch.cumsum(mask.to(torch.int64), 1) - 1
        dest = torch.where(mask, pos, cap)
        out = torch.zeros(len(vals), w, cap + 1, dtype=torch.int32,
                          device=dev)
        for o, v in zip(out, vals):
            o.scatter_(1, dest, _wrap32(v.to(torch.int64)))
        return out[:, :, :cap].contiguous()

    a = compact(mm > 0, [idx, delta2, start] + list(lanes[:La]), na)
    b = compact(ib == 1, [idx - na] + list(lanes[:Lb]), nb)
    counts = torch.stack([_wrap32(offv[:, -1]), (mm > 0).sum(1).to(
        torch.int32), ib.sum(1).to(torch.int32), coll.to(torch.int32)], 1)
    return counts, a, b


def join_plan_stream(bits_s: torch.Tensor, tag_s: torch.Tensor, na: int,
                     nb: int, emit_unmatched_a: bool,
                     lanes: Sequence[torch.Tensor] = (),
                     n_a_lanes: Optional[int] = None,
                     n_b_lanes: Optional[int] = None,
                     bits2_s: Optional[torch.Tensor] = None,
                     verify_lanes: Sequence[torch.Tensor] = ()):
    """K3: the join plan over the key-sorted stream, per shard.

    Inputs are int32 [W, n] (n = na + nb) carrying uint32 bits, sorted
    together: ``bits_s`` the key bits (dead rows all-ones), ``tag_s`` the
    packed ``side<<31 | emit<<30 | live<<29 | iota``, ``lanes`` payload
    streams (slot s: probe column s at probe rows, build column s at build
    rows), ``bits2_s`` the second run-boundary stream and
    ``verify_lanes`` the true-key streams of the hash mode.

    Returns (counts int32 [W, 4] = [n_out, n_emit, n_blive,
    n_collisions], a_streams, b_streams): group A (emitting probe rows) =
    (idx, delta2, start, a lanes...) as one int32 [3 + La, W, na] tensor,
    group B (live build rows) = (idx - na, b lanes...) as [1 + Lb, W,
    nb]; entries past their count are unspecified."""
    _check(bits_s, "join_plan_stream bits")
    _check(tag_s, "join_plan_stream tag")
    lanes = list(lanes)
    La = len(lanes) if n_a_lanes is None else n_a_lanes
    Lb = len(lanes) if n_b_lanes is None else n_b_lanes
    w, n = bits_s.shape
    if n != na + nb or n >= (1 << 29):
        raise CylonError(Code.Invalid, f"join_plan_stream: n={n} rows for "
                                       f"na={na}, nb={nb} (< 2^29)")
    if not bits_s.is_cuda:
        return plain_join_plan_stream(bits_s, tag_s, na, nb,
                                      emit_unmatched_a, lanes, La, Lb,
                                      bits2_s, verify_lanes)
    for i, x in enumerate(lanes):
        _check(x, f"join_plan_stream lane {i}", shape=bits_s.shape)
    for i, x in enumerate(verify_lanes):
        _check(x, f"join_plan_stream verify lane {i}", shape=bits_s.shape)
    if bits2_s is not None:
        _check(bits2_s, "join_plan_stream bits2", shape=bits_s.shape)
    if max(len(lanes), len(verify_lanes)) > MAX_PLAN_LANES \
            or max(La, Lb) > len(lanes):
        raise CylonError(Code.Invalid, f"join_plan_stream takes at most "
                         f"{MAX_PLAN_LANES} payload and verify lanes, got "
                         f"{len(lanes)} and {len(verify_lanes)} (La={La}, "
                         f"Lb={Lb})")
    dev = bits_s.device
    tiles = _tiles(n, PLAN_TILE)
    lib = load_library("join_stream")
    state = torch.empty(lib.plan_state_words(w, tiles), dtype=torch.int64,
                        device=dev)
    out_a = torch.empty(3 + La, w, na, dtype=torch.int32, device=dev)
    out_b = torch.empty(1 + Lb, w, nb, dtype=torch.int32, device=dev)
    counts = torch.empty(w, 4, dtype=torch.int32, device=dev)
    _launch("join_stream", "launch_plan_stream", _ptr(bits_s), _ptr(tag_s),
            _ptr(bits2_s), _ptrs(verify_lanes), len(verify_lanes),
            _ptrs(lanes), len(lanes), La, Lb, w, n, tiles,
            int(bool(emit_unmatched_a)), na, nb, _ptr(state), _ptr(out_a),
            _ptr(out_b), _ptr(counts), _stream(bits_s))
    LAUNCHES["join_plan_stream"] += 1
    return counts, out_a, out_b


# ---------------------------------------------------------------------------
# K4 join_expand_stream
# ---------------------------------------------------------------------------


def plain_join_expand_stream(counts, a_streams, b_streams, cap_e: int):
    """Plain version of K4 (see ``join_expand_stream``)."""
    La, Lb = len(a_streams) - 3, len(b_streams) - 1
    w, na = a_streams[0].shape
    nb = b_streams[0].shape[1]
    dev = counts.device
    cnt = counts.to(torch.int64)
    n_out, n_emit = cnt[:, 0:1], cnt[:, 1:2]
    r = torch.arange(na, device=dev)
    s = torch.where(r < n_emit, a_streams[2].to(torch.int64),
                    torch.iinfo(torch.int64).max).contiguous()
    j = torch.arange(cap_e, device=dev).expand(w, cap_e).contiguous()
    cnt_le = torch.searchsorted(s, j, right=True)
    woff = (cnt_le - 1).clamp(0, na - 1)
    d2 = a_streams[1].to(torch.int64).gather(1, woff)
    valid = j < n_out
    bpos = j + (d2 >> 1)
    has = valid & ((d2 & 1) == 1) & (bpos >= 0) & (bpos < nb)
    bsafe = bpos.clamp(0, max(nb - 1, 0))
    aidx = torch.where(valid, a_streams[0].gather(1, woff), -1)
    bidx = torch.where(has, b_streams[0].gather(1, bsafe), -1)
    al = tuple(torch.where(valid, a_streams[3 + k].gather(1, woff), 0)
               for k in range(La))
    bl = tuple(torch.where(has, b_streams[1 + k].gather(1, bsafe), 0)
               for k in range(Lb))
    return aidx, bidx, al, bl


def join_expand_stream(counts: torch.Tensor, a_streams, b_streams,
                       cap_e: int):
    """K4: expand K3's compacted plan into ``cap_e`` output rows per
    shard. ``a_streams`` and ``b_streams`` are K3's int32 groups, [3 + La,
    W, na] and [1 + Lb, W, nb]. For output j < n_out: the covering probe
    run (#{start <= j} - 1), its idx and lanes, and the build idx and
    lanes at ``j + (delta2 >> 1)``. Returns (aidx, bidx int32 [W, cap_e],
    a lane outputs, b lane outputs): -1 and zeroed lanes past n_out, and
    on the build side where the row has no match. On the card: one launch,
    a block per EXPAND_TILE outputs of a shard."""
    if counts.dtype != torch.int32 or counts.dim() != 2 \
            or counts.shape[1] != 4:
        raise CylonError(Code.Invalid, "join_expand_stream counts: want "
                                       "int32 [W, 4]")
    for what, x, lead in (("a", a_streams, 3), ("b", b_streams, 1)):
        if x.dtype != torch.int32 or x.dim() != 3 or x.shape[0] < lead \
                or x.shape[1] != counts.shape[0]:
            raise CylonError(Code.Invalid, f"join_expand_stream {what}: "
                             f"want int32 [>= {lead}, W, n], got "
                             f"{tuple(x.shape)} {x.dtype}")
    if not counts.is_cuda:
        return plain_join_expand_stream(counts, a_streams, b_streams, cap_e)
    La, Lb = len(a_streams) - 3, len(b_streams) - 1
    w, na = a_streams[0].shape
    nb = b_streams[0].shape[1]
    dev = counts.device
    counts = counts.contiguous()
    A = a_streams.contiguous()
    B = b_streams.contiguous()
    aidx = torch.empty(w, cap_e, dtype=torch.int32, device=dev)
    bidx = torch.empty_like(aidx)
    al = torch.empty(max(La, 1), w, cap_e, dtype=torch.int32, device=dev)
    bl = torch.empty(max(Lb, 1), w, cap_e, dtype=torch.int32, device=dev)
    _launch("join_stream", "launch_join_expand", _ptr(counts),
            _ptr(A), La, na, _ptr(B), Lb, nb, w, cap_e, _ptr(aidx),
            _ptr(bidx), _ptr(al), _ptr(bl), _stream(counts))
    LAUNCHES["join_expand_stream"] += 1
    return aidx, bidx, tuple(al.unbind(0))[:La], tuple(bl.unbind(0))[:Lb]


# ---------------------------------------------------------------------------
# K6 stream_compact
# ---------------------------------------------------------------------------


def plain_stream_compact(mask: torch.Tensor, streams: torch.Tensor,
                         out_len: int, first_mask: int = -1):
    """Plain version of K6 (see ``stream_compact``)."""
    L, w, n = streams.shape
    pos = torch.cumsum(mask.to(torch.int64), 1) - 1
    dest = torch.where(mask, pos, out_len)
    out = torch.zeros(L, w, out_len + 1, dtype=torch.int32,
                      device=streams.device)
    for o, v in zip(out, streams):
        o.scatter_(1, dest, v)
    if L and first_mask != -1:
        out[0] &= first_mask
    return out[:, :, :out_len].contiguous(), mask.sum(1, dtype=torch.int32)


def stream_compact(mask: torch.Tensor, streams: torch.Tensor,
                   out_len: Optional[int] = None, first_mask: int = -1):
    """K6: per shard, the elements of every 32-bit stream where ``mask``
    is True, moved in order to a dense prefix; zeros from each shard's
    count to ``out_len`` (default n). Stream 0's words are ANDed with
    ``first_mask`` (a non-negative int31 mask, or -1 for none).

    ``mask`` is bool [W, n], ``streams`` int32 [L, W, n]. Returns (int32
    [L, W, out_len], counts int32 [W]). On the card: one memset and one
    launch."""
    if mask.dtype != torch.bool or mask.dim() != 2 \
            or not mask.is_contiguous():
        raise CylonError(Code.Invalid, "stream_compact mask: want a "
                         f"contiguous [W, n] bool tensor, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    _check_streams(streams, mask.shape, "stream_compact streams")
    w, n = mask.shape
    out_len = n if out_len is None else int(out_len)
    if out_len < n:
        raise CylonError(Code.Invalid, f"stream_compact: out_len {out_len} "
                                       f"< n {n}")
    if not mask.is_cuda:
        return plain_stream_compact(mask, streams, out_len, first_mask)
    L = streams.shape[0]
    dev = mask.device
    if streams.device != dev:
        raise CylonError(Code.Invalid, "stream_compact: mask and streams "
                                       "must be on one device")
    out = torch.empty(L, w, out_len, dtype=torch.int32, device=dev)
    counts = torch.empty(w, dtype=torch.int32, device=dev)
    tiles = _tiles(n, COMPACT_TILE)
    slack = -(-(out_len - n) // COMPACT_TILE)
    lib = load_library("stream_compact")
    state = torch.empty(lib.compact_state_words(w, tiles), dtype=torch.int64,
                        device=dev)
    _launch("stream_compact", "launch_stream_compact", _ptr(mask),
            _ptr(streams), L, w, n, out_len, tiles, slack,
            first_mask & 0xFFFFFFFF, _ptr(state), _ptr(out), _ptr(counts),
            _stream(mask))
    LAUNCHES["stream_compact"] += 1
    return out, counts


# ---------------------------------------------------------------------------
# K5 setop_stream
# ---------------------------------------------------------------------------


def plain_setop_emit(h1_s, h2_s, tag_s, lanes, op: int):
    """The plain emit mask and collision counts of K5: the TPU kernel's
    per-element arithmetic as whole-tensor scans. Returns (emit bool [W,
    n], n_collisions int32 [W])."""
    w, n = h1_s.shape
    dev = h1_s.device
    tag = _u(tag_s)
    neq = torch.ones(w, n, dtype=torch.bool, device=dev)
    neq[:, 1:] = (h1_s[:, 1:] != h1_s[:, :-1]) | (h2_s[:, 1:] != h2_s[:, :-1])
    side = ((tag >> 31) & 1) == 1
    live = ((tag >> 29) & 1) == 1
    # collision audit: a live non-head row must repeat its predecessor's
    # lanes, and its predecessor must be live
    diff = torch.zeros(w, n, dtype=torch.bool, device=dev)
    for v in lanes:
        diff[:, 1:] |= v[:, 1:] != v[:, :-1]
    prev_live = torch.zeros_like(live)
    prev_live[:, 1:] = live[:, :-1]
    coll = ((diff | ~prev_live) & ~neq & live).sum(1, dtype=torch.int32)
    ill = (side & live).to(torch.int64)
    ibr = (~side & live).to(torch.int64)
    cum_l = torch.cumsum(ill, 1)
    cum_r = torch.cumsum(ibr, 1)
    # run-head prefixes are non-decreasing: a running max broadcasts them
    l_at = cum_l - torch.cummax(torch.where(neq, cum_l - ill, 0), 1).values
    r_at = cum_r - torch.cummax(torch.where(neq, cum_r - ibr, 0), 1).values
    if op == 0:    # UNION: first live element of each run
        emit = live & (l_at + r_at == 1)
    elif op == 1:  # SUBTRACT: first live left row, no live right row
        emit = (ill == 1) & (l_at == 1) & (r_at == 0)
    else:          # INTERSECT: first live left row, some live right row
        emit = (ill == 1) & (l_at == 1) & (r_at > 0)
    return emit, coll


def _compact_setop(emit, coll, streams, out_len: int, compact):
    """K5's compaction stage: the (tag, lanes...) stack by the emit mask,
    the tag cut to idx = tag & (2^29 - 1)."""
    out, n_out = compact(emit, streams, out_len, first_mask=IDX_MASK)
    return torch.stack([n_out, coll], 1), out


def plain_setop_stream(h1_s, h2_s, streams, op: int, out_len: int):
    """Plain version of K5 (see ``setop_stream``)."""
    emit, coll = plain_setop_emit(h1_s, h2_s, streams[0], streams[1:], op)
    return _compact_setop(emit, coll, streams, out_len,
                          plain_stream_compact)


def setop_stream(h1_s: torch.Tensor, h2_s: torch.Tensor,
                 streams: torch.Tensor, op: int,
                 out_len: Optional[int] = None):
    """K5: one distinct set operation over the stream sorted by (h1, h2,
    tag), per shard.

    Inputs are int32 [W, n] (n < 2^29) carrying uint32 bits, sorted
    together: ``h1_s``/``h2_s`` the 2x32-bit full-row hash (dead rows
    all-ones), and ``streams`` int32 [1 + L, W, n]: row 0 the packed tag
    ``side<<31 | live<<29 | iota`` with side 1 for the LEFT table (so a
    run's right rows precede its left rows), rows 1..L the canonical row
    payload lanes, which double as hash-verify lanes. op: 0 UNION (first
    live row of each run), 1 SUBTRACT (first live left row of runs
    without a live right row), 2 INTERSECT (first live left row of runs
    with one).

    Returns (counts int32 [W, 2] = [n_out, n_collisions], int32 [1 + L,
    W, out_len] = (idx, lanes...) compacted at the emitted rows, zeros
    past n_out). idx addresses the concatenated [left; right] rows. The
    compaction is K6 (``stream_compact``) on ``streams`` as it is."""
    for x, what in ((h1_s, "h1"), (h2_s, "h2")):
        _check(x, f"setop_stream {what}")
    _check_streams(streams, h1_s.shape, "setop_stream streams")
    w, n = h1_s.shape
    out_len = n if out_len is None else int(out_len)
    if streams.shape[0] < 1 or n >= (1 << 29) or out_len < n:
        raise CylonError(Code.Invalid, f"setop_stream: {streams.shape[0]} "
                                       f"streams (>= 1: the tag), n={n} "
                                       f"(< 2^29), out_len={out_len} (>= n)")
    if not h1_s.is_cuda:
        emit, coll = plain_setop_emit(h1_s, h2_s, streams[0], streams[1:],
                                      int(op))
        return _compact_setop(emit, coll, streams, out_len, stream_compact)
    dev = h1_s.device
    tiles = _tiles(n, SETOP_TILE)
    lib = load_library("setop_stream")
    state = torch.empty(lib.setop_state_words(w, tiles), dtype=torch.int64,
                        device=dev)
    emit = torch.empty(w, n, dtype=torch.bool, device=dev)
    coll = torch.empty(w, dtype=torch.int32, device=dev)
    _launch("setop_stream", "launch_setop_stream", _ptr(h1_s), _ptr(h2_s),
            _ptr(streams), streams.shape[0] - 1, w, n, tiles, int(op),
            _ptr(state), _ptr(emit), _ptr(coll), _stream(h1_s))
    LAUNCHES["setop_stream"] += 1
    return _compact_setop(emit, coll, streams, out_len, stream_compact)


# ---------------------------------------------------------------------------
# K7 segment_sum
# ---------------------------------------------------------------------------

SUM_DTYPES = {torch.float16: 0, torch.float32: 1, torch.float64: 2}
MAX_SUM_COLUMNS = 32   # columns a K7 launch (csrc/segment_sum.cu MAXC)


def _sum_args(xs, accs):
    """(single, columns, accumulator dtypes) of a K7 call: ``xs`` one
    tensor or a list, ``accs`` None (each column's own dtype) or one
    dtype a column, as wide as it or wider."""
    single = isinstance(xs, torch.Tensor)
    xs = [xs] if single else list(xs)
    accs = [x.dtype for x in xs] if accs is None else list(accs)
    if not xs or len(accs) != len(xs):
        raise CylonError(Code.Invalid, f"segment_sum: {len(xs)} columns, "
                                       f"{len(accs)} accumulator types")
    for x, a in zip(xs, accs):
        if x.dtype not in SUM_DTYPES or a not in SUM_DTYPES \
                or a.itemsize < x.dtype.itemsize:
            raise CylonError(Code.Invalid, f"segment_sum sums float16/32/64 "
                                           f"into as wide a float, got "
                                           f"{x.dtype} into {a}")
    return single, xs, accs


def _host_segment_sum(x: torch.Tensor, gid_s: torch.Tensor,
                      emit_s: torch.Tensor, num_segments: int
                      ) -> torch.Tensor:
    """One column of K7 on CPU tensors: ``index_add_`` on the host adds in
    index order, so each group's live rows are summed in row order from
    +0.0."""
    w, _n = x.shape
    off = torch.arange(w, dtype=torch.int64).unsqueeze(-1) * num_segments
    out = torch.zeros(w * num_segments, dtype=x.dtype)
    out.index_add_(0, (gid_s + off)[emit_s], x[emit_s])
    return out.view(w, num_segments)


def plain_segment_sum(xs, gid_s: torch.Tensor, emit_s: torch.Tensor,
                      num_segments: int, accs=None):
    """Plain version of K7, on any device: the host's row-order sum of a
    copy of the inputs, each column widened to its accumulator type first
    (exact), returned on the inputs' device (no torch op on the card sums
    a group in row order). The same forms as ``segment_sum``."""
    single, xs, accs = _sum_args(xs, accs)
    gid, emit = gid_s.cpu(), emit_s.cpu()
    out = [_host_segment_sum(x.cpu().to(a), gid, emit, int(num_segments)
                             ).to(x.device) for x, a in zip(xs, accs)]
    return out[0] if single else out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it on a 16-byte boundary (K7 copies rows in
    16-byte pieces)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def segment_sum(xs, gid_s: torch.Tensor, emit_s: torch.Tensor,
                num_segments: int, accs=None):
    """K7: per shard and column, the sum of each group's live rows, in
    row order.

    ``xs`` is one contiguous float16/32/64 [W, n] tensor or a list of
    them, sorted into groups with the live rows (``emit_s``, bool [W, n])
    first; ``gid_s`` int64 [W, n] their dense group ids, which do not
    decrease along the live rows and are below ``num_segments``.
    ``accs``: each column's accumulator dtype (default its own; a wider
    one reads the column in its own type, and widening is exact). Returns
    one [W, num_segments] tensor a column (a tensor for a tensor), +0.0
    in the slots of groups that do not exist. The order is the JAX
    package's sorted ``segment_sum``: the card's sums equal the CPU's bit
    for bit, run after run. On the card: one launch (a short and a long
    kernel) for up to MAX_SUM_COLUMNS columns, the columns sharing each
    row's group test and the chains of a long group running side by
    side; a tensor given twice is read once."""
    single, xs, accs = _sum_args(xs, accs)
    _check(gid_s, "segment_sum group ids", torch.int64)
    _check(emit_s, "segment_sum emit", torch.bool, gid_s.shape)
    for x in xs:
        _check(x, "segment_sum values", x.dtype, gid_s.shape)
    w, n = gid_s.shape
    s = int(num_segments)
    if not gid_s.is_cuda:
        out = [_host_segment_sum(x.to(a), gid_s, emit_s, s)
               for x, a in zip(xs, accs)]
        return out[0] if single else out
    dev = gid_s.device
    if emit_s.device != dev or any(x.device != dev for x in xs):
        raise CylonError(Code.Invalid, "segment_sum: inputs must be on one "
                                       "device")
    out = [torch.empty(w, s, dtype=a, device=dev) for a in accs]
    gid_a, emit_a = _aligned(gid_s), _aligned(emit_s)
    lib = load_library("segment_sum")
    for lo in range(0, len(xs), MAX_SUM_COLUMNS):
        cols = range(lo, min(lo + MAX_SUM_COLUMNS, len(xs)))
        srcs: List[torch.Tensor] = []
        where: Dict[tuple, int] = {}
        col_src = []
        for c in cols:
            key = (xs[c].data_ptr(), xs[c].dtype)
            if key not in where:
                where[key] = len(srcs)
                srcs.append(_aligned(xs[c]))
            col_src.append(where[key])
        state = torch.empty(lib.sum_state_words(w, n, len(cols)),
                            dtype=torch.int64, device=dev)
        _launch("segment_sum", "launch_segment_sum", _ptrs(srcs),
                _ints([SUM_DTYPES[x.dtype] for x in srcs]), len(srcs),
                _ints(col_src), _ints([SUM_DTYPES[accs[c]] for c in cols]),
                _ptrs([out[c] for c in cols]), len(cols), _ptr(gid_a),
                _ptr(emit_a), w, n, s, _ptr(state), _stream(gid_s))
        LAUNCHES["segment_sum"] += 1
    return out[0] if single else out


# ---------------------------------------------------------------------------
# K8 join_hash_keys
# ---------------------------------------------------------------------------

_SIGN64 = -(1 << 63)


def _hash_key_inputs(abits, akv, aemit, bbits, bkv, bemit):
    """K8's inputs checked: (abits, bbits) as lists, else raise."""
    abits, bbits = list(abits), list(bbits)
    if akv.dtype != torch.bool or bkv.dtype != torch.bool \
            or akv.dim() != 2 or bkv.dim() != 2 \
            or akv.shape[0] != bkv.shape[0]:
        raise CylonError(Code.Invalid, f"join_hash_keys: key validity "
                                       f"wants bool [W, na] and [W, nb], got "
                                       f"{tuple(akv.shape)} {akv.dtype} and "
                                       f"{tuple(bkv.shape)} {bkv.dtype}")
    if not abits or len(abits) != len(bbits):
        raise CylonError(Code.Invalid, f"join_hash_keys: {len(abits)} and "
                                       f"{len(bbits)} key columns")
    for i, (x, y) in enumerate(zip(abits, bbits)):
        if x.dtype != y.dtype or x.dtype == torch.bool \
                or x.dtype.is_floating_point or x.dtype.is_complex \
                or x.shape != akv.shape or y.shape != bkv.shape:
            raise CylonError(Code.Invalid, f"join_hash_keys: key column {i} "
                             f"wants integer bits of one dtype shaped like "
                             f"the key validity, got {tuple(x.shape)} "
                             f"{x.dtype} and {tuple(y.shape)} {y.dtype}")
    lanes = sum(2 if x.element_size() == 8 else 1 for x in abits)
    if lanes > MAX_HASH_LANES:
        raise CylonError(Code.Invalid, f"join_hash_keys takes at most "
                                       f"{MAX_HASH_LANES} u32 lanes, got "
                                       f"{lanes}")
    for m, kv in ((aemit, akv), (bemit, bkv)):
        if m is not None and (m.dtype != torch.bool or m.shape != kv.shape):
            raise CylonError(Code.Invalid, f"join_hash_keys: an emit mask "
                                           f"wants bool {tuple(kv.shape)}, "
                                           f"got {tuple(m.shape)} {m.dtype}")
    if akv.shape[1] + bkv.shape[1] >= (1 << 29):
        raise CylonError(Code.Invalid, "join_hash_keys: per-shard rows "
                                       "must fit the 29-bit tag")
    tensors = [*abits, *bbits, akv, bkv, aemit, bemit]
    if len({x.device for x in tensors if x is not None}) != 1:
        raise CylonError(Code.Invalid, "join_hash_keys: inputs must be on "
                                       "one device")
    return abits, bbits


def plain_join_hash_keys(abits, akv, aemit, bbits, bkv, bemit) -> dict:
    """Plain version of K8 (see ``join_hash_keys``): the int64 torch
    chain."""
    na = akv.shape[1]
    n = na + bkv.shape[1]
    emit = torch.cat([torch.ones_like(akv) if aemit is None else aemit,
                      torch.ones_like(bkv) if bemit is None else bemit], 1)
    live = emit & torch.cat([akv, bkv], 1)
    iota = torch.arange(n, dtype=torch.int64, device=akv.device)
    tag = ((iota < na).to(torch.int64) << 31) | (emit.to(torch.int64) << 30) \
        | (live.to(torch.int64) << 29) | iota
    kb = []
    for a, b in zip(abits, bbits):
        cat = torch.cat([a, b], 1)
        if cat.element_size() == 8:
            kb.append((cat >> 32) & 0xFFFFFFFF)
            kb.append(cat & 0xFFFFFFFF)
        else:
            kb.append(unsigned(cat))
    h1, h2 = hash2_streams(kb, live)
    return dict(tag=tag, kb=kb, h1=h1, h2=h2, key=((h2 << 32) | tag) ^ _SIGN64)


def join_hash_keys(abits, akv: torch.Tensor, aemit: Optional[torch.Tensor],
                   bbits, bkv: torch.Tensor, bemit: Optional[torch.Tensor]
                   ) -> dict:
    """K8: the hash stage of the join's hash-stream route, per shard, over
    the concatenation [a rows | b rows] (n = na + nb < 2^29).

    ``abits``/``bbits``: the sides' key bits, 1 to MAX_HASH_LANES u32
    lanes' worth of integer [W, na] / [W, nb] columns (one dtype a column
    on both sides), as ``ops/join.key_bits`` gives them; ``akv``/``bkv``
    bool key validity; ``aemit``/``bemit`` bool emit masks or None (every
    row emits).

    Returns int64 [W, n] tensors: ``tag`` = ``side<<31 | emit<<30 |
    live<<29 | iota`` (side 1 on a rows, live = emit & kv), ``kb`` the
    key's u32 lanes (an 8-byte column's hi and lo bits, a narrower one's
    unsigned value), ``h1``/``h2`` the two 32-bit row hashes
    (``hash.hash2_streams``: all-ones at rows not live) and ``key`` =
    ``((h2 << 32) | tag) ^ (1 << 63)``, the packed sort key. On the card:
    one launch."""
    abits, bbits = _hash_key_inputs(abits, akv, aemit, bbits, bkv, bemit)
    if not akv.is_cuda:
        return plain_join_hash_keys(abits, akv, aemit, bbits, bkv, bemit)
    w, na = akv.shape
    nb = bkv.shape[1]
    dev = akv.device

    def out():
        return torch.empty(w, na + nb, dtype=torch.int64, device=dev)

    tag, h1, h2, key = out(), out(), out(), out()
    kb, hi, lo = [], [], []
    for x in abits:
        hi.append(out())
        lo.append(out() if x.element_size() == 8 else None)
        kb += [t for t in (hi[-1], lo[-1]) if t is not None]
    abits = [x.contiguous() for x in abits]
    bbits = [x.contiguous() for x in bbits]
    masks = [None if m is None else m.contiguous()
             for m in (akv, bkv, aemit, bemit)]
    _launch("join_hash_keys", "launch_join_hash_keys", _ptrs(abits),
            _ptrs(bbits), _ints([x.element_size() for x in abits]),
            len(abits), _ptrs(hi), _ptrs(lo), *[_ptr(m) for m in masks],
            _ptr(tag), _ptr(h1), _ptr(h2), _ptr(key), w, na, nb,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _stream(akv))
    LAUNCHES["join_hash_keys"] += 1
    return dict(tag=tag, kb=kb, h1=h1, h2=h2, key=key)


# ---------------------------------------------------------------------------
# K9 setop_hash_rows
# ---------------------------------------------------------------------------

# how K9 widens a column's elements (csrc/setop_hash_rows.cu Mode)
_MODE_BOOL, _MODE_UNSIGNED, _MODE_SIGNED, _MODE_FLOAT = range(4)


def _lane_kind(dt: torch.dtype) -> Optional[str]:
    """The lane kind of ``ops/setops.setop_lane_descs`` a column of dtype
    ``dt`` takes, or None where it takes none."""
    if dt == torch.bool:
        return "b"
    if dt.is_complex:
        return None
    return {1: "n", 2: "n", 4: "d", 8: "w"}.get(
        torch.empty((), dtype=dt).element_size())


def _lane_mode(dt: torch.dtype) -> int:
    if dt == torch.bool:
        return _MODE_BOOL
    if dt.is_floating_point:
        return _MODE_FLOAT
    return _MODE_SIGNED if dt in (torch.int8, torch.int16) \
        else _MODE_UNSIGNED


def _zero_normalized(x: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0, so equal float values have equal bits."""
    return torch.where(x == 0, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)


def _col_lanes(x: torch.Tensor, valid: Optional[torch.Tensor],
               other_has_v: bool, kind: str) -> List[torch.Tensor]:
    """Canonical 32-bit lanes (int32 tensors) of one side's column ``x``
    with validity ``valid`` (or None): equal VALUES give equal lane bits
    (floats: -0.0 normalized; null cells: forced 0, the validity lane
    carrying the distinction). Narrow integers widen as
    ``astype(uint32)`` does: signed ones sign-extend."""
    if x.dtype.is_floating_point:
        x = _zero_normalized(x)
    if kind == "b":
        bits = [x.to(torch.int32)]
    elif kind == "n":
        if x.dtype in (torch.float16, torch.uint16):
            # float16: a bitcast, not a value cast (1.25 and 1.5 differ)
            bits = [x.view(torch.int16).to(torch.int32) & 0xFFFF]
        else:
            bits = [x.to(torch.int32)]
    elif kind == "w":
        u = x.view(torch.int64)
        bits = [as_i32(u >> 32), as_i32(u)]
    else:
        bits = [x.view(torch.int32)]
    if valid is not None or other_has_v:
        vm = torch.ones_like(x, dtype=torch.bool) if valid is None else valid
        bits = [torch.where(vm, b, 0) for b in bits]
        bits.append(vm.to(torch.int32))
    return bits


def setop_stack_hash(lane_l: Sequence[torch.Tensor],
                     lane_r: Sequence[torch.Tensor],
                     lemit: torch.Tensor, remit: torch.Tensor):
    """The stack and the row hash from the sides' lanes: the int32 [1 + L,
    W, n] stack of the tag (row 0) and the lanes, and (h1, h2, streams,
    side, live) as ``setop_hash_rows`` returns them. Lanes are int32 [W,
    nl] and [W, nr], emit masks bool."""
    w, nl = lemit.shape
    nr = remit.shape[1]
    dev = lemit.device
    live = torch.cat([lemit, remit], 1)
    side = torch.cat([torch.ones(w, nl, dtype=torch.bool, device=dev),
                      torch.zeros(w, nr, dtype=torch.bool, device=dev)], 1)
    streams = torch.empty(1 + len(lane_l), w, nl + nr, dtype=torch.int32,
                          device=dev)
    streams[0] = (side.to(torch.int32) << 31) | (live.to(torch.int32) << 29) \
        | torch.arange(nl + nr, dtype=torch.int32, device=dev)
    for k, (a, b) in enumerate(zip(lane_l, lane_r)):
        torch.cat([a, b], 1, out=streams[1 + k])
    h1, h2 = hash2_streams(list(streams[1:]), live)
    return h1, h2, streams, side, live


def _setop_hash_inputs(ldata, lvalid, lemit, rdata, rvalid, remit, descs):
    """K9's inputs checked: the lists and the lane count, else raise."""
    ldata, lvalid = list(ldata), list(lvalid)
    rdata, rvalid = list(rdata), list(rvalid)
    descs = list(descs)
    if not descs or not len(descs) == len(ldata) == len(lvalid) \
            == len(rdata) == len(rvalid):
        raise CylonError(Code.Invalid, f"setop_hash_rows: {len(descs)} "
                                       f"lane descriptors for {len(ldata)} "
                                       f"and {len(rdata)} columns")
    if any(x.dim() != 2 for x in ldata + rdata) \
            or ldata[0].shape[0] != rdata[0].shape[0]:
        raise CylonError(Code.Invalid, "setop_hash_rows: columns want [W, "
                                       "nl] and [W, nr] shapes")
    lshape, rshape = ldata[0].shape, rdata[0].shape
    lanes = 0
    for i, ((kind, has_v), a, av, b, bv) in enumerate(
            zip(descs, ldata, lvalid, rdata, rvalid)):
        if a.dtype != b.dtype or _lane_kind(a.dtype) != kind \
                or a.shape != lshape or b.shape != rshape:
            raise CylonError(Code.Invalid, f"setop_hash_rows: column {i} "
                             f"wants one dtype of lane kind {kind!r} shaped "
                             f"{tuple(lshape)} and {tuple(rshape)}, got "
                             f"{tuple(a.shape)} {a.dtype} and "
                             f"{tuple(b.shape)} {b.dtype}")
        if bool(has_v) != (av is not None or bv is not None) or any(
                v is not None and (v.dtype != torch.bool or v.shape != x.shape)
                for v, x in ((av, a), (bv, b))):
            raise CylonError(Code.Invalid, f"setop_hash_rows: column {i}'s "
                             f"validity wants bool shaped like the column, "
                             f"on a side where the plan has a validity lane")
        lanes += (2 if kind == "w" else 1) + (1 if has_v else 0)
    if lanes > MAX_SETOP_LANES:
        raise CylonError(Code.Invalid, f"setop_hash_rows takes at most "
                                       f"{MAX_SETOP_LANES} u32 lanes, got "
                                       f"{lanes}")
    for m, shape in ((lemit, lshape), (remit, rshape)):
        if m is not None and (m.dtype != torch.bool or m.shape != shape):
            raise CylonError(Code.Invalid, f"setop_hash_rows: an emit mask "
                                           f"wants bool {tuple(shape)}, got "
                                           f"{tuple(m.shape)} {m.dtype}")
    if lshape[1] + rshape[1] >= (1 << 29):
        raise CylonError(Code.Invalid, "setop_hash_rows: per-shard rows "
                                       "must fit the 29-bit tag")
    tensors = [*ldata, *lvalid, *rdata, *rvalid, lemit, remit]
    if len({x.device for x in tensors if x is not None}) != 1:
        raise CylonError(Code.Invalid, "setop_hash_rows: inputs must be on "
                                       "one device")
    return ldata, lvalid, rdata, rvalid, descs, lanes


def plain_setop_hash_rows(ldata, lvalid, lemit, rdata, rvalid, remit,
                          descs):
    """Plain version of K9 (see ``setop_hash_rows``): each column's lanes
    by ``_col_lanes``, then ``setop_stack_hash``."""
    lane_l, lane_r = [], []
    for (kind, _), a, av, b, bv in zip(descs, ldata, lvalid, rdata, rvalid):
        lane_l.extend(_col_lanes(a, av, bv is not None, kind))
        lane_r.extend(_col_lanes(b, bv, av is not None, kind))
    lemit = torch.ones_like(ldata[0], dtype=torch.bool) if lemit is None \
        else lemit
    remit = torch.ones_like(rdata[0], dtype=torch.bool) if remit is None \
        else remit
    return setop_stack_hash(lane_l, lane_r, lemit, remit)


def setop_hash_rows(ldata, lvalid, lemit: Optional[torch.Tensor], rdata,
                    rvalid, remit: Optional[torch.Tensor], descs):
    """K9: the hash stage of the set ops' stream route, per shard, over the
    concatenation [left rows | right rows] (n = nl + nr < 2^29).

    ``ldata``/``rdata``: the aligned column pairs' storage, [W, nl] and
    [W, nr] tensors (one dtype a pair; dictionary strings as their int32
    codes); ``lvalid``/``rvalid``: each column's bool validity or None;
    ``lemit``/``remit``: bool emit masks or None (every row emits);
    ``descs``: the lane plan of ``ops/setops.setop_lane_descs``, a
    (kind, has_validity) pair a column, at most MAX_SETOP_LANES lanes.

    Returns (h1, h2, streams, side, live): ``streams`` the int32 [1 + L,
    W, n] stack, row 0 the tag ``side<<31 | live<<29 | iota`` and rows 1..L
    the columns' canonical u32 lanes (``_col_lanes``); ``h1``/``h2`` the
    two 32-bit row hashes (``hash.hash2_streams`` over the lanes: int64
    values in [0, 2^32), all-ones at rows not live); ``side`` (True on left
    rows) and ``live`` (the emit masks) bool [W, n]. On the card: one
    launch."""
    ldata, lvalid, rdata, rvalid, descs, lanes = _setop_hash_inputs(
        ldata, lvalid, lemit, rdata, rvalid, remit, descs)
    if not ldata[0].is_cuda:
        return plain_setop_hash_rows(ldata, lvalid, lemit, rdata, rvalid,
                                     remit, descs)
    w, nl = ldata[0].shape
    nr = rdata[0].shape[1]
    dev = ldata[0].device
    stack = torch.empty(1 + lanes, w, nl + nr, dtype=torch.int32,
                        device=dev)
    h1, h2 = (torch.empty(w, nl + nr, dtype=torch.int64, device=dev)
              for _ in range(2))
    side, live = (torch.empty(w, nl + nr, dtype=torch.bool, device=dev)
                  for _ in range(2))

    def contiguous(xs):
        return [None if x is None else x.contiguous() for x in xs]

    ldata, lvalid, rdata, rvalid = (contiguous(xs) for xs in
                                    (ldata, lvalid, rdata, rvalid))
    lemit, remit = contiguous([lemit, remit])
    _launch("setop_hash_rows", "launch_setop_hash_rows", _ptrs(ldata),
            _ptrs(rdata), _ptrs(lvalid), _ptrs(rvalid),
            _ints([x.element_size() for x in ldata]),
            _ints([_lane_mode(x.dtype) for x in ldata]),
            _ints([int(bool(has_v)) for _kind, has_v in descs]), len(ldata),
            _ptr(lemit), _ptr(remit), _ptr(stack), _ptr(h1), _ptr(h2),
            _ptr(side), _ptr(live), w, nl, nr,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _stream(ldata[0]))
    LAUNCHES["setop_hash_rows"] += 1
    return h1, h2, stack, side, live


# ---------------------------------------------------------------------------
# K10 permute_rows
# ---------------------------------------------------------------------------


def record_words(words: int) -> int:
    """The int32 width of a K10 record of ``words`` words: whole 16-byte
    granules."""
    return -(-words // 4) * 4


def _permute_inputs(src, idx, words, key):
    """K10's inputs checked: (src, words, [W, n], key), else raise."""
    if isinstance(src, torch.Tensor):
        if src.dtype != torch.int32 or src.dim() != 3 \
                or src.shape[2] not in [record_words(k) for k in
                                        range(1, MAX_ROW_WORDS + 1)]:
            raise CylonError(Code.Invalid, f"permute_rows: a record source "
                             f"wants int32 [W, n, 4 x granules], got "
                             f"{tuple(src.shape)} {src.dtype}")
        words = src.shape[2] if words is None else words
        if record_words(words) != src.shape[2]:
            raise CylonError(Code.Invalid, f"permute_rows: {words} words do "
                             f"not fill records of {src.shape[2]}")
        shape, tensors = tuple(src.shape[:2]), [src]
    else:
        src = list(src)
        if not src or words not in (None, len(src)):
            raise CylonError(Code.Invalid, f"permute_rows: {len(src)} "
                                           f"streams for {words} words")
        shape, words, tensors = tuple(src[0].shape), len(src), list(src)
        for i, x in enumerate(src):
            if x.dtype not in (torch.int32, torch.int64) or x.dim() != 2 \
                    or tuple(x.shape) != shape:
                raise CylonError(Code.Invalid, f"permute_rows: stream {i} "
                                 f"wants int32 or int64 {list(shape)}, got "
                                 f"{tuple(x.shape)} {x.dtype}")
    if not 0 < words <= MAX_ROW_WORDS:
        raise CylonError(Code.Invalid, f"permute_rows takes 1 to "
                                       f"{MAX_ROW_WORDS} words, got {words}")
    if idx is not None:
        if idx.dtype != torch.int64 or tuple(idx.shape) != shape:
            raise CylonError(Code.Invalid, f"permute_rows: the index wants "
                             f"int64 {list(shape)}, got {tuple(idx.shape)} "
                             f"{idx.dtype}")
        tensors.append(idx)
    if key not in (0, 1, 2) or key > words:
        raise CylonError(Code.Invalid, f"permute_rows: a key of the first "
                                       f"one or two of {words} words, got "
                                       f"{key!r}")
    if shape[1] >= (1 << 29):
        raise CylonError(Code.Invalid, "permute_rows: per-shard rows must "
                                       "fit the 29-bit tag")
    if len({x.device for x in tensors}) != 1:
        raise CylonError(Code.Invalid, "permute_rows: inputs must be on one "
                                       "device")
    return src, words, shape, key


def plain_permute_rows(src, idx=None, words=None, split=False, key=0):
    """Plain version of K10 (see ``permute_rows``): the words stacked,
    gathered by ``idx`` and laid out."""
    src, words, (w, n), key = _permute_inputs(src, idx, words, key)
    if isinstance(src, torch.Tensor):
        rows = src[:, :, :words]
    else:
        rows = torch.stack([as_i32(x) if x.dtype == torch.int64 else x
                            for x in src], 2)
    if idx is not None:
        rows = rows.gather(1, idx.unsqueeze(2).expand(w, n, words))
    out_key = None
    if key:
        hi = rows[:, :, 0].to(torch.int64)
        out_key = hi & 0xFFFFFFFF if key == 1 else (
            (hi << 32) | (rows[:, :, 1].to(torch.int64) & 0xFFFFFFFF)
        ) ^ _SIGN64
    if split:
        return rows.permute(2, 0, 1).contiguous(), out_key
    out = torch.zeros(w, n, record_words(words), dtype=torch.int32,
                      device=rows.device)
    out[:, :, :words] = rows
    return out, out_key


def permute_rows(src, idx: Optional[torch.Tensor] = None,
                 words: Optional[int] = None, split: bool = False,
                 key: int = 0):
    """K10: one pass that moves each shard's rows as records of 32-bit
    words, per shard (n < 2^29 rows a shard).

    ``src``: the words, either a list of int32 or int64 [W, n] streams
    (an int64 one carries its word in its low 32 bits, as a value in [0,
    2^32)) or an int32 [W, n, record_words(words)] record array (``words``
    its words). Output row i reads row i, or row ``idx[w, i]`` of an int64
    [W, n] permutation (as ``torch.sort`` returns it).

    Returns (out, key_out): ``out`` the rows as an int32 [W, n,
    record_words(words)] record array (words past the last 0), or with
    ``split`` as an int32 [words, W, n] array, one plane a word;
    ``key_out`` the next sort's int64 key from the first ``key`` words:
    with 1 the value of word 0 in [0, 2^32), with 2 ``((w0 << 32) | w1)
    ^ (1 << 63)``; with 0 None. On the card: one launch."""
    src, words, (w, n), key = _permute_inputs(src, idx, words, key)
    records = isinstance(src, torch.Tensor)
    lead = src if records else src[0]
    if not lead.is_cuda:
        return plain_permute_rows(src, idx, words, split, key)
    dev = lead.device
    if split:
        out = torch.empty(words, w, n, dtype=torch.int32, device=dev)
    else:
        out = torch.empty(w, n, record_words(words), dtype=torch.int32,
                          device=dev)
    out_key = torch.empty(w, n, dtype=torch.int64, device=dev) if key \
        else None
    rec = src.contiguous() if records else None
    streams = [] if records else [x.contiguous() for x in src]
    idx = None if idx is None else idx.contiguous()
    _launch("permute_rows", "launch_permute_rows", _ptrs(streams),
            _ints([x.element_size() for x in streams]), words, _ptr(rec),
            _ptr(idx), None if split else _ptr(out),
            _ptr(out) if split else None, _ptr(out_key), key, w, n,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _stream(lead))
    LAUNCHES["permute_rows"] += 1
    return out, out_key


def kernel_table() -> List[dict]:
    """Static description of the ported kernels: name, source, the TPU
    kernel each replaces."""
    rel = {k: str(v.relative_to(PACKAGE_DIR.parent)) for k, v in
           SOURCES.items()}
    return [
        {"name": "partition_hist", "route": "cuda",
         "source": rel["partition"],
         "replaces": "cylon_tpu/ops/tpu_kernels.py:1010"},
        {"name": "partition_scatter", "route": "cuda",
         "source": rel["partition"],
         "replaces": "cylon_tpu/ops/tpu_kernels.py:1053"},
        {"name": "join_plan_stream", "route": "cuda",
         "source": rel["join_stream"],
         "replaces": "cylon_tpu/ops/tpu_kernels.py:317"},
        {"name": "join_expand_stream", "route": "cuda",
         "source": rel["join_stream"],
         "replaces": "cylon_tpu/ops/tpu_kernels.py:706"},
        {"name": "setop_stream", "route": "cuda",
         "source": rel["setop_stream"],
         "replaces": "cylon_tpu/ops/tpu_kernels.py:544"},
        {"name": "stream_compact", "route": "cuda",
         "source": rel["stream_compact"],
         "replaces": "cylon_tpu/ops/tpu_kernels.py:241"},
        {"name": "segment_sum", "route": "cuda",
         "source": rel["segment_sum"],
         "replaces": "cylon_tpu/ops/groupby.py:140"},
        {"name": "join_hash_keys", "route": "cuda",
         "source": rel["join_hash_keys"],
         "replaces": "cylon_tpu/ops/join.py:598"},
        {"name": "setop_hash_rows", "route": "cuda",
         "source": rel["setop_hash_rows"],
         "replaces": "none: XLA's fusion of cylon_tpu/ops/setops.py:183 "
                     "(_col_lanes) and cylon_tpu/ops/hash.py:91 "
                     "(hash2_streams)"},
        {"name": "permute_rows", "route": "cuda",
         "source": rel["permute_rows"],
         "replaces": "none: the payload operands of XLA's jax.lax.sort, "
                     "cylon_tpu/ops/join.py:632, :645 and "
                     "cylon_tpu/ops/setops.py:239"},
    ]
