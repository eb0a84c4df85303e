"""Shared helpers of the kernel phase scripts (``k3_tile_phases.py``,
``k2_k6_tile_phases.py``, ``k1_k4_phases.py``): patch a kernel source by
exact text, build patched copies in parallel, time launches with CUDA
events, read per-tile timer stamps and summarise them, and record a
kernel wrapper's inputs from ``chip_smoke.py``'s paths.

Imported by those scripts (they run as ``python3 scripts/<name>.py``, so
this directory is on ``sys.path``); not a script of its own.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MAX_TILES = 1 << 16   # tiles a stamped launch records


def sub(s: str, a: str, b: str) -> str:
    """``s`` with its one occurrence of ``a`` replaced by ``b``."""
    assert s.count(a) == 1, a
    return s.replace(a, b)


def patch(s: str, subs) -> str:
    for a, b in subs:
        s = sub(s, a, b)
    return s


def prelude(words: int, extra: str = "") -> str:
    """Text that replaces a source's first ``namespace {``: a stamp table
    of ``words`` 64-bit words per tile, ``extra`` declarations and
    ``now()``, the GPU's global timer in ns."""
    return ("namespace {\n"
            f"__device__ unsigned long long g_stamp[{words} * {MAX_TILES}];\n"
            + extra +
            "__device__ __forceinline__ unsigned long long now() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n")


def stamp(name: str) -> str:
    return f"  const unsigned long long {name} = now();\n"


def store(vt: str, values) -> str:
    """Thread 0 writes ``values`` (C expressions) as tile ``vt``'s row of
    the stamp table."""
    n = len(values)
    body = " ".join(f"d[{i}] = {v};" for i, v in enumerate(values))
    return (f"  if (threadIdx.x == 0 && {vt} < {MAX_TILES}) {{\n"
            f"    unsigned long long* d = g_stamp + {n} * ({vt});\n"
            f"    {body}\n  }}\n")


def init(name: str):
    """(torch, chip_smoke, cylon_tpu_torch, kernels, card line) with the
    card line printed; exits 1 when CUDA is not available."""
    import torch

    if not torch.cuda.is_available():
        print(f"{name}: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K

    card = cs.card_line()
    print(card, flush=True)
    return torch, cs, ct, K, card


def build(K, jobs: dict, subdir: str) -> dict:
    """Build {tag: (source name, source text, lookback.cuh text or None)}
    in parallel, one ``nvcc`` each under ``_build/<subdir>/<tag>/``;
    returns {tag: CDLL} with the launchers' and state functions'
    signatures set."""
    procs = {}
    nvcc = K.nvcc_path()
    for tag, (name, src, hdr) in jobs.items():
        vdir = K.BUILD_DIR / subdir / tag
        vdir.mkdir(parents=True, exist_ok=True)
        for h in K.CSRC.glob("*.cuh"):
            (vdir / h.name).write_text(h.read_text())
        if hdr is not None:
            (vdir / "lookback.cuh").write_text(hdr)
        (vdir / f"{name}.cu").write_text(src)
        so = vdir / f"lib{name}.so"
        log = open(vdir / "build.log", "w")
        procs[tag] = (name, so, log, subprocess.Popen(
            [nvcc, *K.NVCC_FLAGS, "-o", str(so), str(vdir / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for tag, (name, so, log, p) in procs.items():
        rc = p.wait()
        log.close()
        assert rc == 0, (tag, (so.parent / "build.log").read_text()[-3000:])
        lib = ctypes.CDLL(str(so))
        for fn, args in K._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        if name in K._STATE_WORDS:
            fn, args = K._STATE_WORDS[name]
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_longlong
        libs[tag] = lib
    return libs


def event_ms(torch, go, reps: int = 20) -> float:
    """Median of ``reps`` launches after 3 warm-ups, CUDA events around
    each."""
    for _ in range(3):
        go()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        go()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def stamped(torch, go, read) -> None:
    """Three warm-up launches, ``read()`` (which also clears counters),
    then one launch whose stamps ``read()`` fetches."""
    for _ in range(3):
        go()
    torch.cuda.synchronize()
    read()
    go()
    torch.cuda.synchronize()
    read()


def pct(x) -> dict:
    """Mean and 50th/90th/99th percentiles of ``x``."""
    x = np.asarray(x, np.float64)
    return {"mean": float(x.mean()),
            **{f"p{q}": float(np.percentile(x, q)) for q in (50, 90, 99)}}


def span_stats(t: np.ndarray, phases) -> dict:
    """Per-tile stamps ``t`` [T, len(phases) + 1] (ns, in phase order,
    the last the tile's end): the span, the tiles started per us, the
    mean tile and each phase's percentiles in us."""
    T = t.shape[0]
    us = np.diff(t, axis=1) / 1e3
    span = (t[:, -1].max() - t[:, 0].min()) / 1e3
    return {"tiles": T, "span_us": span, "tiles_per_us": T / span,
            "tile_us_mean": float((t[:, -1] - t[:, 0]).mean() / 1e3),
            "phase_us": {p: pct(us[:, i]) for i, p in enumerate(phases)}}


def record_join(torch, cs, ct, K, rows: int):
    """``chip_smoke.py``'s world-4 join of 2 x ``rows`` rows
    (``force_exchange``) once; the Recorder with each wrapper's first
    inputs."""
    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    left, right, _h = cs.make_tables(ct, dctx, rows, 0)
    with cs.Recorder(K) as rec:
        out = left.distributed_join(right, "inner", on=["k"],
                                    force_exchange=True)
        torch.cuda.synchronize()
    del out, left, right
    return rec


def record_union(torch, cs, ct, K, rows: int):
    """``chip_smoke.py``'s local UNION of 2 x ``rows`` rows once; the
    Recorder with each wrapper's first inputs."""
    lctx = ct.CylonContext.Init()
    a, b, _p = cs.make_setop_tables(ct, lctx, rows, 3)
    with cs.Recorder(K) as rec:
        out = a.union(b)
        torch.cuda.synchronize()
    del out, a, b
    return rec


def finish(res: dict, out, card: str) -> int:
    """Print ``res`` as one JSON line, write it to ``out`` when given,
    and print the card line again."""
    print(json.dumps(res), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    return 0
