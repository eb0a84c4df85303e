"""Where K3's time goes inside a tile: per-phase times of every tile of
one join_plan_stream launch on the card, at the join's main-path inputs.

    python3 scripts/k3_tile_phases.py [--rows N] [--out PATH]

Builds an instrumented copy of ``csrc/join_stream.cu`` (a source patch:
thread 0 of each block reads the GPU's global timer after each phase and
stores the stamps, and the look-back counts its steps and its waits for
a predecessor that has published nothing yet), runs ``chip_smoke.py``'s
world-4 join (2 x N rows) once to record K3's inputs, launches the copy
once after a warm-up and prints, per phase (load, scan with its
look-back, ranking, group-B writes, group-A writes), the mean and the
50th/90th/99th percentile microseconds over the tiles, the kernel's span,
the tiles started per microsecond and the look-back's steps and waits per
call. Needs CUDA. The instrumented copy's total time is not K3's: the
stamps cost a little.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("load", "scan", "rank", "write_b", "write_a")
MAX_TILES = 1 << 16


def sub(s: str, a: str, b: str) -> str:
    assert s.count(a) == 1, a
    return s.replace(a, b)


def instrumented(src: str, hdr: str):
    h = sub(hdr, "namespace lookback {\n",
            "namespace lookback {\n"
            "__device__ unsigned long long g_calls, g_steps, g_waits;\n")
    h = sub(h, "  long long pred = t - 1;\n",
            "  long long pred = t - 1;\n"
            "  if (lane == 0) atomicAdd(&g_calls, 1ull);\n")
    h = sub(h, "    if (__any_sync(FULL, status == 0)) {\n",
            "    if (lane == 0) atomicAdd(&g_steps, 1ull);\n"
            "    if (__any_sync(FULL, status == 0)) {\n"
            "      if (lane == 0) atomicAdd(&g_waits, 1ull);\n")
    s = sub(src, "namespace {\n\nusing lookback::ScanState;",
            "#include <cstring>\nnamespace {\n"
            f"__device__ unsigned long long g_stamp[6 * {MAX_TILES}];\n"
            "__device__ __forceinline__ unsigned long long now() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n\nusing lookback::ScanState;")
    marks = [
        ("  const int w = vt / tiles;\n", "T0", True),
        ("  __syncthreads();\n\n  // run heads", "T1", False),
        ("    ScanPlan(tmp).ExclusiveScan(ta, ex, lookback::Combine<Plan>(),"
         " cb);\n  }\n", "T2", False),
        ("  __syncthreads();\n\n  // write both groups", "T3", False),
        ("    gather_lanes(lanes, Lb, g0, s_srcB, nB, oB + pb_, pb_);\n  }\n",
         "T4", False),
    ]
    for anchor, name, before in marks:
        stamp = f"  const unsigned long long {name} = now();\n"
        if before:
            s = sub(s, anchor, stamp + anchor)
        elif anchor.startswith("  __syncthreads();\n\n"):
            s = sub(s, anchor, "  __syncthreads();\n" + stamp
                    + anchor[len("  __syncthreads();\n"):])
        else:
            s = sub(s, anchor, anchor + stamp)
    s = sub(s, "  if (tile == tiles - 1 && threadIdx.x == 0) {",
            "  __syncthreads();\n"
            "  if (threadIdx.x == 0 && vt < " + str(MAX_TILES) + ") {\n"
            "    unsigned long long* d = g_stamp + 6 * vt;\n"
            "    d[0] = T0; d[1] = T1; d[2] = T2; d[3] = T3; d[4] = T4;\n"
            "    d[5] = now();\n  }\n"
            "  if (tile == tiles - 1 && threadIdx.x == 0) {")
    s += """
extern "C" int read_stamps(void* dst, void* counters) {
  cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));
  unsigned long long c[3];
  cudaMemcpyFromSymbol(&c[0], lookback::g_calls, 8);
  cudaMemcpyFromSymbol(&c[1], lookback::g_steps, 8);
  cudaMemcpyFromSymbol(&c[2], lookback::g_waits, 8);
  memcpy(counters, c, sizeof(c));
  const unsigned long long z[3] = {0, 0, 0};
  cudaMemcpyToSymbol(lookback::g_calls, &z[0], 8);
  cudaMemcpyToSymbol(lookback::g_steps, &z[1], 8);
  cudaMemcpyToSymbol(lookback::g_waits, &z[2], 8);
  return (int)cudaGetLastError();
}
"""
    return s, h


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3_tile_phases: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K

    card = cs.card_line()
    print(card, flush=True)
    vdir = K.BUILD_DIR / "tile_phases"
    vdir.mkdir(parents=True, exist_ok=True)
    src, hdr = instrumented(K.SOURCES["join_stream"].read_text(),
                            (K.CSRC / "lookback.cuh").read_text())
    (vdir / "lookback.cuh").write_text(hdr)
    (vdir / "join_stream.cu").write_text(src)
    so = vdir / "libjoin_stream_phases.so"
    subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", str(so),
                    str(vdir / "join_stream.cu")], check=True,
                   stdout=open(vdir / "build.log", "w"),
                   stderr=subprocess.STDOUT)
    lib = ctypes.CDLL(str(so))
    lib.launch_plan_stream.argtypes = \
        K._SIGNATURES["join_stream"]["launch_plan_stream"]
    lib.launch_plan_stream.restype = ctypes.c_int
    lib.plan_state_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.plan_state_words.restype = ctypes.c_longlong
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    left, right, _h = cs.make_tables(ct, dctx, args.rows, 0)
    with cs.Recorder(K) as rec:
        out = left.distributed_join(right, "inner", on=["k"],
                                    force_exchange=True)
        torch.cuda.synchronize()
    del out, left, right
    _a, kw = rec.calls["join_plan_stream"]
    bits, tag, lanes = kw["bits_s"], kw["tag_s"], list(kw["lanes"])
    w, n = bits.shape
    na, nb = kw["na"], kw["nb"]
    la, lb = kw["n_a_lanes"], kw["n_b_lanes"]
    tiles = -(-n // K.PLAN_TILE)
    T = w * tiles
    assert T <= MAX_TILES, T
    state = torch.empty(lib.plan_state_words(w, tiles), dtype=torch.int64,
                        device="cuda")
    oa = torch.empty(3 + la, w, na, dtype=torch.int32, device="cuda")
    ob = torch.empty(1 + lb, w, nb, dtype=torch.int32, device="cuda")
    cnt = torch.empty(w, 4, dtype=torch.int32, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

    def go():
        assert lib.launch_plan_stream(
            bits.data_ptr(), tag.data_ptr(), None, K._ptrs([]), 0,
            K._ptrs(lanes), len(lanes), la, lb, w, n, tiles, 0, na, nb,
            state.data_ptr(), oa.data_ptr(), ob.data_ptr(), cnt.data_ptr(),
            st) == 0

    stamps = np.zeros(6 * MAX_TILES, np.uint64)
    counters = np.zeros(3, np.uint64)
    for _ in range(3):
        go()
    torch.cuda.synchronize()
    lib.read_stamps(stamps.ctypes.data, counters.ctypes.data)
    go()
    torch.cuda.synchronize()
    lib.read_stamps(stamps.ctypes.data, counters.ctypes.data)
    t = stamps[:6 * T].reshape(T, 6).astype(np.int64)
    us = np.diff(t, axis=1) / 1e3
    span = (t[:, 5].max() - t[:, 0].min()) / 1e3
    calls, steps, waits = (int(x) for x in counters)
    res = {"card": card, "tiles": T, "tile_rows": K.PLAN_TILE,
           "span_us": span, "tiles_per_us": T / span,
           "tile_us_mean": float((t[:, 5] - t[:, 0]).mean() / 1e3),
           "phase_us": {p: {"mean": float(us[:, i].mean()),
                            **{f"p{q}": float(np.percentile(us[:, i], q))
                               for q in (50, 90, 99)}}
                        for i, p in enumerate(PHASES)},
           "lookback_calls": calls,
           "steps_per_call": steps / max(calls, 1),
           "waits_per_call": waits / max(calls, 1)}
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
