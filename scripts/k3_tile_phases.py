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
import sys

import numpy as np

import phase_tools as pt

PHASES = ("load", "scan", "rank", "write_b", "write_a")


def instrumented(src: str, hdr: str):
    h = pt.sub(hdr, "namespace lookback {\n",
               "namespace lookback {\n"
               "__device__ unsigned long long g_calls, g_steps, g_waits;\n")
    h = pt.sub(h, "  long long pred = t - 1;\n",
               "  long long pred = t - 1;\n"
               "  if (lane == 0) atomicAdd(&g_calls, 1ull);\n")
    h = pt.sub(h, "    if (__any_sync(FULL, status == 0)) {\n",
               "    if (lane == 0) atomicAdd(&g_steps, 1ull);\n"
               "    if (__any_sync(FULL, status == 0)) {\n"
               "      if (lane == 0) atomicAdd(&g_waits, 1ull);\n")
    s = pt.sub(src, "namespace {\n\nusing lookback::ScanState;",
               "#include <cstring>\n" + pt.prelude(6)
               + "\nusing lookback::ScanState;")
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
        if before:
            s = pt.sub(s, anchor, pt.stamp(name) + anchor)
        elif anchor.startswith("  __syncthreads();\n\n"):
            s = pt.sub(s, anchor, "  __syncthreads();\n" + pt.stamp(name)
                       + anchor[len("  __syncthreads();\n"):])
        else:
            s = pt.sub(s, anchor, anchor + pt.stamp(name))
    s = pt.sub(s, "  if (tile == tiles - 1 && threadIdx.x == 0) {",
               "  __syncthreads();\n"
               + pt.store("vt", ["T0", "T1", "T2", "T3", "T4", "now()"])
               + "  if (tile == tiles - 1 && threadIdx.x == 0) {")
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
    torch, cs, ct, K, card = pt.init("k3_tile_phases")
    src, hdr = instrumented(K.SOURCES["join_stream"].read_text(),
                            (K.CSRC / "lookback.cuh").read_text())
    lib = pt.build(K, {"k3": ("join_stream", src, hdr)}, "tile_phases")["k3"]
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    rec = pt.record_join(torch, cs, ct, K, args.rows)
    _a, kw = rec.calls["join_plan_stream"]
    bits, tag, lanes = kw["bits_s"], kw["tag_s"], list(kw["lanes"])
    w, n = bits.shape
    na, nb = kw["na"], kw["nb"]
    la, lb = kw["n_a_lanes"], kw["n_b_lanes"]
    tiles = -(-n // K.PLAN_TILE)
    T = w * tiles
    assert T <= pt.MAX_TILES, T
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

    stamps = np.zeros(6 * pt.MAX_TILES, np.uint64)
    counters = np.zeros(3, np.uint64)
    pt.stamped(torch, go, lambda: lib.read_stamps(stamps.ctypes.data,
                                                  counters.ctypes.data))
    t = stamps[:6 * T].reshape(T, 6).astype(np.int64)
    calls, steps, waits = (int(x) for x in counters)
    res = {"card": card, "tile_rows": K.PLAN_TILE,
           **pt.span_stats(t, PHASES),
           "lookback_calls": calls,
           "steps_per_call": steps / max(calls, 1),
           "waits_per_call": waits / max(calls, 1)}
    return pt.finish(res, args.out, card)


if __name__ == "__main__":
    sys.exit(main())
