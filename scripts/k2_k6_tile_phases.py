"""Where K2's and K6's time goes inside a tile: per-phase times of every
tile of one partition_scatter launch and one stream_compact launch on the
card, at the main path's inputs.

    python3 scripts/k2_k6_tile_phases.py [--rows N] [--setop-rows M]
        [--out PATH]

Builds instrumented copies of ``csrc/partition.cu`` and
``csrc/stream_compact.cu`` (a source patch: thread 0 of each block reads
the GPU's global timer after each phase and stores the stamps; the
look-backs count their rounds and their waits for a predecessor that has
published nothing yet), runs ``chip_smoke.py``'s world-4 join (2 x N
rows) and local UNION (2 x M rows) once to record each wrapper's first
inputs, launches each copy once after a warm-up and prints, per phase,
the mean and the 50th/90th/99th percentile microseconds over the tiles,
the kernel's span, the tiles started per microsecond and the look-backs'
counters (K2: calls, rounds, rounds that waited; K6: calls, then the
warp look-back's steps of 32 predecessors and the steps that met one
with nothing published). Phases: K2 ids + ranks (from the tile counter
to the ranked table), bucket scan (bases, starts and buffer slots),
look-back, legs (staging and writing every leg); K6 mask (its load),
look-back (ballots, the count and the look-back), zeros (the tile's tail
range), streams (staging and writing every stream). Slack tiles of K6 are
not stamped. Needs CUDA. An instrumented copy's total time is not the
kernel's: the stamps cost a little.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np

import phase_tools as pt

PHASES = {"partition": ("ids_rank", "scan", "lookback", "legs"),
          "stream_compact": ("mask", "lookback", "zeros", "streams")}

PRELUDE = pt.prelude(5, "__device__ unsigned long long g_count[3];\n")
STORE = pt.store("vt", ["T0", "T1", "T2", "T3", "now()"])

READ = """
extern "C" int read_stamps(void* dst, void* counters) {
  cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));
  cudaMemcpyFromSymbol(counters, g_count, sizeof(g_count));
  const unsigned long long z[3] = {0, 0, 0};
  cudaMemcpyToSymbol(g_count, z, sizeof(z));
  return (int)cudaGetLastError();
}
"""


def instrument_k2(src: str) -> str:
    """Stamps: T0 tile taken, T1 ranked, T2 scanned, T3 looked back;
    counters: look-back calls, rounds, rounds that waited."""
    s = pt.sub(src, "namespace {\n", PRELUDE)
    s = pt.sub(s, "  if (tid < nb) {\n    lb.run[tid] = 0;",
               "  if (tid == 0) atomicAdd(&g_count[0], 1ull);\n"
               "  if (tid < nb) {\n    lb.run[tid] = 0;")
    s = pt.sub(s, "  while (true) {\n    if (g < G && !lb.done[b]) {",
               "  while (true) {\n"
               "    if (tid == 0) atomicAdd(&g_count[1], 1ull);\n"
               "    if (g < G && !lb.done[b]) {")
    s = pt.sub(s, "    if (__syncthreads_or(blocked)) __nanosleep(32);",
               "    if (__syncthreads_or(blocked)) {\n"
               "      if (tid == 0) atomicAdd(&g_count[2], 1ull);\n"
               "      __nanosleep(32);\n    }")
    s = pt.sub(s, "  const int w = vt / tiles;\n", pt.stamp("T0")
               + "  const int w = vt / tiles;\n")
    s = pt.sub(s, "    slot[r] = in ? before + __popc(peers & below) : -1;\n"
               "  }\n  __syncthreads();\n",
               "    slot[r] = in ? before + __popc(peers & below) : -1;\n"
               "  }\n  __syncthreads();\n" + pt.stamp("T1"))
    s = pt.sub(s, "  if (L > 0) load_leg(0);\n",
               "  if (L > 0) load_leg(0);\n" + pt.stamp("T2"))
    s = pt.sub(s, "    s_dst[tid] = base_b + pre - s_loc[tid];\n  }\n"
               "  __syncthreads();\n",
               "    s_dst[tid] = base_b + pre - s_loc[tid];\n  }\n"
               "  __syncthreads();\n" + pt.stamp("T3"))
    s = pt.sub(s, "    __syncthreads();\n  }\n}\n\n}  // namespace",
               "    __syncthreads();\n  }\n" + STORE + "}\n\n}  // namespace")
    return s + READ


def instrument_k6(src: str) -> str:
    """Stamps: T0 tile taken, T1 mask loaded, T2 looked back, T3 tail
    zeroed; counters: look-back calls (tiles past the first), steps of 32
    predecessors, steps that waited (counted in the patched header)."""
    s = pt.sub(src, "namespace {\n", PRELUDE)
    s = pt.sub(s, "  const int w = (int)(vt / tiles);\n", pt.stamp("T0")
               + "  const int w = (int)(vt / tiles);\n")
    s = pt.sub(s, "  __syncthreads();\n  unsigned bal[IT];",
               "  __syncthreads();\n" + pt.stamp("T1")
               + "  unsigned bal[IT];")
    s = pt.sub(s, "  __syncthreads();\n  const int excl = s_excl;",
               "  __syncthreads();\n" + pt.stamp("T2")
               + "  const int excl = s_excl;")
    s = pt.sub(s, "  const int wo = s_woff[warp];",
               pt.stamp("T3") + "  const int wo = s_woff[warp];")
    s = pt.sub(s, "    __syncthreads();\n  }\n}\n\n}  // namespace",
               "    __syncthreads();\n  }\n" + STORE + "}\n\n}  // namespace")
    s = pt.sub(s, "      excl = lookback::look_back<Count>(",
               "      if (lane == 0) atomicAdd(&g_count[0], 1ull);\n"
               "      excl = lookback::look_back<Count>(")
    return s + READ


def instrument_header(hdr: str) -> str:
    """The warp look-back's steps of 32 predecessors and the steps that
    met one with nothing published, as counters in the header that
    ``read_lb_counts`` reads and clears."""
    h = pt.sub(hdr, "namespace lookback {\n",
               "namespace lookback {\n"
               "__device__ unsigned long long g_lb_steps, g_lb_waits;\n")
    h = pt.sub(h, "    if (__any_sync(FULL, status == 0)) {\n",
               "    if (lane == 0) atomicAdd(&g_lb_steps, 1ull);\n"
               "    if (__any_sync(FULL, status == 0)) {\n"
               "      if (lane == 0) atomicAdd(&g_lb_waits, 1ull);\n")
    h += """
extern "C" int read_lb_counts(void* counters) {
  cudaMemcpyFromSymbol(counters, lookback::g_lb_steps, 8);
  cudaMemcpyFromSymbol((char*)counters + 8, lookback::g_lb_waits, 8);
  const unsigned long long z = 0;
  cudaMemcpyToSymbol(lookback::g_lb_steps, &z, 8);
  cudaMemcpyToSymbol(lookback::g_lb_waits, &z, 8);
  return (int)cudaGetLastError();
}
"""
    return h


def measure(torch, lib, go, T: int, phases, rows_per_tile: int) -> dict:
    """Warm up, then one stamped launch: per-phase percentiles."""
    stamps = np.zeros(5 * pt.MAX_TILES, np.uint64)
    counts = np.zeros(3, np.uint64)
    lbc = np.zeros(2, np.uint64)

    def read():
        lib.read_stamps(stamps.ctypes.data, counts.ctypes.data)
        lib.read_lb_counts(lbc.ctypes.data)

    pt.stamped(torch, go, read)
    t = stamps[:5 * T].reshape(T, 5).astype(np.int64)
    return {"tile_rows": rows_per_tile, **pt.span_stats(t, phases),
            "counters": [int(x) for x in counts],
            "lookback_steps_waits": [int(x) for x in lbc]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--setop-rows", type=int, default=1 << 23)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch, cs, ct, K, card = pt.init("k2_k6_tile_phases")
    hdr = instrument_header((K.CSRC / "lookback.cuh").read_text())
    libs = pt.build(K, {
        "partition": ("partition",
                      instrument_k2(K.SOURCES["partition"].read_text()), hdr),
        "stream_compact": ("stream_compact", instrument_k6(
            K.SOURCES["stream_compact"].read_text()), hdr)}, "tile_phases")
    for lib in libs.values():
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.read_lb_counts.argtypes = [ctypes.c_void_p]
    k2, k6 = libs["partition"], libs["stream_compact"]
    st = torch.cuda.current_stream().cuda_stream

    rec = pt.record_join(torch, cs, ct, K, args.rows)
    (t, legs, nb, counts), _ = rec.calls["partition_scatter"]
    legs = list(legs)
    w, n = t.shape
    tiles = -(-n // K.PARTITION_TILE)
    assert w * tiles <= pt.MAX_TILES
    state = torch.empty(k2.scatter_state_words(w, tiles, nb),
                        dtype=torch.int64, device="cuda")
    o2 = torch.empty(len(legs), w, n, dtype=torch.int32, device="cuda")

    def go2():
        assert k2.launch_partition_scatter(
            t.data_ptr(), K._ptrs(legs), len(legs), o2.data_ptr(),
            counts.data_ptr(), w, n, tiles, nb, state.data_ptr(), st) == 0

    res = {"card": card, "partition_scatter": measure(
        torch, k2, go2, w * tiles, PHASES["partition"], K.PARTITION_TILE)}
    assert torch.equal(o2, K.plain_partition_scatter(t, legs, nb, counts))
    del rec, t, legs, counts, o2, state

    rec = pt.record_union(torch, cs, ct, K, args.setop_rows)
    (mask, streams, out_len), kw = rec.calls["stream_compact"]
    first = kw.get("first_mask", -1)
    w, n = mask.shape
    tiles = -(-n // K.COMPACT_TILE)
    slack = -(-(out_len - n) // K.COMPACT_TILE)
    assert w * tiles <= pt.MAX_TILES
    state = torch.empty(k6.compact_state_words(w, tiles), dtype=torch.int64,
                        device="cuda")
    o6 = torch.empty(streams.shape[0], w, out_len, dtype=torch.int32,
                     device="cuda")
    c6 = torch.empty(w, dtype=torch.int32, device="cuda")

    def go6():
        assert k6.launch_stream_compact(
            mask.data_ptr(), streams.data_ptr(), streams.shape[0], w, n,
            out_len, tiles, slack, first & 0xFFFFFFFF, state.data_ptr(),
            o6.data_ptr(), c6.data_ptr(), st) == 0

    res["stream_compact"] = measure(torch, k6, go6, w * tiles,
                                    PHASES["stream_compact"], K.COMPACT_TILE)
    ref = K.plain_stream_compact(mask, streams, out_len, first)
    assert torch.equal(o6, ref[0]) and torch.equal(c6, ref[1])
    return pt.finish(res, args.out, card)


if __name__ == "__main__":
    sys.exit(main())
