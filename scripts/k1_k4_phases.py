"""Where K4's time goes inside a tile, and K1's and K4's design choices
timed against each other, on the card at the world-4 join's inputs.

    python3 scripts/k1_k4_phases.py [--rows N] [--out PATH]

Runs ``chip_smoke.py``'s world-4 join (2 x N rows, ``force_exchange``)
once to record the inputs of K1 partition_hist's and K4
join_expand_stream's first calls, then:

* K4 tile phases: an instrumented copy of ``csrc/join_stream.cu`` (a
  source patch: thread 0 of each block reads the GPU's global timer at
  the block's start, after the 32-ary search, after the window of starts,
  and, in each step of outputs, after the runs of the step's outputs are
  found and after every group A and B load of the step has landed (each
  behind a barrier; the loads are made to land by folding the loaded
  values into one shared store), and at the block's end) launched once
  after a warm-up. It prints the number of fill-only tiles (at or past
  their shard's n_out: the writes of a tile without its reads), their
  time, and per phase of the other tiles the mean and 50th/90th/99th
  percentile microseconds: search, window, runs (the searches in shared
  memory), reads (group A's and B's loads), writes (the stores, from the
  last load to the next step or the block's end); the kernel's span and
  the tiles started per microsecond. An instrumented copy's total time is
  not the kernel's: the stamps and the barriers cost a little.
* variants: patched copies of the sources (K4: group A staged in dynamic
  shared memory over the window and read from there, ``stage_a``; 1 or 4
  steps of 1,024 outputs a tile, ``EX_STEPS``; 1, 2 or 4 blocks an SM in
  ``__launch_bounds__``, ``EX_BLOCKS``; tiles launched from both ends of a
  shard in turn, so that fill-only tiles run beside the others; K1: a
  block takes 2, 4 or 8 tiles of its shard in turn), each held against
  the plain version bit for bit, then timed with the committed build in
  turns (committed, variants, variants reversed, committed): per turn the
  median of 20 launches, CUDA events around each.

Prints the card's name and power limit and one JSON line; with ``--out``
also writes it to a file. Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np

import phase_tools as pt

STAGE_A = [
    ("  __shared__ int s_start[EX_TILE];\n",
     "  extern __shared__ uint32_t s_a[];  // A's idx, delta2 and lanes\n"
     "  __shared__ int s_start[EX_TILE];\n"),
    ("s_start[k] = __ldg(start + r_lo + k);\n  __syncthreads();\n",
     "s_start[k] = __ldg(start + r_lo + k);\n"
     "  for (int p = 0; p < 2 + La; ++p) {\n"
     "    const uint32_t* src =\n"
     "        A + ((size_t)(p < 2 ? p : p + 1) * W + w) * capA + r_lo;\n"
     "    for (int k = tid; k < nwin; k += EX_BT)\n"
     "      s_a[p * EX_TILE + k] = __ldg(src + k);\n  }\n"
     "  __syncthreads();\n"),
    ("    auto a_at = [&](int p, int q) { return __ldg(Aw + p * pa + kq[q]); "
     "};\n",
     "    auto a_at = [&](int p, int q) {\n"
     "      return s_a[(p < 2 ? p : p - 1) * EX_TILE + kq[q]];\n    };\n"),
    ("  join_expand<<<dim3((unsigned)tiles, W), EX_BT, 0, "
     "(cudaStream_t)stream>>>(",
     "  const int smem = (2 + La) * EX_TILE * 4;\n"
     "  cudaError_t err = cudaFuncSetAttribute(\n"
     "      join_expand, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "  if (err != cudaSuccess) return static_cast<int>(err);\n"
     "  join_expand<<<dim3((unsigned)tiles, W), EX_BT, smem, "
     "(cudaStream_t)stream>>>("),
]


def hist_tiles(k: int):
    """K1 with a block per ``k`` consecutive tiles of a shard."""
    return [
        ("  const long long t0 = (long long)blockIdx.x * TILE;\n",
         f"  for (int tile = blockIdx.x * {k};\n"
         f"       tile < min(tiles, (int)(blockIdx.x + 1) * {k}); ++tile) {{\n"
         "  const long long t0 = (long long)tile * TILE;\n"),
        ("  int32_t* out = hist + ((size_t)w * tiles + blockIdx.x) * nb;",
         "  int32_t* out = hist + ((size_t)w * tiles + tile) * nb;"),
        ("    for (int b = tid; b < nb; b += HIST_BT) out[b] = s_h[b];\n"
         "  }\n}\n",
         "    for (int b = tid; b < nb; b += HIST_BT) out[b] = s_h[b];\n"
         "  }\n  __syncthreads();  // the tables serve the next tile\n"
         "  }\n}\n"),
        ("dim3(tiles, W)", f"dim3((tiles + {k - 1}) / {k}, W)"),
    ]


# each variant: the source it patches and its (old, new) substitutions
VARIANTS = {
    "join_stream": {
        "stage_a": STAGE_A,
        **{f"steps_{k}": [("constexpr int EX_STEPS = 2;",
                           f"constexpr int EX_STEPS = {k};")]
           for k in (1, 4)},
        **{f"blocks_{k}": [("constexpr int EX_BLOCKS = 3;",
                            f"constexpr int EX_BLOCKS = {k};")]
           for k in (1, 2, 4)},
        "interleave": [("  const long long j0 = (long long)blockIdx.x * "
                        "EX_TILE;\n",
                        "  const long long bx = blockIdx.x;\n"
                        "  const long long j0 = ((bx & 1) ? gridDim.x - 1 - "
                        "(bx >> 1) : (bx >> 1)) * EX_TILE;\n")],
    },
    "partition": {f"tiles_{k}": hist_tiles(k) for k in (2, 4, 8)},
}
# K4 stamps a tile: start, searched, window loaded, + runs, + reads, end,
# and 1 for a fill-only tile
K4_WORDS = 7
K4_PHASES = ("search", "window", "runs", "reads", "writes")


def instrument_k4(src: str) -> str:
    done = ("T0", "T1", "T2", "T2 + runs_ns", "T2 + runs_ns + reads_ns",
            "now()", "0")
    return pt.patch(src, [
        ("namespace {\n", pt.prelude(K4_WORDS)),
        ("  __shared__ int s_start[EX_TILE];\n  __shared__ int s_lo;\n",
         "  __shared__ int s_start[EX_TILE];\n  __shared__ int s_lo;\n"
         "  __shared__ volatile uint32_t s_sink;\n" + pt.stamp("T0")
         + "  const unsigned vt = blockIdx.y * gridDim.x + blockIdx.x;\n"
         "  unsigned long long runs_ns = 0, reads_ns = 0;\n"),
        ("    }\n    return;\n  }\n",
         "    }\n    __syncthreads();\n"
         + pt.store("vt", ["T0"] * 5 + ["now()", "1"])
         + "    return;\n  }\n"),
        ("    if (tid == 0) s_lo = max(lo - 1, 0);\n  }\n  __syncthreads();\n",
         "    if (tid == 0) s_lo = max(lo - 1, 0);\n  }\n  __syncthreads();\n"
         + pt.stamp("T1")),
        ("s_start[k] = __ldg(start + r_lo + k);\n  __syncthreads();\n",
         "s_start[k] = __ldg(start + r_lo + k);\n  __syncthreads();\n"
         + pt.stamp("T2")),
        ("    const long long j = j0 + s * EX_STEP + tid * EX_V;\n"
         "    // each output's run",
         "    __syncthreads();\n  " + pt.stamp("TS0")
         + "    const long long j = j0 + s * EX_STEP + tid * EX_V;\n"
         "    // each output's run"),
        ("      valid[q] = j + q < n_out;\n    }\n",
         "      valid[q] = j + q < n_out;\n    }\n    __syncthreads();\n  "
         + pt.stamp("TS1") + "    runs_ns += TS1 - TS0;\n"),
        ("    store4(aidx + ow, j, cap_e, vec, av[0]);\n",
         "    {  // wait for every load of the step\n"
         "      uint32_t x = 0;\n"
         "#pragma unroll\n"
         "      for (int p = 0; p < 2 + LG; ++p)\n"
         "#pragma unroll\n"
         "        for (int q = 0; q < EX_V; ++q)\n"
         "          x ^= av[p][q] ^ (p < 1 + LG ? bv[p][q] : 0u);\n"
         "      if (x == 0x9e3779b9u) s_sink = x;\n"
         "    }\n    __syncthreads();\n    reads_ns += now() - TS1;\n"
         "    store4(aidx + ow, j, cap_e, vec, av[0]);\n"),
        ("          store4(blanes + (l0 + l) * plane + ow, j, cap_e, vec, "
         "v[l]);\n    }\n  }\n}\n",
         "          store4(blanes + (l0 + l) * plane + ow, j, cap_e, vec, "
         "v[l]);\n    }\n  }\n  __syncthreads();\n"
         + pt.store("vt", done) + "}\n"),
    ]) + """
extern "C" int read_stamps(void* dst) {
  cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));
  return (int)cudaGetLastError();
}
"""


def k4_phases(torch, lib, go, n_tiles: int) -> dict:
    stamps = np.zeros(K4_WORDS * pt.MAX_TILES, np.uint64)
    pt.stamped(torch, go, lambda: lib.read_stamps(stamps.ctypes.data))
    t = stamps[:K4_WORDS * n_tiles].reshape(n_tiles, K4_WORDS) \
        .astype(np.int64)
    fill = t[:, -1] == 1
    t = t[:, :-1]
    span = (t[:, -1].max() - t[:, 0].min()) / 1e3
    return {"tiles": n_tiles, "fill_tiles": int(fill.sum()),
            "span_us": span, "tiles_per_us": n_tiles / span,
            "fill_tile_us": pt.pct((t[fill, -1] - t[fill, 0]) / 1e3)
            if fill.any() else None,
            "work_tile_us": pt.pct((t[~fill, -1] - t[~fill, 0]) / 1e3),
            "phase_us": pt.span_stats(t[~fill], K4_PHASES)["phase_us"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch, cs, ct, K, card = pt.init("k1_k4_phases")
    K.build()
    jobs = {"k4_phases": ("join_stream", instrument_k4(
        K.SOURCES["join_stream"].read_text()), None)}
    for name, vs in VARIANTS.items():
        for tag, subs in vs.items():
            jobs[tag] = (name, pt.patch(K.SOURCES[name].read_text(), subs),
                         None)
    libs = pt.build(K, jobs, "k1_k4_phases")
    libs["k4_phases"].read_stamps.argtypes = [ctypes.c_void_p]
    st = torch.cuda.current_stream().cuda_stream

    rec = pt.record_join(torch, cs, ct, K, args.rows)

    # K4 at its first inputs
    (cnt, a_s, b_s, cap_e), _ = rec.calls["join_expand_stream"]
    La, Lb = a_s.shape[0] - 3, b_s.shape[0] - 1
    w, na = a_s.shape[1:]
    nb = b_s.shape[2]
    outs = [torch.empty(w, cap_e, dtype=torch.int32, device="cuda")
            for _ in range(2)] + [
        torch.empty(max(L, 1), w, cap_e, dtype=torch.int32, device="cuda")
        for L in (La, Lb)]
    ref = K.plain_join_expand_stream(cnt, a_s, b_s, cap_e)

    def k4(lib):
        def go():
            assert lib.launch_join_expand(
                cnt.data_ptr(), a_s.data_ptr(), La, na, b_s.data_ptr(), Lb,
                nb, w, cap_e, *(x.data_ptr() for x in outs), st) == 0
        return go

    def k4_equal() -> bool:
        return (torch.equal(outs[0], ref[0]) and torch.equal(outs[1], ref[1])
                and all(torch.equal(outs[2][i], x) for i, x in
                        enumerate(ref[2]))
                and all(torch.equal(outs[3][i], x) for i, x in
                        enumerate(ref[3])))

    res = {"card": card, "k4_shape": {"cap_e": cap_e, "W": w, "La": La,
                                     "Lb": Lb, "n_out": cnt[:, 0].tolist(),
                                     "n_emit": cnt[:, 1].tolist()}}
    tiles = -(-cap_e // K.EXPAND_TILE)
    res["k4_phases"] = k4_phases(torch, libs["k4_phases"],
                                 k4(libs["k4_phases"]), w * tiles)
    assert k4_equal(), "instrumented K4 disagrees"

    # K1 at its first inputs
    (t, nbk), _ = rec.calls["partition_hist"]
    del rec
    n = t.shape[1]
    htiles = -(-n // K.PARTITION_TILE)
    hist = torch.empty(w, htiles, nbk, dtype=torch.int32, device="cuda")
    href = K.plain_partition_hist(t, nbk)

    def k1(lib):
        def go():
            assert lib.launch_partition_hist(
                t.data_ptr(), hist.data_ptr(), w, n, htiles, nbk, st) == 0
        return go

    committed = {"join_stream": K.load_library("join_stream"),
                 "partition": K.load_library("partition")}
    runs = {"join_expand_stream": (k4, k4_equal, "join_stream"),
            "partition_hist": (k1, lambda: torch.equal(hist, href),
                               "partition")}
    res["variants"] = {}
    for kname, (mk, equal, src) in runs.items():
        tags = list(VARIANTS[src])
        for tag in tags:
            mk(libs[tag])()
            torch.cuda.synchronize()
            assert equal(), f"{tag} disagrees with the plain {kname}"
        order = ["committed"] + tags + tags[::-1] + ["committed"]
        times = {k: [] for k in ["committed"] + tags}
        for tag in order:
            lib = committed[src] if tag == "committed" else libs[tag]
            times[tag].append(pt.event_ms(torch, mk(lib)))
        mk(committed[src])()
        torch.cuda.synchronize()
        assert equal(), f"committed {kname} disagrees"
        res["variants"][kname] = times
    return pt.finish(res, args.out, card)


if __name__ == "__main__":
    sys.exit(main())
