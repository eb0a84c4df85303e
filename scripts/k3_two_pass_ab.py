"""K3 join_plan_stream: the single-pass look-back kernel against a
two-kernel design on one card, at the join's main-path inputs.

    python3 scripts/k3_two_pass_ab.py [--rows N] [--out PATH]

The two-kernel design is made from ``csrc/join_stream.cu`` by a source
patch, so both share every line but the carry: pass 1 reduces each tile
to its scan value (``Plan``) and stops; one block per shard scans the tile
values; pass 2 reads the stream again, takes its tile's exclusive prefix
from that scan instead of looking back, and writes the groups. (Three
launches and a second read of bits and tag, for no look-back.)

Runs ``chip_smoke.py``'s world-4 join (2 x N rows) once to record K3's
inputs, then times both launchers alone (CUDA events, median of 20 calls,
in turns) and checks both against the plain version. Prints one JSON line
and the card's name and power limit. Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PASS_PREFIX = r'''
// the two-kernel design's carry: pass 1 stores the tile's value, pass 2
// takes the exclusive prefix that plan_scan computed
struct PassPrefix {
  Plan* aggs;
  const Plan* pres;
  long long g;
  Plan* s_excl;
  Plan* s_agg;
  int pass;
  __device__ Plan operator()(const Plan& agg) {
    Plan ex = Plan::identity();
    if (pass == 1) {
      if ((threadIdx.x & 31) == 0) aggs[g] = agg;
    } else {
      ex = pres[g];
    }
    if ((threadIdx.x & 31) == 0) {
      *s_excl = ex;
      *s_agg = agg;
    }
    return ex;
  }
};

__global__ void __launch_bounds__(BT)
plan_scan(const Plan* aggs, Plan* pres, int tiles) {
  __shared__ typename ScanPlan::TempStorage tmp;
  struct Running {
    Plan run;
    __device__ Plan operator()(const Plan& agg) {
      const Plan old = run;
      run = Plan::combine(run, agg);
      return old;
    }
  } cb{Plan::identity()};
  const long long base = (long long)blockIdx.x * tiles;
  for (int t0 = 0; t0 < tiles; t0 += BT) {
    const int t = t0 + threadIdx.x;
    const Plan v = t < tiles ? aggs[base + t] : Plan::identity();
    Plan ex;
    ScanPlan(tmp).ExclusiveScan(v, ex, lookback::Combine<Plan>(), cb);
    if (t < tiles) pres[base + t] = ex;
    __syncthreads();
  }
}

'''


def two_pass_source(src: str) -> str:
    def sub(s, a, b):
        assert s.count(a) == 1, a
        return s.replace(a, b)

    s = sub(src, "__global__ void __launch_bounds__(BT, BLOCKS)\nplan_stream(",
            PASS_PREFIX + "template <int PASS>\n"
            "__global__ void __launch_bounds__(BT, BLOCKS)\nplan_stream(")
    s = sub(s, "lookback::take_tile(next_tile, &s_vt)",
            "lookback::take_tile(next_tile + (PASS == 2), &s_vt)")
    s = sub(s, "    lookback::TilePrefix<Plan> cb{st, (long long)w * tiles, "
               "tile, &s_pre,\n                                  &s_agg};",
            "    PassPrefix cb{(Plan*)st.agg, (const Plan*)st.agg + st.T, "
            "(long long)w * tiles + tile, &s_pre, &s_agg, PASS};")
    s = sub(s, "  const Plan incl = Plan::combine(s_pre, s_agg);\n",
            "  const Plan incl = Plan::combine(s_pre, s_agg);\n"
            "  if (PASS == 1) return;\n")
    launch = s[s.index("  plan_stream<<<"):]
    launch = launch[:launch.index(";\n") + 2]
    three = (launch.replace("plan_stream<<<", "plan_stream<1><<<")
             + "  plan_scan<<<W, BT, 0, (cudaStream_t)stream>>>(\n"
               "      (const Plan*)(words + 1), (Plan*)(words + 1) + T, "
               "tiles);\n"
             + launch.replace("plan_stream<<<", "plan_stream<2><<<"))
    return sub(s, launch, three)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3_two_pass_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K

    card = cs.card_line()
    print(card, flush=True)
    K.build(["join_stream"])
    vdir = K.BUILD_DIR / "two_pass"
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "lookback.cuh").write_text((K.CSRC / "lookback.cuh").read_text())
    (vdir / "join_stream.cu").write_text(
        two_pass_source(K.SOURCES["join_stream"].read_text()))
    so = vdir / "libjoin_stream_two_pass.so"
    subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", str(so),
                    str(vdir / "join_stream.cu")], check=True,
                   stdout=open(vdir / "build.log", "w"),
                   stderr=subprocess.STDOUT)
    libs = {"single_pass": K.load_library("join_stream"),
            "two_pass": ctypes.CDLL(str(so))}
    for lib in libs.values():
        lib.launch_plan_stream.argtypes = \
            K._SIGNATURES["join_stream"]["launch_plan_stream"]
        lib.launch_plan_stream.restype = ctypes.c_int
        lib.plan_state_words.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.plan_state_words.restype = ctypes.c_longlong

    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    left, right, _h = cs.make_tables(ct, dctx, args.rows, 0)
    with cs.Recorder(K) as rec:
        out = left.distributed_join(right, "inner", on=["k"],
                                    force_exchange=True)
        torch.cuda.synchronize()
    del out, left, right
    _a, kw = rec.calls["join_plan_stream"]
    ref = K.plain_join_plan_stream(**kw)
    bits, tag, lanes = kw["bits_s"], kw["tag_s"], list(kw["lanes"])
    w, n = bits.shape
    na, nb = kw["na"], kw["nb"]
    la, lb = kw["n_a_lanes"], kw["n_b_lanes"]
    tiles = -(-n // K.PLAN_TILE)

    def runner(lib):
        state = torch.empty(lib.plan_state_words(w, tiles),
                            dtype=torch.int64, device="cuda")
        oa = torch.empty(3 + la, w, na, dtype=torch.int32, device="cuda")
        ob = torch.empty(1 + lb, w, nb, dtype=torch.int32, device="cuda")
        cnt = torch.empty(w, 4, dtype=torch.int32, device="cuda")
        st = torch.cuda.current_stream().cuda_stream

        def go():
            rc = lib.launch_plan_stream(
                bits.data_ptr(), tag.data_ptr(), None, K._ptrs([]), 0,
                K._ptrs(lanes), len(lanes), la, lb, w, n, tiles, 0, na, nb,
                state.data_ptr(), oa.data_ptr(), ob.data_ptr(),
                cnt.data_ptr(), st)
            assert rc == 0, rc
        return go, (cnt, oa, ob)

    res = {"card": card, "shape": [w, n], "lanes": len(lanes), "ms": {},
           "equal_plain": {}}
    runs = {k: runner(v) for k, v in libs.items()}
    for name in ("single_pass", "two_pass", "two_pass", "single_pass"):
        go, outs = runs[name]
        res["ms"].setdefault(name, []).append(cs.cuda_ms(go, reps=20,
                                                         warm=3))
        torch.cuda.synchronize()
        ok = torch.equal(outs[0], ref[0])
        for r in range(w):
            ne, nbl = int(ref[0][r, 1]), int(ref[0][r, 2])
            ok = ok and torch.equal(outs[1][:, r, :ne], ref[1][:, r, :ne]) \
                and torch.equal(outs[2][:, r, :nbl], ref[2][:, r, :nbl])
        res["equal_plain"][name] = bool(ok)
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    return 0 if all(res["equal_plain"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
