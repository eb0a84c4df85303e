// K3 join_plan_stream and K4 join_expand_stream: the local join's plan
// and expansion over the key-sorted stream, for sm_90a.
//
// K3 replaces the Pallas kernel cylon_tpu/ops/tpu_kernels.py
// `join_plan_stream` (:317). The TPU kernel is one sequential pass that
// carries the live-build prefix, the run-head running max, the output
// offset and two compaction write pointers from grid step to grid step in
// SMEM. Here it is one pass too: blocks take their tiles in stream order
// from an atomic counter and carry the state across tiles by one scan with
// decoupled look-back (lookback.cuh):
//   load:   the tile's bits and tag (and bits2 in hash mode), plus the
//           element before it, into shared memory with 16-byte loads;
//           each thread then owns IT consecutive elements there and
//           compares each with its neighbour for run heads;
//   scan:   one composite value per segment (`Plan`): the live-build
//           count with the run-head prefix, and the sum of the
//           multiplicities mm (uint32) and the count of mm > 0 as a
//           function of the live build rows of the run open at the
//           segment's start, so that the output offset and the group-A
//           position need no second scan -> per element the build prefix,
//           the run's head prefix bb, the output offset and the A rank;
//   write:  each tile's group-A rows (idx, delta2, start, a lanes) fill
//           one contiguous range of every A plane and its group-B rows
//           (idx - na, b lanes) one range of every B plane: ranked in
//           shared memory, then written plane by plane as coalesced runs.
//           Payload lanes are read only at A and B elements, from the
//           caller's lane tensors;
//   counts: the last tile of each shard writes [n_out, n_emit, n_blive,
//           n_collisions] from its inclusive prefix.
// The hash-collision audit (hash mode) reads the verify lanes at each
// element and its neighbour, element-striped across the block.
// Arithmetic follows the TPU kernel's int32 wrap-around (sums in uint32).
//
// K4 replaces `join_expand_stream` (:706). The TPU kernel carries a run
// pointer from grid step to grid step and searches a (BR + 8)-row window
// of group A for each block of outputs. Here each block takes one tile of
// EX_TILE consecutive outputs of one shard, with no carry:
//   fill:   a tile at or past the shard's n_out reads nothing but the
//           counts and writes -1 to aidx and bidx and 0 to every lane
//           plane, as 16-byte stores;
//   search: one warp finds the run that covers the tile's first output
//           with a 32-ary search over group A's strictly increasing
//           starts (each step probes 32 evenly spaced starts, ballots and
//           keeps one interval: ~5 dependent loads at 2.6 M runs);
//   window: every run covers at least one output, so the tile's runs are
//           the next EX_TILE at most; the block loads their starts into
//           shared memory with coalesced loads;
//   rows:   each thread owns EX_V consecutive outputs a step: a binary
//           search in shared memory for its first output's run and a walk
//           for the rest, then two rounds of __ldg loads, group A's idx,
//           delta2 and lanes at the runs and group B's at j + (delta2 >>
//           1) (arithmetic shift: the delta may be negative; consecutive
//           within a run), and one 16-byte store per output plane.
//
// Bound on an H100 (3.35 TB/s): bytes. K3 must read the stream once
// ((2 + bits2 + verify) x 4 bytes per element, and the La or Lb payload
// lanes only at the group A or group B elements) and write the
// compacted groups once; the single pass moves those bytes and nothing
// else but the 64-bit look-back state (10 words a tile). What remains
// between it and the bound is each tile's latency (load, look-back,
// writes) with only a few tiles resident on an SM. K4 must write
// (2 + La + Lb) x 4 bytes per output row and read group A and the matched
// rows of group B; beyond those it reads a window of starts and ~5 probes
// of the search a tile, and tiles past n_out (half of the join cell's)
// only write.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#include "lookback.cuh"

namespace {

using lookback::ScanState;

constexpr int BT = 256;          // threads per block
constexpr int IT = 11;           // consecutive elements per thread (odd:
                                 // shared-memory reads hit 32 banks)
constexpr int TILE = BT * IT;    // elements per tile
constexpr int HALO = 4;          // shared slots before element 0 of a tile
constexpr int SPAN = HALO + TILE + 4;
constexpr int BLOCKS = 4;        // resident blocks an SM is built for
constexpr int MAX_LANES = 8;     // ops/join.py MAX_SHARED_LANES
constexpr int MAX_VERIFY = 8;    // ops/join.py MAX_HASH_KEY_LANES is 6
constexpr int EX_BT = 256;                   // K4 threads per block
constexpr int EX_V = 4;                      // outputs a thread owns a step
constexpr int EX_STEP = EX_BT * EX_V;
constexpr int EX_STEPS = 2;                  // steps a K4 tile
constexpr int EX_TILE = EX_STEP * EX_STEPS;  // outputs per K4 tile
constexpr int EX_BLOCKS = 3;   // K4 blocks an SM: 80 registers a thread
                               // (the compiler's own 158 fit one)
constexpr uint32_t IDX_MASK = (1u << 29) - 1u;

struct Ptrs8 {
  const uint32_t* p[MAX_LANES];
};

// The plan's scan value over a stream segment. (c, h) is the live-build
// run composite: live build rows, and those before the segment's last run
// head (-1 without one). The sum of mm (uint32 wrap-around) and the count
// of rows with mm > 0 depend on what comes before the segment only through
// d, the live build rows of the run that is open at the segment's start,
// and only at the probe rows before the segment's first head: there mm is
// d plus the build rows seen since the segment's start. So a segment
// carries three (sum, count) pairs: before its first head at d = 0 (s0,
// n0) and at d > 0 (s1 + k * d, n1), and from its first head on (sc, nc),
// which no longer depends on d. Composing segments evaluates the later
// one at the earlier one's outgoing d, so one scan with one look-back
// gives every element its build prefix, its run's head prefix, its output
// offset and its group-A rank. coll counts hash collisions.
struct Plan {
  int c, h, k;
  unsigned s0, s1, sc;
  int n0, n1, nc, coll;
  static constexpr int NW = 5;
  __device__ static Plan identity() {
    return {0, -1, 0, 0u, 0u, 0u, 0, 0, 0, 0};
  }
  __device__ static Plan combine(const Plan& a, const Plan& b) {
    Plan r;
    lookback::run_combine(a.c, a.h, b.c, b.h, r.c, r.h);
    r.coll = a.coll + b.coll;
    if (a.h >= 0) {  // b sees the constant d = a.c - a.h
      const int d = a.c - a.h;
      r.k = a.k;
      r.s0 = a.s0;
      r.s1 = a.s1;
      r.n0 = a.n0;
      r.n1 = a.n1;
      r.sc = a.sc + (d > 0 ? b.s1 + (unsigned)b.k * (unsigned)d : b.s0)
             + b.sc;
      r.nc = a.nc + (d > 0 ? b.n1 : b.n0) + b.nc;
    } else {         // b sees d + a.c
      const unsigned ka = (unsigned)b.k * (unsigned)a.c;
      r.k = a.k + b.k;
      r.s1 = a.s1 + b.s1 + ka;
      r.n1 = a.n1 + b.n1;
      r.s0 = a.s0 + (a.c > 0 ? b.s1 + ka : b.s0);
      r.n0 = a.n0 + (a.c > 0 ? b.n1 : b.n0);
      r.sc = b.sc;
      r.nc = b.nc;
    }
    return r;
  }
  __device__ unsigned long long word(int i) const {
    switch (i) {
      case 0: return lookback::pack_run(c, h);
      case 1: return (unsigned long long)s0 | ((unsigned long long)n0 << 32);
      case 2: return (unsigned long long)s1 | ((unsigned long long)n1 << 32);
      case 3: return (unsigned long long)sc | ((unsigned long long)nc << 32);
      default:
        return (unsigned long long)k | ((unsigned long long)coll << 31);
    }
  }
  __device__ static Plan from_words(const unsigned long long* w) {
    constexpr unsigned long long M31 = 0x7fffffffull;
    return {lookback::run_c(w[0]), lookback::run_h(w[0]),
            (int)(w[4] & M31), (unsigned)w[1], (unsigned)w[2],
            (unsigned)w[3], (int)((w[1] >> 32) & M31),
            (int)((w[2] >> 32) & M31), (int)((w[3] >> 32) & M31),
            (int)((w[4] >> 31) & M31)};
  }
  __device__ Plan shfl_down(int d) const {
    using lookback::FULL;
    return {__shfl_down_sync(FULL, c, d), __shfl_down_sync(FULL, h, d),
            __shfl_down_sync(FULL, k, d), __shfl_down_sync(FULL, s0, d),
            __shfl_down_sync(FULL, s1, d), __shfl_down_sync(FULL, sc, d),
            __shfl_down_sync(FULL, n0, d), __shfl_down_sync(FULL, n1, d),
            __shfl_down_sync(FULL, nc, d), __shfl_down_sync(FULL, coll, d)};
  }
};

using ScanPlan = cub::BlockScan<Plan, BT, cub::BLOCK_SCAN_WARP_SCANS>;

__device__ __forceinline__ bool tag_side(uint32_t t) { return (t >> 31) & 1u; }
__device__ __forceinline__ bool tag_emit(uint32_t t) { return (t >> 30) & 1u; }
__device__ __forceinline__ bool tag_live(uint32_t t) { return (t >> 29) & 1u; }

// out[l * stride + r] = lanes.p[l][g0 + src[r]] for l in [4G, 4G + 4) and
// l < L, r < rows: a tile's lane values at its ranked rows. A thread
// issues the loads of 4 rows x 4 lanes before their stores.
template <int G>
__device__ __forceinline__ void gather_group(const Ptrs8& lanes, int L,
                                             long long g0,
                                             const uint16_t* src, int rows,
                                             uint32_t* out, size_t stride) {
  constexpr int U = 4;
  for (int r0 = threadIdx.x; r0 < rows; r0 += U * BT) {
    uint32_t v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * BT;
      const long long i = g0 + src[r < rows ? r : 0];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (r < rows && 4 * G + l < L)
          v[u][l] = __ldg(lanes.p[4 * G + l] + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * BT;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (r < rows && 4 * G + l < L) out[(4 * G + l) * stride + r] = v[u][l];
    }
  }
}

__device__ __forceinline__ void gather_lanes(const Ptrs8& lanes, int L,
                                             long long g0,
                                             const uint16_t* src, int rows,
                                             uint32_t* out, size_t stride) {
  static_assert(MAX_LANES == 8, "two groups of four lanes");
  if (L > 0) gather_group<0>(lanes, L, g0, src, rows, out, stride);
  if (L > 4) gather_group<1>(lanes, L, g0, src, rows, out, stride);
}

__global__ void __launch_bounds__(BT, BLOCKS)
plan_stream(const uint32_t* __restrict__ bits, const uint32_t* __restrict__ tag,
            const uint32_t* __restrict__ bits2, Ptrs8 verify, int nv,
            Ptrs8 lanes, int La, int Lb, int W, long long n, int tiles,
            int unmatched, long long na, long long nb, unsigned* next_tile,
            ScanState st, uint32_t* __restrict__ outA,
            uint32_t* __restrict__ outB, int* __restrict__ counts) {
  __shared__ uint32_t s_bits[SPAN];   // after the scan: group-A delta2
  __shared__ uint32_t s_tag[SPAN];
  __shared__ uint32_t s_bits2[SPAN];  // after the scan: group-A start
  __shared__ uint16_t s_srcA[TILE];
  __shared__ uint16_t s_srcB[TILE];
  __shared__ typename ScanPlan::TempStorage tmp;
  __shared__ Plan s_pre, s_agg;
  __shared__ unsigned s_vt;

  const unsigned vt = lookback::take_tile(next_tile, &s_vt);
  const int w = vt / tiles;
  const int tile = vt % tiles;
  const long long t0 = (long long)tile * TILE;  // tile start in its shard
  const long long g0 = (long long)w * n + t0;   // tile start, flat
  const int cnt = (int)max(0LL, min((long long)TILE, n - t0));
  const bool hash = bits2 != nullptr;
  {
    const uint32_t* src[3] = {bits, tag, bits2};
    uint32_t* dst[3] = {s_bits, s_tag, s_bits2};
    lookback::load_tile<BT, HALO, TILE>(src, dst, hash ? 3 : 2, g0, cnt,
                                        (long long)W * n);
  }
  __syncthreads();

  // run heads and this thread's scan value (see Plan)
  const int j0 = threadIdx.x * IT;
  unsigned headm = 0;
  Plan ta = Plan::identity();
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int j = j0 + k;
    if (j < cnt) {
      const int x = HALO + j;
      const uint32_t t = s_tag[x];
      const bool side = tag_side(t), live = tag_live(t), emit = tag_emit(t);
      if (t0 + j == 0 || s_bits[x] != s_bits[x - 1]
          || (hash && s_bits2[x] != s_bits2[x - 1])) {
        headm |= 1u << k;
        ta.h = ta.c;
      }
      ta.c += (!side && live) ? 1 : 0;
      if (ta.h >= 0) {  // mm no longer depends on what came before
        const int effm = live ? ta.c - ta.h : 0;
        const int m = unmatched ? ((side && emit) ? max(effm, 1) : 0)
                                : ((side && live) ? effm : 0);
        ta.sc += (unsigned)m;
        ta.nc += m > 0 ? 1 : 0;
      } else if (unmatched ? (side && emit) : (side && live)) {
        // mm = d + c when live, and 1 for a dead emitting row (LEFT)
        if (live) {
          ++ta.k;
          ta.s1 += (unsigned)ta.c;
          ta.s0 += (unsigned)(unmatched ? max(ta.c, 1) : ta.c);
          ta.n0 += (unmatched || ta.c > 0) ? 1 : 0;
        } else {
          ta.s1 += 1u;
          ta.s0 += 1u;
          ++ta.n0;
        }
        ++ta.n1;
      }
    }
  }
  // hash-collision audit: a live row that is not a run head must follow a
  // live row with the same true key on every verify lane
  for (int j = threadIdx.x; nv > 0 && j < cnt; j += BT) {
    const int x = HALO + j;
    if (t0 + j == 0 || !tag_live(s_tag[x])) continue;
    if (s_bits[x] != s_bits[x - 1] || (hash && s_bits2[x] != s_bits2[x - 1]))
      continue;
    bool c = !tag_live(s_tag[x - 1]);
    for (int v = 0; v < nv; ++v)
      c = c || verify.p[v][g0 + j] != verify.p[v][g0 + j - 1];
    ta.coll += c ? 1 : 0;
  }

  Plan ex;
  {
    lookback::TilePrefix<Plan> cb{st, (long long)w * tiles, tile, &s_pre,
                                  &s_agg};
    ScanPlan(tmp).ExclusiveScan(ta, ex, lookback::Combine<Plan>(), cb);
  }
  const Plan incl = Plan::combine(s_pre, s_agg);

  // rank the tile's group-A rows (mm > 0) and group-B rows (live build)
  // in shared memory, with each A row's delta2 and start
  uint32_t* s_d2 = s_bits;
  uint32_t* s_start = s_bits2;
  {
    int c = ex.c, bb = ex.h;
    unsigned offv = ex.sc;
    int pa = ex.nc - s_pre.nc;  // rank among the tile's A rows
    int pb = ex.c - s_pre.c;    // rank among the tile's B rows
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int j = j0 + k;
      if (j < cnt) {
        const uint32_t t = s_tag[HALO + j];
        const bool side = tag_side(t), live = tag_live(t);
        const bool ib = !side && live;
        if ((headm >> k) & 1u) bb = max(bb, c);
        c += ib ? 1 : 0;  // inclusive live-build prefix
        const int effm = live ? c - bb : 0;
        const int m = unmatched ? ((side && tag_emit(t)) ? max(effm, 1) : 0)
                                : ((side && live) ? effm : 0);
        if (m > 0) {
          const unsigned start = offv;
          offv += (unsigned)m;
          s_d2[pa] = ((unsigned)bb - start) * 2u + (effm > 0 ? 1u : 0u);
          s_start[pa] = start;
          s_srcA[pa++] = (uint16_t)j;
        }
        if (ib) s_srcB[pb++] = (uint16_t)j;
      }
    }
  }
  __syncthreads();

  // write both groups plane by plane, as contiguous runs
  const size_t pa_ = (size_t)W * na, pb_ = (size_t)W * nb;  // plane strides
  {
    const int nB = s_agg.c;
    uint32_t* oB = outB + (size_t)w * nb + s_pre.c;
    for (int r = threadIdx.x; r < nB; r += BT)
      oB[r] = (s_tag[HALO + s_srcB[r]] & IDX_MASK) - (uint32_t)na;
    gather_lanes(lanes, Lb, g0, s_srcB, nB, oB + pb_, pb_);
  }
  {
    const int nA = incl.nc - s_pre.nc;
    uint32_t* oA = outA + (size_t)w * na + s_pre.nc;
    for (int r = threadIdx.x; r < nA; r += BT) {
      oA[r] = s_tag[HALO + s_srcA[r]] & IDX_MASK;
      oA[pa_ + r] = s_d2[r];
      oA[2 * pa_ + r] = s_start[r];
    }
    gather_lanes(lanes, La, g0, s_srcA, nA, oA + 3 * pa_, pa_);
  }
  if (tile == tiles - 1 && threadIdx.x == 0) {
    counts[w * 4 + 0] = (int)incl.sc;
    counts[w * 4 + 1] = incl.nc;
    counts[w * 4 + 2] = incl.c;
    counts[w * 4 + 3] = incl.coll;
  }
}

// out[j + q] = v[q] for q < EX_V and j + q < end: one 16-byte store when
// all four are in range and `vec` says the plane rows are 16-byte aligned
__device__ __forceinline__ void store4(uint32_t* out, long long j,
                                       long long end, bool vec,
                                       const uint32_t (&v)[EX_V]) {
  static_assert(EX_V == 4, "one uint4 a thread");
  if (vec && j + EX_V <= end) {
    *reinterpret_cast<uint4*>(out + j) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < EX_V; ++q)
      if (j + q < end) out[j + q] = v[q];
  }
}

// A: [3 + La, W, capA] (idx, delta2, start, a lanes); B: [1 + Lb, W, capB]
// (idx, b lanes); outputs [W, cap_e] and [La or Lb, W, cap_e]. Grid:
// (tiles of EX_TILE outputs, W).
__global__ void __launch_bounds__(EX_BT, EX_BLOCKS)
join_expand(const int* __restrict__ counts, const uint32_t* __restrict__ A,
            int La, long long capA, const uint32_t* __restrict__ B, int Lb,
            long long capB, int W, long long cap_e, int vec,
            uint32_t* __restrict__ aidx, uint32_t* __restrict__ bidx,
            uint32_t* __restrict__ alanes, uint32_t* __restrict__ blanes) {
  __shared__ int s_start[EX_TILE];
  __shared__ int s_lo;
  const int w = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * EX_TILE;
  const long long n_out = counts[w * 4 + 0];
  const int n_emit = (int)max(0LL, min((long long)counts[w * 4 + 1], capA));
  const size_t ow = (size_t)w * cap_e;         // the shard's row in a plane
  const size_t plane = (size_t)W * cap_e;
  const int tid = threadIdx.x;

  if (j0 >= n_out) {  // fill only
    const uint32_t neg[EX_V] = {~0u, ~0u, ~0u, ~0u}, zero[EX_V] = {};
#pragma unroll
    for (int s = 0; s < EX_STEPS; ++s) {
      const long long j = j0 + s * EX_STEP + tid * EX_V;
      store4(aidx + ow, j, cap_e, vec, neg);
      store4(bidx + ow, j, cap_e, vec, neg);
      for (int l = 0; l < La; ++l)
        store4(alanes + l * plane + ow, j, cap_e, vec, zero);
      for (int l = 0; l < Lb; ++l)
        store4(blanes + l * plane + ow, j, cap_e, vec, zero);
    }
    return;
  }

  // c = #{r < n_emit : start[r] <= j0}, by one warp: each step probes the
  // last start of each of 32 equal parts of [lo, hi) and keeps the part
  // that holds c (c stays in [lo, hi])
  const int* start = (const int*)(A + ((size_t)2 * W + w) * capA);
  if (tid < 32) {
    int lo = 0, hi = n_emit;
    while (lo < hi) {
      const int s = (hi - lo + 31) >> 5;
      const int p = lo + (tid + 1) * s - 1;
      const bool le = p < hi && (long long)__ldg(start + p) <= j0;
      const int m = __popc(__ballot_sync(lookback::FULL, le));
      hi = min(hi, lo + (m + 1) * s - 1);
      lo += m * s;
    }
    if (tid == 0) s_lo = max(lo - 1, 0);
  }
  __syncthreads();
  // the runs of the tile's outputs below n_out: [r_lo, r_lo + nwin)
  const int r_lo = s_lo;
  const int nwin = (int)min((long long)(n_emit - r_lo),
                            min(n_out, j0 + EX_TILE) - j0);
  for (int k = tid; k < nwin; k += EX_BT) s_start[k] = __ldg(start + r_lo + k);
  __syncthreads();

  const uint32_t* Aw = A + (size_t)w * capA + r_lo;
  const uint32_t* Bw = B + (size_t)w * capB;
  const size_t pa = (size_t)W * capA, pb = (size_t)W * capB;
#pragma unroll
  for (int s = 0; s < EX_STEPS; ++s) {
    const long long j = j0 + s * EX_STEP + tid * EX_V;
    // each output's run in the window: a binary search for the first, a
    // walk for the others
    int lo = 0, hi = nwin;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)s_start[mid] <= j) lo = mid + 1; else hi = mid;
    }
    int k = lo - 1;
    int kq[EX_V];
    bool valid[EX_V];
#pragma unroll
    for (int q = 0; q < EX_V; ++q) {
      if (q > 0)
        while (k + 1 < nwin && (long long)s_start[k + 1] <= j + q) ++k;
      kq[q] = max(k, 0);
      valid[q] = j + q < n_out;
    }
    // plane p of group A at output q's run
    auto a_at = [&](int p, int q) { return __ldg(Aw + p * pa + kq[q]); };
    // two dependent rounds of loads before the stores: group A's idx,
    // delta2 and first lanes at the runs, then group B's idx and first
    // lanes at bpos
    constexpr int LG = 4;  // lanes a round takes; more go four at a time
    uint32_t av[2 + LG][EX_V], bv[1 + LG][EX_V];
#pragma unroll
    for (int p = 0; p < 2 + LG; ++p)
#pragma unroll
      for (int q = 0; q < EX_V; ++q)
        av[p][q] = valid[q] && p < 2 + La ? a_at(p < 2 ? p : p + 1, q)
                                          : (p == 0 ? ~0u : 0u);
    int bpos[EX_V];  // capB < 2^29
    bool has[EX_V];
#pragma unroll
    for (int q = 0; q < EX_V; ++q) {
      const int d2 = (int)av[1][q];
      const long long bp = j + q + (d2 >> 1);
      has[q] = valid[q] && (d2 & 1) && bp >= 0 && bp < capB;
      bpos[q] = has[q] ? (int)bp : 0;
    }
#pragma unroll
    for (int p = 0; p < 1 + LG; ++p)
#pragma unroll
      for (int q = 0; q < EX_V; ++q)
        bv[p][q] = has[q] && p < 1 + Lb ? __ldg(Bw + p * pb + bpos[q])
                                        : (p == 0 ? ~0u : 0u);
    store4(aidx + ow, j, cap_e, vec, av[0]);
    store4(bidx + ow, j, cap_e, vec, bv[0]);
#pragma unroll
    for (int l = 0; l < LG; ++l) {
      if (l < La) store4(alanes + l * plane + ow, j, cap_e, vec, av[2 + l]);
      if (l < Lb) store4(blanes + l * plane + ow, j, cap_e, vec, bv[1 + l]);
    }
    for (int l0 = LG; l0 < La; l0 += 4) {
      uint32_t v[4][EX_V];
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int q = 0; q < EX_V; ++q)
          v[l][q] = (l0 + l < La && valid[q]) ? a_at(3 + l0 + l, q) : 0u;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (l0 + l < La)
          store4(alanes + (l0 + l) * plane + ow, j, cap_e, vec, v[l]);
    }
    for (int l0 = LG; l0 < Lb; l0 += 4) {
      uint32_t v[4][EX_V];
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int q = 0; q < EX_V; ++q)
          v[l][q] = (l0 + l < Lb && has[q])
                        ? __ldg(Bw + (size_t)(1 + l0 + l) * pb + bpos[q])
                        : 0u;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (l0 + l < Lb)
          store4(blanes + (l0 + l) * plane + ow, j, cap_e, vec, v[l]);
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int plan_tile_rows() { return TILE; }

int expand_tile_rows() { return EX_TILE; }

// 64-bit words of K3's state for W shards of `tiles` tiles: the tile
// counter, then the look-back state
long long plan_state_words(int W, int tiles) {
  return 1 + lookback::state_words<Plan>((long long)W * tiles);
}

int launch_plan_stream(const void* bits, const void* tag, const void* bits2,
                       const void* const* verify, int nv,
                       const void* const* lanes, int nl, int La, int Lb,
                       int W, long long n, int tiles, int unmatched,
                       long long na, long long nb, void* state, void* outA,
                       void* outB, void* counts, void* stream) {
  if (nv > MAX_VERIFY || nl > MAX_LANES || La > nl || Lb > nl)
    return static_cast<int>(cudaErrorInvalidValue);
  Ptrs8 ver{}, ln{};
  for (int v = 0; v < nv; ++v) ver.p[v] = (const uint32_t*)verify[v];
  for (int l = 0; l < nl; ++l) ln.p[l] = (const uint32_t*)lanes[l];
  const long long T = (long long)W * tiles;
  auto* words = (unsigned long long*)state;
  cudaError_t err = cudaMemsetAsync(
      state, 0, (size_t)plan_state_words(W, tiles) * 8,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_stream<<<(unsigned)T, BT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, (const uint32_t*)tag, (const uint32_t*)bits2,
      ver, nv, ln, La, Lb, W, n, tiles, unmatched, na, nb, (unsigned*)words,
      lookback::state_at<Plan>(words + 1, T), (uint32_t*)outA,
      (uint32_t*)outB, (int*)counts);
  return static_cast<int>(cudaGetLastError());
}

// One launch: a block per tile of EX_TILE outputs per shard.
int launch_join_expand(const void* counts, const void* A, int La,
                       long long capA, const void* B, int Lb, long long capB,
                       int W, long long cap_e, void* aidx, void* bidx,
                       void* alanes, void* blanes, void* stream) {
  const long long tiles = (cap_e + EX_TILE - 1) / EX_TILE;
  if (tiles > 0x7fffffffLL || W > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = cap_e % 4 == 0 && aligned(aidx) && aligned(bidx)
                  && aligned(alanes) && aligned(blanes);
  join_expand<<<dim3((unsigned)tiles, W), EX_BT, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const uint32_t*)A, La, capA, (const uint32_t*)B,
      Lb, capB, W, cap_e, vec, (uint32_t*)aidx, (uint32_t*)bidx,
      (uint32_t*)alanes, (uint32_t*)blanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
