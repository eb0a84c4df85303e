// K5 setop_stream: one distinct set operation (UNION, SUBTRACT,
// INTERSECT) over the stream sorted by the 2x32-bit full-row hash, for
// sm_90a.
//
// Replaces the Pallas kernel cylon_tpu/ops/tpu_kernels.py `setop_stream`
// (:544). The TPU kernel is one sequential pass that carries the live-left
// and live-right prefixes, the running max of both sides' run-head
// prefixes, the collision count and the compaction write pointer from grid
// step to grid step in SMEM. Here the emit mask is one pass too: blocks
// take their tiles in stream order from an atomic counter and carry the
// state across tiles by one scan with decoupled look-back (lookback.cuh):
//   load:  the tile's h1, h2 and tag, plus the element before it, into
//          shared memory with 16-byte loads; each thread owns IT
//          consecutive elements there and compares each with its
//          neighbour for run heads;
//   scan:  one composite per tile and thread: the live-left run composite
//          (count, count before the last run head), the live-right one,
//          and the collision count: a live row that is not a run head must
//          follow a live row with the same lanes
//          (`coll = (lane_diff | ~prev_live) & ~neq & live`, :640; the
//          lanes are read at each element and its neighbour,
//          element-striped across the block);
//   emit:  each element's in-run live-left/right counts l_at, r_at give
//          the op's emit mask (:657-662), staged in shared memory and
//          written as one run per tile; the last tile of each shard writes
//          the shard's collision count.
// Element 0 is always a run head. The compaction of the caller's (tag,
// lanes...) stack by that mask is K6 (stream_compact.cu), launched by the
// wrapper on the stack as it is; K6 also masks the tag down to the row
// index.
//
// Bound on an H100 (3.35 TB/s): bytes. The function must read h1, h2, tag
// and the L lanes at every element and write (1 + L) words per output row.
// This pass reads h1, h2, tag and the lanes once and writes a one-byte
// mask; K6 then reads the mask twice and the stack at the emitted rows.
// So the design moves about (3 + L) words plus 3 mask bytes per element
// beyond the output, where (3 + L) words must be read.

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

// both sides' run composites (live rows, live rows before the last run
// head or -1) and the collision count
struct Sides {
  int cl, hl, cr, hr, coll;
  static constexpr int NW = 3;
  __device__ static Sides identity() { return {0, -1, 0, -1, 0}; }
  __device__ static Sides combine(const Sides& a, const Sides& b) {
    Sides r;
    lookback::run_combine(a.cl, a.hl, b.cl, b.hl, r.cl, r.hl);
    lookback::run_combine(a.cr, a.hr, b.cr, b.hr, r.cr, r.hr);
    r.coll = a.coll + b.coll;
    return r;
  }
  __device__ unsigned long long word(int k) const {
    return k == 0 ? lookback::pack_run(cl, hl)
         : k == 1 ? lookback::pack_run(cr, hr)
                  : (unsigned long long)(unsigned)coll;
  }
  __device__ static Sides from_words(const unsigned long long* w) {
    return {lookback::run_c(w[0]), lookback::run_h(w[0]),
            lookback::run_c(w[1]), lookback::run_h(w[1]),
            (int)(w[2] & 0x7fffffffull)};
  }
  __device__ Sides shfl_down(int d) const {
    return {__shfl_down_sync(lookback::FULL, cl, d),
            __shfl_down_sync(lookback::FULL, hl, d),
            __shfl_down_sync(lookback::FULL, cr, d),
            __shfl_down_sync(lookback::FULL, hr, d),
            __shfl_down_sync(lookback::FULL, coll, d)};
  }
};

using ScanSides = cub::BlockScan<Sides, BT>;

__device__ __forceinline__ bool tag_side(uint32_t t) { return (t >> 31) & 1u; }
__device__ __forceinline__ bool tag_live(uint32_t t) { return (t >> 29) & 1u; }

__global__ void __launch_bounds__(BT)
setop_stream_kernel(const uint32_t* __restrict__ h1,
                    const uint32_t* __restrict__ h2,
                    const uint32_t* __restrict__ streams, int L, int W,
                    long long n, int tiles, int op, unsigned* next_tile,
                    ScanState st, uint8_t* __restrict__ emit,
                    int* __restrict__ coll_out) {
  __shared__ uint32_t s_h1[SPAN];
  __shared__ uint32_t s_h2[SPAN];
  __shared__ uint32_t s_tag[SPAN];
  __shared__ uint8_t s_emit[TILE];
  __shared__ typename ScanSides::TempStorage tmp;
  __shared__ Sides s_pre, s_agg;
  __shared__ unsigned s_vt;

  const unsigned vt = lookback::take_tile(next_tile, &s_vt);
  const int w = vt / tiles;
  const int tile = vt % tiles;
  const long long t0 = (long long)tile * TILE;  // tile start in its shard
  const long long g0 = (long long)w * n + t0;   // tile start, flat
  const long long total = (long long)W * n;
  const int cnt = (int)max(0LL, min((long long)TILE, n - t0));
  {
    const uint32_t* src[3] = {h1, h2, streams};  // streams row 0: the tag
    uint32_t* dst[3] = {s_h1, s_h2, s_tag};
    lookback::load_tile<BT, HALO, TILE>(src, dst, 3, g0, cnt, total);
  }
  __syncthreads();

  const int j0 = threadIdx.x * IT;
  unsigned headm = 0;
  Sides ta = Sides::identity();
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const int j = j0 + k;
    if (j < cnt) {
      const int x = HALO + j;
      const uint32_t t = s_tag[x];
      const bool live = tag_live(t);
      if (t0 + j == 0 || s_h1[x] != s_h1[x - 1] || s_h2[x] != s_h2[x - 1]) {
        headm |= 1u << k;
        ta.hl = max(ta.hl, ta.cl);
        ta.hr = max(ta.hr, ta.cr);
      }
      ta.cl += (tag_side(t) && live) ? 1 : 0;
      ta.cr += (!tag_side(t) && live) ? 1 : 0;
    }
  }
  for (int j = threadIdx.x; j < cnt; j += BT) {
    const int x = HALO + j;
    if (t0 + j == 0 || !tag_live(s_tag[x])) continue;
    if (s_h1[x] != s_h1[x - 1] || s_h2[x] != s_h2[x - 1]) continue;
    bool c = !tag_live(s_tag[x - 1]);
    for (int v = 0; v < L && !c; ++v) {
      const uint32_t* lane = streams + (size_t)(1 + v) * total;
      c = lane[g0 + j] != lane[g0 + j - 1];
    }
    ta.coll += c ? 1 : 0;
  }

  Sides ex;
  {
    lookback::TilePrefix<Sides> cb{st, (long long)w * tiles, tile, &s_pre,
                                   &s_agg};
    ScanSides(tmp).ExclusiveScan(ta, ex, lookback::Combine<Sides>(), cb);
  }

  {
    int cl = ex.cl, cr = ex.cr, lb = ex.hl, rb = ex.hr;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int j = j0 + k;
      if (j < cnt) {
        const uint32_t t = s_tag[HALO + j];
        const bool live = tag_live(t);
        const bool left = tag_side(t) && live;
        if ((headm >> k) & 1u) {
          lb = max(lb, cl);
          rb = max(rb, cr);
        }
        cl += left ? 1 : 0;
        cr += (!tag_side(t) && live) ? 1 : 0;
        const int l_at = cl - lb;  // inclusive live-left count in the run
        const int r_at = cr - rb;  // inclusive live-right count in the run
        bool e;
        if (op == 0)
          e = live && (l_at + r_at == 1);
        else if (op == 1)
          e = left && l_at == 1 && r_at == 0;
        else
          e = left && l_at == 1 && r_at > 0;
        s_emit[j] = e ? 1 : 0;
      }
    }
  }
  __syncthreads();
  uint8_t* ew = emit + g0;
  for (int j = threadIdx.x; j < cnt; j += BT) ew[j] = s_emit[j];
  if (tile == tiles - 1 && threadIdx.x == 0)
    coll_out[w] = Sides::combine(s_pre, s_agg).coll;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 64-bit words of K5's state for W shards of `tiles` tiles: the tile
// counter, then the look-back state
long long setop_state_words(int W, int tiles) {
  return 1 + lookback::state_words<Sides>((long long)W * tiles);
}

int launch_setop_stream(const void* h1, const void* h2, const void* streams,
                        int L, int W, long long n, int tiles, int op,
                        void* state, void* emit, void* coll, void* stream) {
  const long long T = (long long)W * tiles;
  auto* words = (unsigned long long*)state;
  cudaError_t err = cudaMemsetAsync(
      state, 0, (size_t)setop_state_words(W, tiles) * 8,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  setop_stream_kernel<<<(unsigned)T, BT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)h1, (const uint32_t*)h2, (const uint32_t*)streams, L,
      W, n, tiles, op, (unsigned*)words,
      lookback::state_at<Sides>(words + 1, T), (uint8_t*)emit, (int*)coll);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
