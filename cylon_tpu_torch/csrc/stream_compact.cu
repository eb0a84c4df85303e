// K6 stream_compact: per shard, move the masked elements of L 32-bit
// streams to dense prefixes, in order, and zero the rest, for sm_90a.
//
// Replaces the Pallas kernel cylon_tpu/ops/tpu_kernels.py `stream_compact`
// (:241) and its in-kernel form `_compact_write` (:863), which is also the
// compaction stage of `setop_stream` (:675); K5's wrapper launches this
// kernel for that stage. The TPU kernel walks its grid in order and
// carries the write pointer and a partial output row from block to block,
// moving the selected elements up by staged shifts. Here the pointer is
// one scan with decoupled look-back (lookback.cuh), in one pass. Blocks
// take their tiles in stream order from an atomic counter; each tile
//   loads its mask bytes into shared memory with 16-byte loads and keeps
//   one ballot per 32 rows in registers (warp k owns TILE / WARPS
//   consecutive rows, so ranks follow row order: stable);
//   starts loading stream 0 at its selected rows, reduces its count and
//   gets its exclusive prefix by look-back (one word per tile);
//   zeroes its share of the tail: an unselected row of unselected rank u
//   owns slot out_len - 1 - u, so the tile's unselected rows own one
//   contiguous range, known from its own prefix (the tail is written
//   while the scan runs, however few rows are selected);
//   stages each stream's selected words in shared memory (stream 0 ANDed
//   with `mask0`, which K5 uses to cut its tag down to the row index) and
//   writes them as one coalesced run, loading the next stream meanwhile.
// The last tile of a shard writes its count. The out_len - n slots past
// the unselected ranks, [count, count + out_len - n), are zeroed by slack
// tiles that take counter values after every stream tile and wait for the
// shard's inclusive prefix.
//
// Bound on an H100 (3.35 TB/s): bytes. The function must read the mask
// once (1 byte per element), read each stream only at the selected
// elements, write L x count words and zero the L x (out_len - count)
// tail. The pass moves exactly those bytes and the look-back state (two
// 8-byte words per tile).

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::FULL;
using lookback::ScanState;
using lookback::WRITTEN;

constexpr int BT = 256;               // threads per block
constexpr int WARPS = BT / 32;
constexpr int IT = 16;                // 32-row rounds per warp
constexpr int WARP_SPAN = 32 * IT;    // consecutive rows per warp
constexpr int TILE = BT * IT;         // rows per tile
static_assert(TILE == BT * 16, "one 16-byte mask load per thread");
constexpr int BLOCKS = 4;              // blocks resident on an SM

// the selected rows of a stream segment: one scan word
struct Count {
  int c;
  static constexpr int NW = 1;
  __device__ static Count identity() { return {0}; }
  __device__ static Count combine(const Count& a, const Count& b) {
    return {a.c + b.c};
  }
  __device__ unsigned long long word(int) const {
    return (unsigned long long)(unsigned)c;
  }
  __device__ static Count from_words(const unsigned long long* w) {
    return {(int)(w[0] & 0x7fffffffull)};
  }
  __device__ Count shfl_down(int d) const {
    return {__shfl_down_sync(FULL, c, d)};
  }
};

__device__ __forceinline__ void zero_range(uint32_t* out, int L, int W,
                                           int w, long long out_len,
                                           long long lo, long long hi) {
  for (int s = 0; s < L; ++s) {
    uint32_t* o = out + ((size_t)s * W + w) * out_len;
    for (long long j = lo + threadIdx.x; j < hi; j += BT) o[j] = 0u;
  }
}

// mask: [W, n]; streams: [L, W, n]; out: [L, W, out_len]; st: one word
// per stream tile; grid: W * tiles stream tiles, then W * slack slack
// tiles of TILE slots each. Four blocks an SM (at most 64 registers a
// thread, no spills): the compiler's own choice fits two, which leaves
// too few tiles in flight.
__global__ void __launch_bounds__(BT, BLOCKS)
stream_compact_kernel(const uint8_t* __restrict__ mask,
                      const uint32_t* __restrict__ streams, int L, int W,
                      long long n, long long out_len, int tiles, int slack,
                      uint32_t mask0, unsigned* next_tile, ScanState st,
                      uint32_t* __restrict__ out, int* __restrict__ counts) {
  __shared__ __align__(16) uint8_t s_mask[TILE];
  __shared__ uint32_t s_buf[TILE];
  __shared__ int s_woff[WARPS];
  __shared__ int s_excl, s_cnt;
  __shared__ unsigned s_vt;

  const unsigned vt = lookback::take_tile(next_tile, &s_vt);
  const long long stream_tiles = (long long)W * tiles;
  if (vt >= stream_tiles) {
    // slack tile: every stream tile started before it, so the wait ends
    const long long q = vt - stream_tiles;
    const int w = (int)(q / slack);
    const long long k = q % slack;
    if (threadIdx.x == 0) {
      const unsigned long long* p = st.incl + (long long)w * tiles + tiles - 1;
      unsigned long long x;
      while (!((x = lookback::ld_relaxed(p)) & WRITTEN)) __nanosleep(64);
      s_cnt = (int)(unsigned)x;
    }
    __syncthreads();
    const long long lo = s_cnt + k * TILE;
    zero_range(out, L, W, w, out_len, lo, min(lo + TILE, s_cnt + out_len - n));
    return;
  }

  const int w = (int)(vt / tiles);
  const int tile = (int)(vt % tiles);
  const long long t0 = (long long)tile * TILE;
  const int cnt = (int)max(0LL, min((long long)TILE, n - t0));
  const size_t g0 = (size_t)w * n + t0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  {
    const uint8_t* src = mask + g0;
    const int off = (int)((uintptr_t)src & 15);
    if (off == 0 && cnt == TILE) {
      reinterpret_cast<uint4*>(s_mask)[tid] =
          __ldg(reinterpret_cast<const uint4*>(src) + tid);
    } else {
      // aligned 16-byte chunks around [src, src + cnt); bytes outside it
      // read as 0 (an aligned chunk holding a valid byte is mapped)
      const uint4* a = reinterpret_cast<const uint4*>(src - off);
      const int chunks = (off + cnt + 15) >> 4;
      for (int c = tid; c <= TILE / 16; c += BT) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < chunks) v = __ldg(a + c);
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int j = c * 16 + i - off;
          if (j >= 0 && j < TILE) s_mask[j] = j < cnt ? bytes[i] : 0;
        }
      }
    }
  }
  __syncthreads();
  unsigned bal[IT];
  int c = 0;
#pragma unroll
  for (int r = 0; r < IT; ++r) {
    bal[r] = __ballot_sync(FULL, s_mask[warp * WARP_SPAN + r * 32 + lane] != 0);
    c += __popc(bal[r]);
  }
  const size_t plane = (size_t)W * n;
  uint32_t v[IT];
  auto load = [&](int s) {
    const uint32_t* src = streams + s * plane + g0 + warp * WARP_SPAN + lane;
#pragma unroll
    for (int r = 0; r < IT; ++r)
      v[r] = (bal[r] >> lane) & 1u ? __ldg(src + r * 32) : 0u;
  };
  if (L > 0) load(0);  // in flight across the look-back
  if (lane == 0) s_woff[warp] = c;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < WARPS ? s_woff[lane] : 0;
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    const int total = __shfl_sync(FULL, inc, 31);
    __syncwarp();
    if (lane < WARPS) s_woff[lane] = inc - x;
    const long long gi = (long long)w * tiles + tile;
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) lookback::publish(st, gi, true, Count{total});
    } else {
      if (lane == 0) lookback::publish(st, gi, false, Count{total});
      excl = lookback::look_back<Count>(st, (long long)w * tiles, tile).c;
      if (lane == 0) lookback::publish(st, gi, true, Count{excl + total});
    }
    if (lane == 0) {
      s_excl = excl;
      s_cnt = total;
      if (tile == tiles - 1) counts[w] = excl + total;
    }
  }
  __syncthreads();
  const int excl = s_excl;
  const int total = s_cnt;
  // unselected ranks [u0, u0 + cnt - total) -> slots (out_len - 1 - u)
  const long long u0 = t0 - excl;
  zero_range(out, L, W, w, out_len, out_len - u0 - (cnt - total),
             out_len - u0);
  const int wo = s_woff[warp];
  for (int s = 0; s < L; ++s) {
    const uint32_t m = s == 0 ? mask0 : ~0u;
    int p = wo;
#pragma unroll
    for (int r = 0; r < IT; ++r) {
      if ((bal[r] >> lane) & 1u) s_buf[p + __popc(bal[r] & below)] = v[r] & m;
      p += __popc(bal[r]);
    }
    __syncthreads();
    if (s + 1 < L) load(s + 1);
    uint32_t* o = out + ((size_t)s * W + w) * out_len + excl;
    for (int j = tid; j < total; j += BT) o[j] = s_buf[j];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 64-bit words of K6's state for W shards of `tiles` tiles: the tile
// counter, then the look-back state
long long compact_state_words(int W, int tiles) {
  return 1 + lookback::state_words<Count>((long long)W * tiles);
}

int launch_stream_compact(const void* mask, const void* streams, int L,
                          int W, long long n, long long out_len, int tiles,
                          int slack, unsigned mask0, void* state, void* out,
                          void* counts, void* stream) {
  const long long T = (long long)W * tiles;
  auto* words = (unsigned long long*)state;
  cudaError_t err = cudaMemsetAsync(
      state, 0, (size_t)compact_state_words(W, tiles) * 8,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_compact_kernel<<<(unsigned)(T + (long long)W * slack), BT, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const uint32_t*)streams, L, W, n, out_len,
      tiles, slack, mask0, (unsigned*)words,
      lookback::state_at<Count>(words + 1, T), (uint32_t*)out, (int*)counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
