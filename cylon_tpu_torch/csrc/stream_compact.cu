// K6 stream_compact: per shard, move the masked elements of L 32-bit
// streams to dense prefixes, in order, and zero the rest, for sm_90a.
//
// Replaces the Pallas kernel cylon_tpu/ops/tpu_kernels.py `stream_compact`
// (:241) and its in-kernel form `_compact_write` (:863), which is also the
// compaction stage of `setop_stream` (:675); K5's wrapper launches this
// kernel for that stage. The TPU kernel walks its grid in order and
// carries the write pointer and a partial output row from block to block,
// moving the selected elements up by staged shifts. CUDA blocks run in no
// order, so the pointer becomes a scan of per-tile counts:
//   count:  per tile, the number of selected elements (warp ballots);
//   (host: exclusive cumsum of the tile counts -> each tile's base)
//   write:  per tile, each warp ranks its selected elements with a ballot
//           and a popcount, adds the counts of the warps before it, and
//           writes every stream at base + rank (stream 0 ANDed with
//           `mask0`, which K5 uses to cut its tag down to the row index).
//           Every block also zeroes its TILE-wide share of
//           [count, out_len).
// A warp owns 8 consecutive 32-element chunks, so each load is one
// coalesced 128-byte row and the ranks follow element order (stable).
//
// Bound on an H100 (3.35 TB/s): bytes. The function must read the mask
// once (1 byte per element), read each stream only at the selected
// elements, write L x count words and zero the L x (out_len - count) tail.
// The design reads the mask twice (count and write passes) and otherwise
// moves exactly those bytes; the tile scan between the passes is a
// [W, n / 2048] torch cumsum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 256;               // threads per block
constexpr int WARPS = BT / 32;
constexpr int IT = 8;                 // 32-element chunks per warp
constexpr int WARP_SPAN = 32 * IT;    // consecutive elements per warp
constexpr int TILE = BT * IT;         // elements per tile
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BT)
compact_count(const uint8_t* __restrict__ mask, long long n, int tiles,
              int* agg) {
  __shared__ int wsum[WARPS];
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* mw = mask + (size_t)w * n;
  const long long e0 =
      (long long)tile * TILE + (long long)warp * WARP_SPAN + lane;
  int c = 0;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const long long i = e0 + k * 32;
    c += __popc(__ballot_sync(FULL, i < n && mw[i] != 0));
  }
  if (lane == 0) wsum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int k = 0; k < WARPS; ++k) t += wsum[k];
    agg[(size_t)w * tiles + tile] = t;
  }
}

__global__ void __launch_bounds__(BT)
compact_write(const uint8_t* __restrict__ mask,
              const uint32_t* __restrict__ streams, int L, int W,
              long long n, long long out_len, int tiles,
              const int* __restrict__ base, const int* __restrict__ counts,
              uint32_t mask0, uint32_t* __restrict__ out) {
  __shared__ int wsum[WARPS];
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (tile < tiles) {  // uniform per block: the barrier below is safe
    const uint8_t* mw = mask + (size_t)w * n;
    const long long e0 =
        (long long)tile * TILE + (long long)warp * WARP_SPAN + lane;
    unsigned bal[IT];
    int c = 0;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const long long i = e0 + k * 32;
      bal[k] = __ballot_sync(FULL, i < n && mw[i] != 0);
      c += __popc(bal[k]);
    }
    if (lane == 0) wsum[warp] = c;
    __syncthreads();
    long long off = base[(size_t)w * tiles + tile];
    for (int k = 0; k < warp; ++k) off += wsum[k];
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      if ((bal[k] >> lane) & 1u) {
        const long long i = e0 + k * 32;
        const long long p = off + __popc(bal[k] & below);
        for (int s = 0; s < L; ++s)
          out[((size_t)s * W + w) * out_len + p] =
              streams[((size_t)s * W + w) * n + i] & (s == 0 ? mask0 : ~0u);
      }
      off += __popc(bal[k]);
    }
  }
  // zero this block's share of the tail [count, out_len): blocks
  // 0..gridDim.x-1 cover gridDim.x * TILE >= out_len slots past count
  const long long z0 = (long long)counts[w] + (long long)tile * TILE;
  for (long long j = z0 + threadIdx.x; j < z0 + TILE && j < out_len; j += BT)
    for (int s = 0; s < L; ++s) out[((size_t)s * W + w) * out_len + j] = 0u;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int launch_compact_count(const void* mask, int W, long long n, int tiles,
                         void* agg, void* stream) {
  dim3 grid(tiles, W);
  compact_count<<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, tiles, (int*)agg);
  return static_cast<int>(cudaGetLastError());
}

int launch_compact_write(const void* mask, const void* streams, int L,
                         int W, long long n, long long out_len, int tiles,
                         int tiles_out, const void* base, const void* counts,
                         unsigned mask0, void* out, void* stream) {
  dim3 grid(tiles_out, W);
  compact_write<<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const uint32_t*)streams, L, W, n, out_len,
      tiles, (const int*)base, (const int*)counts, mask0, (uint32_t*)out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
