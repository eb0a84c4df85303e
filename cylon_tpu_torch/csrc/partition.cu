// K1 partition_hist and K2 partition_scatter: the shuffle's stable
// partition by target as a counting sort, for sm_90a.
//
// Replaces the Pallas kernels cylon_tpu/ops/tpu_kernels.py
// `partition_hist` (:1010) and `partition_scatter` (:1053). The TPU pair
// got stability from its sequential, bucket-major grid: one write pointer
// carried from grid step to grid step, the input re-streamed once per
// bucket. CUDA blocks run in no order, so nothing is carried: K1 writes a
// per-tile histogram, the host wrapper turns it into per-(bucket, tile)
// start offsets with one bucket-major exclusive scan (a cumsum over
// W * buckets * tiles values), and K2 recomputes every element's rank
// among the earlier elements of its bucket inside its tile and writes all
// legs to offset + rank. The scatter order is the stable sort by bucket,
// the dead bucket (ids == world) included.
//
// Bound on an H100 (3.35 TB/s): bytes. K1 reads the 4-byte ids once; K2
// reads the ids and the L 4-byte legs once and writes the legs once, so
// K1+K2 move (4 + 8 L) bytes per row, against the TPU design's ~(W+2)
// input passes. A tile's ranks come from warp match/ballot instructions
// and a [warps x buckets] table in shared memory, so no element is read
// twice from device memory except the ids, which K2 reads in two sweeps
// of its own tile (the second from L1/L2).
//
// Limits: nbuckets <= MAX_BUCKETS (256), so a virtual world of up to 255
// shards takes this route.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;          // rows per tile (matches the TPU block)
constexpr int HIST_THREADS = 256;
constexpr int SCAT_WARPS = 32;      // K2: 1024 threads, 128 rows per warp
constexpr int ROWS_PER_WARP = TILE / SCAT_WARPS;
constexpr int MAX_BUCKETS = 256;

__global__ void partition_hist_kernel(const int32_t* __restrict__ t,
                                      int32_t* __restrict__ hist,
                                      long long n, int tiles, int nb) {
  __shared__ int h[MAX_BUCKETS];
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int32_t* tw = t + (size_t)w * n;
  const long long lo = (long long)tile * TILE;
  const long long hi = min(n, lo + TILE);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int b = tw[i];
    if (b >= 0 && b < nb) atomicAdd(&h[b], 1);
  }
  __syncthreads();
  int32_t* out = hist + ((size_t)w * tiles + tile) * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) out[b] = h[b];
}

// offsets: [W, nb, tiles] exclusive bucket-major scan of K1's table.
// legs/out: [L, W, n]. Warp k of a tile owns rows [k*128, k*128+128) of
// it, in four 32-row groups; cnt[k][b] first counts warp k's bucket-b
// rows, then holds the running write position of warp k in bucket b.
__global__ void __launch_bounds__(SCAT_WARPS * 32)
partition_scatter_kernel(const int32_t* __restrict__ t,
                         const uint32_t* __restrict__ legs,
                         uint32_t* __restrict__ out,
                         const int32_t* __restrict__ offsets,
                         int W, long long n, int tiles, int nb, int L) {
  __shared__ int cnt[SCAT_WARPS][MAX_BUCKETS];
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int32_t* tw = t + (size_t)w * n;
  const long long base = (long long)tile * TILE + (long long)warp * ROWS_PER_WARP;

  for (int b = lane; b < nb; b += 32) cnt[warp][b] = 0;
  __syncwarp();
  for (int g = 0; g < ROWS_PER_WARP / 32; ++g) {
    const long long i = base + g * 32 + lane;
    const int b = i < n ? tw[i] : -1;
    const bool in = b >= 0 && b < nb;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (in && lane == __ffs(peers) - 1) cnt[warp][b] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // exclusive scan over warps, per bucket, from the tile's bucket offset
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int run = offsets[((size_t)w * nb + b) * tiles + tile];
    for (int k = 0; k < SCAT_WARPS; ++k) {
      const int c = cnt[k][b];
      cnt[k][b] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int g = 0; g < ROWS_PER_WARP / 32; ++g) {
    const long long i = base + g * 32 + lane;
    const int b = i < n ? tw[i] : -1;
    const bool in = b >= 0 && b < nb;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (in) {
      const long long dst = (long long)cnt[warp][b] + __popc(peers & lt_mask);
      for (int l = 0; l < L; ++l) {
        const size_t row = ((size_t)l * W + w) * n;
        out[row + dst] = legs[row + i];
      }
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) cnt[warp][b] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int max_buckets() { return MAX_BUCKETS; }

int tile_rows() { return TILE; }

int launch_partition_hist(const void* t, void* hist, int W, long long n,
                          int tiles, int nb, void* stream) {
  if (nb < 1 || nb > MAX_BUCKETS) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles, W);
  partition_hist_kernel<<<grid, HIST_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)t, (int32_t*)hist, n, tiles, nb);
  return static_cast<int>(cudaGetLastError());
}

int launch_partition_scatter(const void* t, const void* legs, void* out,
                             const void* offsets, int W, long long n,
                             int tiles, int nb, int L, void* stream) {
  if (nb < 1 || nb > MAX_BUCKETS) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles, W);
  partition_scatter_kernel<<<grid, SCAT_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)t, (const uint32_t*)legs, (uint32_t*)out,
      (const int32_t*)offsets, W, n, tiles, nb, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
