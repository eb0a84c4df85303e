// K5 setop_stream: one distinct set operation (UNION, SUBTRACT,
// INTERSECT) over the stream sorted by the 2x32-bit full-row hash, for
// sm_90a.
//
// Replaces the Pallas kernel cylon_tpu/ops/tpu_kernels.py `setop_stream`
// (:544). The TPU kernel is one sequential pass that carries the live-left
// and live-right prefixes, the running max of both sides' run-head
// prefixes, the collision count and the compaction write pointer from grid
// step to grid step in SMEM. CUDA blocks run in no order, so every carry
// becomes a device-wide scan of per-tile aggregates, as in K3:
//   pass 1: per tile, the live-left and live-right counts, the largest
//           in-tile left and right prefixes at a run head (-1 without a
//           head), and the collision count: a live row that is not a run
//           head must be preceded by a live row with the same lanes
//           (`coll = (lane_diff | ~prev_live) & ~neq & live`, :640);
//   (host: exclusive cumsums of the counts, exclusive running max of the
//           head prefixes -> per-tile carries)
//   pass 2: recompute each element's in-run live-left/right counts l_at,
//           r_at from the carries and write the op's emit mask (:657-662).
// The compaction of (tag, lanes...) by that mask is K6 (stream_compact.cu),
// launched by the wrapper; idx = tag & (2^29 - 1). A run boundary or a
// lane comparison at a tile edge reads element i-1 from device memory;
// element 0 is always a run head.
//
// Bound on an H100 (3.35 TB/s): bytes. The function must read h1, h2, tag
// and the L lanes at every element (the collision audit compares the lanes
// everywhere) and write (1 + L) words per output row. Pass 1 reads all
// of that once; pass 2 reads h1, h2 and tag again and writes a one-byte
// mask; the wrapper stacks (tag, lanes...) into K6's input (one more read
// and write of 1 + L words per element); K6 reads the mask twice and the
// stack only at emitted rows. So the design reads about (7 + 2L) words
// per element where (3 + L) must be read, traded for having no carry.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int BT = 256;          // threads per block
constexpr int IT = 8;            // consecutive elements per thread
constexpr int TILE = BT * IT;    // elements per tile

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

using ScanI = cub::BlockScan<int, BT>;
using ReduceI = cub::BlockReduce<int, BT>;

union TempStorage {
  typename ScanI::TempStorage scan;
  typename ReduceI::TempStorage red;
};

// element i starts a run: the first element, or its (h1, h2) differs from
// element i-1's
__device__ __forceinline__ bool run_head(const uint32_t* h1w,
                                         const uint32_t* h2w, long long i) {
  return i == 0 || h1w[i] != h1w[i - 1] || h2w[i] != h2w[i - 1];
}

__device__ __forceinline__ bool tag_side(uint32_t t) { return (t >> 31) & 1u; }
__device__ __forceinline__ bool tag_live(uint32_t t) { return (t >> 29) & 1u; }

__global__ void __launch_bounds__(BT)
setop_pass1(const uint32_t* __restrict__ h1, const uint32_t* __restrict__ h2,
            const uint32_t* __restrict__ tag,
            const uint32_t* __restrict__ lanes, int L, int W, long long n,
            int tiles, int* aggL, int* aggR, int* aggHL, int* aggHR,
            int* aggC) {
  __shared__ TempStorage tmp;
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  const uint32_t* h1w = h1 + (size_t)w * n;
  const uint32_t* h2w = h2 + (size_t)w * n;
  const uint32_t* tw = tag + (size_t)w * n;
  const long long i0 = (long long)tile * TILE + (long long)threadIdx.x * IT;

  int il[IT], ir[IT];
  bool head[IT];
  int suml = 0, sumr = 0, coll = 0;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const long long i = i0 + k;
    il[k] = ir[k] = 0;
    head[k] = false;
    if (i < n) {
      const uint32_t t = tw[i];
      const bool live = tag_live(t);
      il[k] = (tag_side(t) && live) ? 1 : 0;
      ir[k] = (!tag_side(t) && live) ? 1 : 0;
      head[k] = run_head(h1w, h2w, i);
      if (live && !head[k]) {
        bool c = !tag_live(tw[i - 1]);
        for (int v = 0; v < L && !c; ++v) {
          const uint32_t* vw = lanes + ((size_t)v * W + w) * n;
          c = vw[i] != vw[i - 1];
        }
        coll += c ? 1 : 0;
      }
    }
    suml += il[k];
    sumr += ir[k];
  }
  int offl, totl, offr, totr;
  ScanI(tmp.scan).ExclusiveSum(suml, offl, totl);
  __syncthreads();
  ScanI(tmp.scan).ExclusiveSum(sumr, offr, totr);
  __syncthreads();
  int hl = -1, hr = -1;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    if (head[k]) {
      hl = max(hl, offl);
      hr = max(hr, offr);
    }
    offl += il[k];
    offr += ir[k];
  }
  const int bhl = ReduceI(tmp.red).Reduce(hl, MaxOp());
  __syncthreads();
  const int bhr = ReduceI(tmp.red).Reduce(hr, MaxOp());
  __syncthreads();
  const int bc = ReduceI(tmp.red).Sum(coll);
  if (threadIdx.x == 0) {
    const size_t o = (size_t)w * tiles + tile;
    aggL[o] = totl;
    aggR[o] = totr;
    aggHL[o] = bhl;
    aggHR[o] = bhr;
    aggC[o] = bc;
  }
}

__global__ void __launch_bounds__(BT)
setop_pass2(const uint32_t* __restrict__ h1, const uint32_t* __restrict__ h2,
            const uint32_t* __restrict__ tag, long long n, int tiles, int op,
            const int* __restrict__ baseL, const int* __restrict__ baseR,
            const int* __restrict__ baseHL, const int* __restrict__ baseHR,
            uint8_t* __restrict__ emit) {
  __shared__ TempStorage tmp;
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  const size_t to = (size_t)w * tiles + tile;
  const uint32_t* h1w = h1 + (size_t)w * n;
  const uint32_t* h2w = h2 + (size_t)w * n;
  const uint32_t* tw = tag + (size_t)w * n;
  const long long i0 = (long long)tile * TILE + (long long)threadIdx.x * IT;

  uint32_t t[IT];
  bool head[IT];
  int suml = 0, sumr = 0;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const long long i = i0 + k;
    t[k] = 0;  // side 0, live 0: inert
    head[k] = false;
    if (i < n) {
      t[k] = tw[i];
      head[k] = run_head(h1w, h2w, i);
    }
    const bool live = tag_live(t[k]);
    suml += (tag_side(t[k]) && live) ? 1 : 0;
    sumr += (!tag_side(t[k]) && live) ? 1 : 0;
  }
  int offl, offr;
  ScanI(tmp.scan).ExclusiveSum(suml, offl);
  __syncthreads();
  ScanI(tmp.scan).ExclusiveSum(sumr, offr);
  __syncthreads();
  // live rows of each side before this thread's first element
  const int cl0 = baseL[to] + offl;
  const int cr0 = baseR[to] + offr;
  // run-head prefixes are non-decreasing in stream order, so a running
  // max of (head ? prefix : 0) broadcasts each run's head value
  int hl = 0, hr = 0;
  {
    int cl = cl0, cr = cr0;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      if (head[k]) {
        hl = max(hl, cl);
        hr = max(hr, cr);
      }
      const bool live = tag_live(t[k]);
      cl += (tag_side(t[k]) && live) ? 1 : 0;
      cr += (!tag_side(t[k]) && live) ? 1 : 0;
    }
  }
  int pl, pr;
  ScanI(tmp.scan).ExclusiveScan(hl, pl, 0, MaxOp());
  __syncthreads();
  ScanI(tmp.scan).ExclusiveScan(hr, pr, 0, MaxOp());

  int lb = max(baseHL[to], pl), rb = max(baseHR[to], pr);
  int cl = cl0, cr = cr0;
  uint8_t* ew = emit + (size_t)w * n;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const long long i = i0 + k;
    const bool live = tag_live(t[k]);
    const bool left = tag_side(t[k]) && live;
    if (head[k]) {
      lb = max(lb, cl);
      rb = max(rb, cr);
    }
    cl += left ? 1 : 0;
    cr += (!tag_side(t[k]) && live) ? 1 : 0;
    const int l_at = cl - lb;  // inclusive live-left count within the run
    const int r_at = cr - rb;  // inclusive live-right count within the run
    bool e;
    if (op == 0)
      e = live && (l_at + r_at == 1);
    else if (op == 1)
      e = left && l_at == 1 && r_at == 0;
    else
      e = left && l_at == 1 && r_at > 0;
    if (i < n) ew[i] = e ? 1 : 0;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int launch_setop_pass1(const void* h1, const void* h2, const void* tag,
                       const void* lanes, int L, int W, long long n,
                       int tiles, void* aggL, void* aggR, void* aggHL,
                       void* aggHR, void* aggC, void* stream) {
  dim3 grid(tiles, W);
  setop_pass1<<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)h1, (const uint32_t*)h2, (const uint32_t*)tag,
      (const uint32_t*)lanes, L, W, n, tiles, (int*)aggL, (int*)aggR,
      (int*)aggHL, (int*)aggHR, (int*)aggC);
  return static_cast<int>(cudaGetLastError());
}

int launch_setop_pass2(const void* h1, const void* h2, const void* tag,
                       int W, long long n, int tiles, int op,
                       const void* baseL, const void* baseR,
                       const void* baseHL, const void* baseHR, void* emit,
                       void* stream) {
  dim3 grid(tiles, W);
  setop_pass2<<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)h1, (const uint32_t*)h2, (const uint32_t*)tag, n,
      tiles, op, (const int*)baseL, (const int*)baseR, (const int*)baseHL,
      (const int*)baseHR, (uint8_t*)emit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
