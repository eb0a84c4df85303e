// K3 join_plan_stream and K4 join_expand_stream: the local join's plan
// and expansion over the key-sorted stream, for sm_90a.
//
// K3 replaces the Pallas kernel cylon_tpu/ops/tpu_kernels.py
// `join_plan_stream` (:317). The TPU kernel is one sequential pass that
// carries the live-build prefix, the run-head running max, the output
// offset and two compaction write pointers from grid step to grid step in
// SMEM. CUDA blocks run in no order, so every carry becomes a device-wide
// scan of per-tile aggregates:
//   pass 1: per tile, the live-build count, the largest in-tile build
//           prefix at a run head, and the hash-collision count;
//   (host: exclusive cumsum of the build counts, running max of the head
//           prefixes -> per-tile carries)
//   pass 2: per tile, the sum of the per-row multiplicity mm and the
//           count of emitting probe rows;
//   (host: exclusive cumsums -> per-tile output offset and group-A base)
//   pass 3: recompute the pass-2 state from the inputs and write groups A
//           (idx, delta2, start, lanes) and B (idx - na, lanes).
// A run boundary at a tile edge is found by reading element i-1 directly.
// Arithmetic follows the TPU kernel's int32 wrap-around (sums in uint32).
//
// K4 replaces `join_expand_stream` (:706): one thread per output row j
// binary-searches group A's strictly increasing starts over [0, n_emit)
// for its covering probe run, then gathers the build row at
// j + (delta2 >> 1) (arithmetic shift: the delta may be negative).
//
// Bound on an H100 (3.35 TB/s): bytes. K3 must read the stream once
// ((2 + bits2 + verify) x 4 bytes per element, and the La or Lb payload
// lanes only at the group A or group B elements) and write the
// compacted groups once; the three passes read the stream three times
// (passes 2 and 3 read only bits, tag and, in pass 3, the lanes), so the
// design costs about 3x the read floor, traded for having no carry. K4
// must write (2 + La + Lb) x 4 bytes per output row and read group A and
// the matched rows of group B; its binary search reads log2(n_emit) starts per row, mostly from L2.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int BT = 256;          // threads per block
constexpr int IT = 8;            // consecutive elements per thread
constexpr int TILE = BT * IT;    // elements per tile
constexpr int EXPAND_THREADS = 256;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

using ScanI = cub::BlockScan<int, BT>;
using ScanU = cub::BlockScan<unsigned, BT>;
using ReduceI = cub::BlockReduce<int, BT>;
using ReduceU = cub::BlockReduce<unsigned, BT>;

union TempStorage {
  typename ScanI::TempStorage scan_i;
  typename ScanU::TempStorage scan_u;
  typename ReduceI::TempStorage red_i;
  typename ReduceU::TempStorage red_u;
};

// element i starts a run: the first element, or its key (bits, and bits2
// in hash mode) differs from element i-1's
__device__ __forceinline__ bool run_head(const uint32_t* bw,
                                         const uint32_t* b2w, long long i) {
  if (i == 0) return true;
  bool d = bw[i] != bw[i - 1];
  if (b2w != nullptr) d = d || (b2w[i] != b2w[i - 1]);
  return d;
}

__device__ __forceinline__ bool tag_side(uint32_t t) { return (t >> 31) & 1u; }
__device__ __forceinline__ bool tag_emit(uint32_t t) { return (t >> 30) & 1u; }
__device__ __forceinline__ bool tag_live(uint32_t t) { return (t >> 29) & 1u; }
__device__ __forceinline__ uint32_t tag_idx(uint32_t t) {
  return t & ((1u << 29) - 1u);
}

__global__ void __launch_bounds__(BT)
plan_pass1(const uint32_t* __restrict__ bits, const uint32_t* __restrict__ tag,
           const uint32_t* __restrict__ bits2,
           const uint32_t* __restrict__ verify, int nv, int W, long long n,
           int tiles, int* aggB, int* aggH, int* aggC) {
  __shared__ TempStorage tmp;
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  const uint32_t* bw = bits + (size_t)w * n;
  const uint32_t* tw = tag + (size_t)w * n;
  const uint32_t* b2w = bits2 ? bits2 + (size_t)w * n : nullptr;
  const long long i0 = (long long)tile * TILE + (long long)threadIdx.x * IT;

  int ib[IT];
  bool head[IT];
  int sumb = 0, coll = 0;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const long long i = i0 + k;
    ib[k] = 0;
    head[k] = false;
    if (i < n) {
      const uint32_t t = tw[i];
      const bool live = tag_live(t);
      ib[k] = (!tag_side(t) && live) ? 1 : 0;
      head[k] = run_head(bw, b2w, i);
      if (nv > 0 && live && !head[k]) {
        // hash-collision audit: adjacent live rows of one run must agree
        // on every true-key lane; a live row below a dead one also counts
        bool c = !tag_live(tw[i - 1]);
        for (int v = 0; v < nv; ++v) {
          const uint32_t* vw = verify + ((size_t)v * W + w) * n;
          c = c || (vw[i] != vw[i - 1]);
        }
        coll += c ? 1 : 0;
      }
    }
    sumb += ib[k];
  }
  int off, total;
  ScanI(tmp.scan_i).ExclusiveSum(sumb, off, total);
  int hmax = -1;
  int run = off;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    if (head[k]) hmax = max(hmax, run);
    run += ib[k];
  }
  __syncthreads();
  const int bh = ReduceI(tmp.red_i).Reduce(hmax, MaxOp());
  __syncthreads();
  const int bc = ReduceI(tmp.red_i).Sum(coll);
  if (threadIdx.x == 0) {
    const size_t o = (size_t)w * tiles + tile;
    aggB[o] = total;
    aggH[o] = bh;
    aggC[o] = bc;
  }
}

// WRITE = false: pass 2 (tile aggregates of mm); WRITE = true: pass 3.
template <bool WRITE>
__global__ void __launch_bounds__(BT)
plan_pass23(const uint32_t* __restrict__ bits, const uint32_t* __restrict__ tag,
            const uint32_t* __restrict__ bits2, int W, long long n,
            int tiles, int unmatched, const int* __restrict__ baseB,
            const int* __restrict__ baseH, int* aggM, int* aggA,
            const int* __restrict__ baseOff, const int* __restrict__ baseA,
            const uint32_t* __restrict__ lanes, int La, int Lb,
            long long na, long long nb, uint32_t* outA, uint32_t* outB) {
  __shared__ TempStorage tmp;
  const int w = blockIdx.y;
  const int tile = blockIdx.x;
  const size_t to = (size_t)w * tiles + tile;
  const uint32_t* bw = bits + (size_t)w * n;
  const uint32_t* tw = tag + (size_t)w * n;
  const uint32_t* b2w = bits2 ? bits2 + (size_t)w * n : nullptr;
  const long long i0 = (long long)tile * TILE + (long long)threadIdx.x * IT;

  uint32_t t[IT];
  bool head[IT];
  int sumb = 0;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const long long i = i0 + k;
    t[k] = 0;  // side 0, live 0: inert
    head[k] = false;
    if (i < n) {
      t[k] = tw[i];
      head[k] = run_head(bw, b2w, i);
    }
    sumb += (!tag_side(t[k]) && tag_live(t[k])) ? 1 : 0;
  }
  int offb;
  ScanI(tmp.scan_i).ExclusiveSum(sumb, offb);
  __syncthreads();
  // run-head build prefixes are non-decreasing in key order, so a running
  // max of (head ? prefix : 0) broadcasts each run's head value
  const int cum0 = baseB[to] + offb;  // live-build rows before this thread
  int hmax = 0;
  {
    int c = cum0;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      if (head[k]) hmax = max(hmax, c);
      c += (!tag_side(t[k]) && tag_live(t[k])) ? 1 : 0;
    }
  }
  int pmax;
  ScanI(tmp.scan_i).ExclusiveScan(hmax, pmax, 0, MaxOp());
  __syncthreads();

  int bb[IT], mm[IT], effm[IT];
  unsigned summ = 0;
  int cnta = 0;
  {
    int bbrun = max(baseH[to], pmax);
    int c = cum0;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const bool side = tag_side(t[k]);
      const bool live = tag_live(t[k]);
      const int ibk = (!side && live) ? 1 : 0;
      if (head[k]) bbrun = max(bbrun, c);
      c += ibk;  // inclusive live-build prefix
      bb[k] = bbrun;
      effm[k] = live ? c - bbrun : 0;
      if (unmatched)
        mm[k] = (side && tag_emit(t[k])) ? max(effm[k], 1) : 0;
      else
        mm[k] = (side && live) ? effm[k] : 0;
      summ += (unsigned)mm[k];
      cnta += mm[k] > 0 ? 1 : 0;
    }
  }
  if (!WRITE) {
    const unsigned tm = ReduceU(tmp.red_u).Sum(summ);
    __syncthreads();
    const int ta = ReduceI(tmp.red_i).Sum(cnta);
    if (threadIdx.x == 0) {
      aggM[to] = (int)tm;
      aggA[to] = ta;
    }
    return;
  }
  unsigned offm;
  ScanU(tmp.scan_u).ExclusiveSum(summ, offm);
  __syncthreads();
  int offa;
  ScanI(tmp.scan_i).ExclusiveSum(cnta, offa);

  unsigned offv = (unsigned)baseOff[to] + offm;
  long long pa = (long long)baseA[to] + offa;
  long long pb = (long long)cum0;
#pragma unroll
  for (int k = 0; k < IT; ++k) {
    const long long i = i0 + k;
    const bool side = tag_side(t[k]);
    const bool live = tag_live(t[k]);
    offv += (unsigned)mm[k];
    if (mm[k] > 0) {
      const unsigned start = offv - (unsigned)mm[k];
      const unsigned delta2 =
          ((unsigned)bb[k] - start) * 2u + (effm[k] > 0 ? 1u : 0u);
      outA[((size_t)0 * W + w) * na + pa] = tag_idx(t[k]);
      outA[((size_t)1 * W + w) * na + pa] = delta2;
      outA[((size_t)2 * W + w) * na + pa] = start;
      for (int l = 0; l < La; ++l)
        outA[((size_t)(3 + l) * W + w) * na + pa] =
            lanes[((size_t)l * W + w) * n + i];
      ++pa;
    }
    if (!side && live) {
      outB[((size_t)0 * W + w) * nb + pb] = tag_idx(t[k]) - (uint32_t)na;
      for (int l = 0; l < Lb; ++l)
        outB[((size_t)(1 + l) * W + w) * nb + pb] =
            lanes[((size_t)l * W + w) * n + i];
      ++pb;
    }
  }
}

__global__ void __launch_bounds__(EXPAND_THREADS)
join_expand(const int* __restrict__ counts, const uint32_t* __restrict__ A,
            int La, long long capA, const uint32_t* __restrict__ B, int Lb,
            long long capB, int W, long long cap_e, int* aidx, int* bidx,
            uint32_t* alanes, uint32_t* blanes) {
  const int w = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap_e) return;
  const int n_out = counts[w * 4 + 0];
  const int n_emit = counts[w * 4 + 1];
  const int* start = (const int*)(A + ((size_t)2 * W + w) * capA);
  // covering run = #{r < n_emit : start[r] <= j} - 1 (starts increase)
  int lo = 0, hi = n_emit;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)start[mid] <= j) lo = mid + 1; else hi = mid;
  }
  const long long woff = lo > 0 ? lo - 1 : 0;
  const int d2 = (int)A[((size_t)1 * W + w) * capA + woff];
  const bool valid = j < n_out;
  const long long bpos = j + (d2 >> 1);
  const bool has = valid && (d2 & 1) && bpos >= 0 && bpos < capB;
  const size_t o = (size_t)w * cap_e + j;
  aidx[o] = valid ? (int)A[((size_t)0 * W + w) * capA + woff] : -1;
  bidx[o] = has ? (int)B[((size_t)0 * W + w) * capB + bpos] : -1;
  for (int l = 0; l < La; ++l)
    alanes[((size_t)l * W + w) * cap_e + j] =
        valid ? A[((size_t)(3 + l) * W + w) * capA + woff] : 0u;
  for (int l = 0; l < Lb; ++l)
    blanes[((size_t)l * W + w) * cap_e + j] =
        has ? B[((size_t)(1 + l) * W + w) * capB + bpos] : 0u;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int plan_tile_rows() { return TILE; }

int launch_plan_pass1(const void* bits, const void* tag, const void* bits2,
                      const void* verify, int nv, int W, long long n,
                      int tiles, void* aggB, void* aggH, void* aggC,
                      void* stream) {
  dim3 grid(tiles, W);
  plan_pass1<<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, (const uint32_t*)tag, (const uint32_t*)bits2,
      (const uint32_t*)verify, nv, W, n, tiles, (int*)aggB, (int*)aggH,
      (int*)aggC);
  return static_cast<int>(cudaGetLastError());
}

int launch_plan_pass2(const void* bits, const void* tag, const void* bits2,
                      int W, long long n, int tiles, int unmatched,
                      const void* baseB, const void* baseH, void* aggM,
                      void* aggA, void* stream) {
  dim3 grid(tiles, W);
  plan_pass23<false><<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, (const uint32_t*)tag, (const uint32_t*)bits2, W,
      n, tiles, unmatched, (const int*)baseB, (const int*)baseH, (int*)aggM,
      (int*)aggA, nullptr, nullptr, nullptr, 0, 0, 0, 0, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

int launch_plan_pass3(const void* bits, const void* tag, const void* bits2,
                      int W, long long n, int tiles, int unmatched,
                      const void* baseB, const void* baseH,
                      const void* baseOff, const void* baseA,
                      const void* lanes, int La, int Lb, long long na,
                      long long nb, void* outA, void* outB, void* stream) {
  dim3 grid(tiles, W);
  plan_pass23<true><<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, (const uint32_t*)tag, (const uint32_t*)bits2, W,
      n, tiles, unmatched, (const int*)baseB, (const int*)baseH, nullptr,
      nullptr, (const int*)baseOff, (const int*)baseA,
      (const uint32_t*)lanes, La, Lb, na, nb, (uint32_t*)outA,
      (uint32_t*)outB);
  return static_cast<int>(cudaGetLastError());
}

int launch_join_expand(const void* counts, const void* A, int La,
                       long long capA, const void* B, int Lb, long long capB,
                       int W, long long cap_e, void* aidx, void* bidx,
                       void* alanes, void* blanes, void* stream) {
  dim3 grid((unsigned)((cap_e + EXPAND_THREADS - 1) / EXPAND_THREADS), W);
  join_expand<<<grid, EXPAND_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (const uint32_t*)A, La, capA, (const uint32_t*)B,
      Lb, capB, W, cap_e, (int*)aidx, (int*)bidx, (uint32_t*)alanes,
      (uint32_t*)blanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
