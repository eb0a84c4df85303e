// K1 partition_hist and K2 partition_scatter: the shuffle's stable
// partition by target as a counting sort, for sm_90a.
//
// Replaces the Pallas kernels cylon_tpu/ops/tpu_kernels.py
// `partition_hist` (:1010) and `partition_scatter` (:1053). The TPU pair
// got stability from its sequential, bucket-major grid: one write pointer
// carried from grid step to grid step, the input re-streamed once per
// bucket. CUDA blocks run in no order, so the pointer becomes one scan per
// bucket, carried across tiles by decoupled look-back (lookback.cuh), as
// in onesweep radix sort for a single digit of at most 256 values:
//
// K1 writes a per-tile histogram [W, tiles, nb]; summed over tiles (a
//    torch reduction in the shuffle) it is each shard's per-bucket total.
//    The TPU kernel counts a block with one vector compare-and-sum per
//    bucket. Here a block takes one tile of one shard; each thread
//    starts all its loads (16 ids, as four 16-byte loads where
//    the shard's rows are 16-byte aligned, else as coalesced 4-byte
//    loads) before it counts. Up to REG_BUCKETS buckets the counts live in
//    registers, byte b of one 64-bit word for bucket b (at most 16 a
//    thread), summed per warp with one __reduce_add_sync per bucket and
//    over the warps in shared memory: no atomics. Past that, each id's
//    warp peers (__match_any_sync) add their number to a shared table
//    with one atomic from the group's leader.
// K2 is one pass. Blocks take their tiles in stream order from an atomic
//    counter. A tile reads its ids once (warp-striped, coalesced), ranks
//    each row within its warp and bucket (`__match_any_sync` and a
//    [warps x buckets] table in shared memory), publishes its per-bucket
//    counts at once, and turns the shard's live-bucket totals into bucket
//    bases and its own counts into bucket starts with one block scan. The
//    block then looks back over the shard's earlier tiles for every
//    bucket's exclusive prefix (`look_back_buckets`: each thread reads a
//    window of WIN predecessors of one bucket, the block combines the
//    windows per bucket; the words sit [tile][bucket]-major, so one step
//    reads contiguous rows). Leg 0's rows are in flight meanwhile. Each
//    leg is staged in shared memory in bucket order and written as one
//    coalesced run per bucket; the next leg's loads overlap the writes.
//    The scatter order is the stable sort by bucket, the dead bucket
//    (ids == nb - 1, placed after the live ones) included.
//
// Bound on an H100 (3.35 TB/s): bytes. K1 must read the ids once and
// write the table (4 bytes per row and 4 per tile and bucket); a tile's
// loads are all in flight at once and the counting costs a few integer
// operations per id, so what remains is the launch and its ramp at ~20 us.
// K2 must read the ids and the L
// 4-byte legs once and write the legs once, plus the [W, nb - 1] totals:
// (4 + 8 L) bytes per row. The pass moves those bytes and the look-back
// state (2 x 8 bytes per tile and bucket, zeroed by the launcher's
// memset). What remains between it and the bound is each tile's latency
// (ids, look-back, one load and one write per leg).
//
// Limits: nbuckets <= MAX_BUCKETS (256), so a virtual world of up to 255
// shards takes this route; MAX_LEGS legs per launch (the launcher runs
// one pass per group of legs).

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#include "lookback.cuh"

namespace {

using lookback::FULL;
using lookback::WRITTEN;

constexpr int TILE = 4096;          // rows per tile (matches the TPU block)
constexpr int HIST_BT = 256;        // K1 threads per block
constexpr int HIST_IT = 16;         // ids a K1 thread loads per tile
constexpr int REG_BUCKETS = 8;      // K1 counts in registers up to here
constexpr int BT = 256;             // K2 threads per block
constexpr int WARPS = BT / 32;
constexpr int IT = TILE / BT;       // rows per thread
constexpr int WARP_ROWS = TILE / WARPS;  // consecutive rows per warp
constexpr int MAX_BUCKETS = 256;
constexpr int MAX_LEGS = 32;        // legs per launch
constexpr int WIN = 4;              // predecessors a look-back thread reads
constexpr int BLOCKS = 3;           // K2 blocks resident on an SM

static_assert(MAX_BUCKETS <= BT, "one scan thread per bucket");
static_assert(HIST_BT * HIST_IT == TILE, "K1 threads cover a tile");

struct Legs {
  const uint32_t* p[MAX_LEGS];
};

using ScanU64 = cub::BlockScan<unsigned long long, BT>;

// hist: [W, tiles, nb]; grid (tiles, W), a block per tile of a shard.
__global__ void __launch_bounds__(HIST_BT)
partition_hist_kernel(const int32_t* __restrict__ t,
                      int32_t* __restrict__ hist, long long n, int tiles,
                      int nb) {
  __shared__ int s_w[HIST_BT / 32][REG_BUCKETS];  // nb <= REG_BUCKETS
  __shared__ int s_h[MAX_BUCKETS];                // nb > REG_BUCKETS
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * TILE;
  const int32_t* tt = t + (size_t)w * n + t0;
  const int cnt = (int)min((long long)TILE, n - t0);
  int id[HIST_IT];
  if (((uintptr_t)(t + (size_t)w * n) & 15) == 0) {
    // vector c = tid + k * HIST_BT holds rows 4c .. 4c + 3
#pragma unroll
    for (int k = 0; k < HIST_IT / 4; ++k) {
      const int r = 4 * (tid + k * HIST_BT);
      if (r + 4 <= cnt) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(tt + r));
        id[4 * k] = v.x;
        id[4 * k + 1] = v.y;
        id[4 * k + 2] = v.z;
        id[4 * k + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          id[4 * k + e] = r + e < cnt ? __ldg(tt + r + e) : -1;
      }
    }
  } else {  // the shard's rows start off a 16-byte boundary
#pragma unroll
    for (int k = 0; k < HIST_IT; ++k) {
      const int r = tid + k * HIST_BT;
      id[k] = r < cnt ? __ldg(tt + r) : -1;
    }
  }
  int32_t* out = hist + ((size_t)w * tiles + blockIdx.x) * nb;
  if (nb <= REG_BUCKETS) {
    unsigned long long acc = 0;  // byte b counts bucket b
#pragma unroll
    for (int k = 0; k < HIST_IT; ++k)
      if ((unsigned)id[k] < (unsigned)nb) acc += 1ull << (8 * id[k]);
#pragma unroll
    for (int b = 0; b < REG_BUCKETS; ++b) {
      if (b >= nb) break;
      const unsigned c =
          __reduce_add_sync(FULL, (unsigned)(acc >> (8 * b)) & 0xffu);
      if (lane == 0) s_w[warp][b] = (int)c;
    }
    __syncthreads();
    if (tid < nb) {
      int c = 0;
#pragma unroll
      for (int k = 0; k < HIST_BT / 32; ++k) c += s_w[k][tid];
      out[tid] = c;
    }
  } else {
    for (int b = tid; b < nb; b += HIST_BT) s_h[b] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < HIST_IT; ++k) {
      const bool in = (unsigned)id[k] < (unsigned)nb;
      const unsigned peers = __match_any_sync(FULL, in ? id[k] : -1);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&s_h[id[k]], __popc(peers));
    }
    __syncthreads();
    for (int b = tid; b < nb; b += HIST_BT) out[b] = s_h[b];
  }
}

// Shared state of one block's look-back over all buckets.
struct LookBack {
  int run[MAX_BUCKETS];   // prefix combined so far
  int pos[MAX_BUCKETS];   // nearest tile not combined yet
  int done[MAX_BUCKETS];
  int st[BT];             // per window: 0 blocked, 1 aggregates, 2 stopped
  int sum[BT];            // per window: its values up to where it stopped
  int used[BT];           // per window: tiles before its unwritten one
};

// The whole block: returns to thread b < nb the sum of bucket b's counts
// over tiles [0, tile) of the shard whose tile 0 has state row s0. Tile
// k's words are agg/incl[(s0 + k) * nb + b], bit 63 set once written
// (tile 0 writes only incl). Thread i reads window i / nb of bucket
// i % nb: WIN tiles, nearest first; thread b then combines bucket b's
// windows in order until one meets an inclusive prefix, or one meets a
// tile that has published nothing (the next round restarts there).
__device__ int look_back_buckets(const unsigned long long* agg,
                                 const unsigned long long* incl,
                                 long long s0, int tile, int nb,
                                 LookBack& lb) {
  const int tid = threadIdx.x;
  const int G = BT / nb;  // windows per bucket, >= 1
  const int b = tid % nb;
  const int g = tid / nb;
  if (tid < nb) {
    lb.run[tid] = 0;
    lb.pos[tid] = tile - 1;
    lb.done[tid] = 0;
  }
  __syncthreads();
  while (true) {
    if (g < G && !lb.done[b]) {
      const int p0 = lb.pos[b] - g * WIN;
      unsigned long long wi[WIN], wa[WIN];
#pragma unroll
      for (int j = 0; j < WIN; ++j) {  // both words of every tile, at once
        wi[j] = wa[j] = 0;
        if (p0 - j >= 0) {
          const long long i = (s0 + p0 - j) * nb + b;
          wi[j] = lookback::ld_relaxed(incl + i);
          wa[j] = lookback::ld_relaxed(agg + i);
        }
      }
      int st = 1, sum = 0, used = WIN;
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (p0 - j < 0 || (wi[j] & WRITTEN)) {  // tile 0 is inclusive
          sum += (int)(unsigned)wi[j];
          st = 2;
          break;
        }
        if (!(wa[j] & WRITTEN)) {
          st = 0;
          used = j;
          break;
        }
        sum += (int)(unsigned)wa[j];
      }
      lb.st[tid] = st;
      lb.sum[tid] = sum;
      lb.used[tid] = used;
    }
    __syncthreads();
    bool open = false, blocked = false;
    if (tid < nb && !lb.done[tid]) {
      int run = lb.run[tid];
      int k = 0;
      for (; k < G; ++k) {
        run += lb.sum[k * nb + tid];
        if (lb.st[k * nb + tid] != 1) break;
      }
      if (k == G) {
        lb.pos[tid] -= G * WIN;
      } else if (lb.st[k * nb + tid] == 0) {
        lb.pos[tid] -= k * WIN + lb.used[k * nb + tid];
        blocked = true;
      } else {
        lb.done[tid] = 1;
      }
      lb.run[tid] = run;
      open = !lb.done[tid];
    }
    if (!__syncthreads_or(open)) break;
    if (__syncthreads_or(blocked)) __nanosleep(32);
  }
  return tid < nb ? lb.run[tid] : 0;
}

// legs: L pointers to [W, n] int32 legs; out: [L, W, n]; counts: the
// shard's live-bucket totals [W, nb - 1]; agg/incl: [W * tiles, nb] each.
// Three blocks an SM (at most 85 registers a thread, no spills): the
// compiler's own choice fits two, which leaves too few tiles in flight.
__global__ void __launch_bounds__(BT, BLOCKS)
partition_scatter_kernel(const int32_t* __restrict__ t, Legs legs, int L,
                         uint32_t* __restrict__ out,
                         const int32_t* __restrict__ counts, int W,
                         long long n, int tiles, int nb, unsigned* next_tile,
                         unsigned long long* agg, unsigned long long* incl) {
  __shared__ uint32_t s_buf[TILE];     // one leg, in bucket order
  __shared__ uint8_t s_bkt[TILE];      // the bucket of each buffer slot
  __shared__ int s_wh[WARPS][MAX_BUCKETS];
  __shared__ int s_loc[MAX_BUCKETS];   // bucket start in the buffer
  __shared__ int s_dst[MAX_BUCKETS];   // output row of buffer slot 0
  __shared__ typename ScanU64::TempStorage s_scan;
  __shared__ LookBack s_lb;
  __shared__ int s_total;
  __shared__ unsigned s_vt;

  const unsigned vt = lookback::take_tile(next_tile, &s_vt);
  const int w = vt / tiles;
  const int tile = vt % tiles;
  const long long t0 = (long long)tile * TILE;
  const int cnt = (int)max(0LL, min((long long)TILE, n - t0));
  const long long s0 = (long long)w * tiles;  // state row of tile 0
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t row0 = (size_t)w * n + t0;

  const int total_b =
      tid < nb - 1 ? counts[(size_t)w * (nb - 1) + tid] : 0;
  for (int i = tid; i < WARPS * nb; i += BT) s_wh[i / nb][i % nb] = 0;
  // warp k owns rows [k * WARP_ROWS, (k + 1) * WARP_ROWS) of the tile;
  // round r holds its rows r * 32 + lane
  int id[IT];
#pragma unroll
  for (int r = 0; r < IT; ++r) {
    const int j = warp * WARP_ROWS + r * 32 + lane;
    id[r] = j < cnt ? __ldg(t + row0 + j) : -1;
  }
  __syncthreads();
  // rank among the warp's earlier rows of the same bucket
  int slot[IT];
#pragma unroll
  for (int r = 0; r < IT; ++r) {
    const bool in = (unsigned)id[r] < (unsigned)nb;
    const unsigned peers = __match_any_sync(FULL, in ? id[r] : -1);
    const int before = in ? s_wh[warp][id[r]] : 0;
    __syncwarp();
    if (in && lane == __ffs(peers) - 1)
      s_wh[warp][id[r]] = before + __popc(peers);
    __syncwarp();
    slot[r] = in ? before + __popc(peers & below) : -1;
  }
  __syncthreads();
  // per bucket: the warps' exclusive offsets and the tile's count, which
  // is published at once (tile 0: as its inclusive prefix)
  int c_b = 0;
  if (tid < nb) {
    for (int k = 0; k < WARPS; ++k) {
      const int c = s_wh[k][tid];
      s_wh[k][tid] = c_b;
      c_b += c;
    }
    lookback::st_relaxed((tile == 0 ? incl : agg) + (s0 + tile) * nb + tid,
                         (unsigned long long)(unsigned)c_b | WRITTEN);
  }
  // one scan: bucket starts in the tile (low word), bucket bases in the
  // shard (high word; the dead bucket's base is the live total)
  unsigned long long both, all;
  ScanU64(s_scan).ExclusiveSum(
      ((unsigned long long)(unsigned)total_b << 32) | (unsigned)c_b, both,
      all);
  if (tid == 0) s_total = (int)(unsigned)all;
  if (tid < nb) s_loc[tid] = (int)(unsigned)both;
  const int base_b = (int)(both >> 32);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < IT; ++r) {
    if (slot[r] >= 0) {
      slot[r] += s_loc[id[r]] + s_wh[warp][id[r]];
      s_bkt[slot[r]] = (uint8_t)id[r];
    }
  }
  // leg 0's rows load across the look-back
  uint32_t v[IT];
  auto load_leg = [&](int l) {
    const uint32_t* src = legs.p[l] + row0 + warp * WARP_ROWS + lane;
#pragma unroll
    for (int r = 0; r < IT; ++r)
      v[r] = slot[r] >= 0 ? __ldg(src + r * 32) : 0u;
  };
  if (L > 0) load_leg(0);
  const int pre =
      tile == 0 ? 0 : look_back_buckets(agg, incl, s0, tile, nb, s_lb);
  if (tid < nb) {
    if (tile > 0)
      lookback::st_relaxed(incl + (s0 + tile) * nb + tid,
                           (unsigned long long)(unsigned)(pre + c_b) |
                               WRITTEN);
    s_dst[tid] = base_b + pre - s_loc[tid];
  }
  __syncthreads();
  const int total = s_total;
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int r = 0; r < IT; ++r)
      if (slot[r] >= 0) s_buf[slot[r]] = v[r];
    __syncthreads();
    if (l + 1 < L) load_leg(l + 1);
    uint32_t* dst = out + ((size_t)l * W + w) * n;
    for (int j = tid; j < total; j += BT) {
      // bounded: totals that disagree with the ids write nothing outside
      const long long d = (long long)s_dst[s_bkt[j]] + j;
      if (d >= 0 && d < n) dst[d] = s_buf[j];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int max_buckets() { return MAX_BUCKETS; }

int tile_rows() { return TILE; }

// 64-bit words of K2's state for W shards of `tiles` tiles and nb
// buckets: the tile counter, then agg and incl, [W * tiles, nb] each
long long scatter_state_words(int W, int tiles, int nb) {
  return 1 + 2LL * W * tiles * nb;
}

int launch_partition_hist(const void* t, void* hist, int W, long long n,
                          int tiles, int nb, void* stream) {
  if (nb < 1 || nb > MAX_BUCKETS) return static_cast<int>(cudaErrorInvalidValue);
  if (W > 65535) return static_cast<int>(cudaErrorInvalidValue);
  partition_hist_kernel<<<dim3(tiles, W), HIST_BT, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)t, (int32_t*)hist, n, tiles, nb);
  return static_cast<int>(cudaGetLastError());
}

// One memset + one launch per group of MAX_LEGS legs.
int launch_partition_scatter(const void* t, const void* const* legs, int L,
                             void* out, const void* counts, int W,
                             long long n, int tiles, int nb, void* state,
                             void* stream) {
  if (nb < 1 || nb > MAX_BUCKETS) return static_cast<int>(cudaErrorInvalidValue);
  const long long T = (long long)W * tiles;
  auto* words = (unsigned long long*)state;
  for (int l0 = 0; l0 < L; l0 += MAX_LEGS) {
    const int nl = L - l0 < MAX_LEGS ? L - l0 : MAX_LEGS;
    Legs p{};
    for (int l = 0; l < nl; ++l) p.p[l] = (const uint32_t*)legs[l0 + l];
    cudaError_t err = cudaMemsetAsync(
        state, 0, (size_t)scatter_state_words(W, tiles, nb) * 8,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    partition_scatter_kernel<<<(unsigned)T, BT, 0, (cudaStream_t)stream>>>(
        (const int32_t*)t, p, nl, (uint32_t*)out + (size_t)l0 * W * n,
        (const int32_t*)counts, W, n, tiles, nb, (unsigned*)words,
        words + 1, words + 1 + T * nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
