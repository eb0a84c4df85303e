// K7 segment_sum: float group sums over rows sorted into contiguous groups,
// each group summed in row order, every float-sum column of a group-by in
// one launch, for sm_90a.
//
// Replaces the float SUM of the group-by's segment reduction, which the
// JAX package computes with `jax.ops.segment_sum(...,
// indices_are_sorted=True)` (cylon_tpu/ops/groupby.py:140). That sum adds
// a group's rows one after another, in row order, so its result is
// bit-reproducible. Float atomics (`index_add_` on the card) add in no
// fixed order: the last bits of a sum change from run to run. Here every
// group of every column is summed in row order from +0.0, so the card's
// sums equal the CPU's (`index_add_` on the host also adds in index
// order) bit for bit, and equal themselves run to run.
//
// Input: W shards of n rows, sorted so that each shard's live rows (emit)
// form a prefix, grouped, with dense group ids (gid, int64) that do not
// decrease along the prefix; dead rows follow. Up to MAXC columns a
// launch, each a source (a float16/32/64 [W, n] array; two columns may
// share one) and an accumulator type at least as wide (float16 -> 16, 32
// or 64 bits, float32 -> 32 or 64, float64 -> 64): MEAN's float64 sum of
// a float32 column reads the float32 values, and widening is exact, so
// its bits equal those of a float64 copy's sum. Slots of groups that do
// not exist stay +0.0 (the launcher zeroes the outputs first).
//
// Membership is monotone: past a group's first row, its members are a
// prefix of the shard's remaining rows (gid does not decrease and dead
// rows are last), so a chunk's members are a prefix of the chunk.
//
// Two kernels, one order of adds:
//
// * `segment_sum_short`, tiles of up to 2,048 rows, each block walking
//   every gridDim-th tile with two tile buffers: while it adds one tile,
//   cp.async copies the next one's emit bytes, gids and every source's
//   values, and AFTER (128) rows past it, into shared memory in 16-byte
//   pieces. Each warp marks 32 rows at a time with two ballots:
//   boundaries (a dead row, a shard's first row, a new gid) into a bit
//   word, and group starts, appended to a start list. Each thread then
//   takes one start at a time, the lanes of a warp on different groups,
//   finds its run's end at the next boundary bit, and adds each column's
//   run from shared memory, loads hoisted ahead of the adds; nothing in
//   this kernel waits on device memory but the tile copies. A run that
//   goes on past the rows copied is handed on: (slot, next row, shard
//   end, each column's partial sum) goes to a job list.
// * `segment_sum_long`, a block per job (a grid of the blocks that fit on
//   the SMs walks the list): the columns are grouped by accumulator type,
//   one adding warp a type, one lane a column, so the chains of a
//   group's columns run side by side and a long group costs one
//   dependent add a row of its slowest column, not the sum of them. The
//   other warps keep two chunks of rows in flight ahead of the adders
//   (cp.async into a ring of three chunk buffers), count each landed
//   chunk's members and widen a column read into a wider accumulator
//   (float32 into float64: a conversion on the adding lane would cost
//   more than the add, its unit being slower), so an adding lane only
//   loads, 16 bytes at a time, and adds.
//
// The job list's order depends on the atomics that fill it, but every
// sum does not: each slot is written once, by the one thread or lane that
// finishes its group.
//
// float16 accumulators add through float32: fl16(fl32(a + b)) is the
// correctly rounded half sum (24 >= 2 * 11 + 2 bits), as the CPU's Half
// add gives. A partial sum handed on rides in a double, which holds a
// float16/32/64 value exactly.
//
// Bound on an H100 (3.35 TB/s): bytes for many short groups (every row's
// emit byte, each live row's gid and source values, W x S slots of every
// column written); for a group of m rows, at least m dependent adds of
// its slowest column, the price of the row order.

#include <algorithm>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAXC = 32;           // columns (and sources) a launch
constexpr int BT = 256;            // threads per block of the short kernel
constexpr int TILE_MAX = 2048;     // rows of a tile
constexpr int TILE_BUDGET = 36 * 1024;   // shared bytes a tile aims at (a
                                         // block holds two)
constexpr int LB = 256;            // threads per block of the long kernel
constexpr int CHUNK_MAX = 2048;    // rows of a chunk
constexpr int CHUNK_BUDGET = 96 * 1024;  // shared bytes of three chunks
constexpr int HALO = 16;           // rows copied before a tile
constexpr int AFTER = 128;         // rows copied past a tile: a run that
                                   // goes on past them is handed on

// the kinds, by value type (0 float16, 1 float32, 2 float64) and
// accumulator type
enum Kind { HH, HF, HD, FF, FD, DD };

int kind_of(int v, int a) {
  static const int k[3][3] = {{HH, HF, HD}, {-1, FF, FD}, {-1, -1, DD}};
  return (v < 0 || v > 2 || a < 0 || a > 2) ? -1 : k[v][a];
}

// byte offsets of one tile or chunk buffer: emit bytes at 0, then (a
// tile's) the start list, the gids, each source, and (a chunk's) each
// widened column; the value regions start 16 bytes apart modulo 128, so
// adding lanes that read one row of several regions hit different banks
struct Layout {
  int rows;
  int list;
  int gid;
  int src[MAXC];
  int cvt[MAXC];
  int bytes;
};

struct Params {
  const unsigned char* src[MAXC];
  void* out[MAXC];
  int src_es[MAXC];       // bytes a value
  int col_src[MAXC];
  int col_kind[MAXC];
  int nsrc, ncol;
  // the long kernel's adding warps: warp k adds accumulator type
  // warp_acc[k] (0 float16, 1 float32, 2 float64), its lane l column
  // warp_col[k][l] (l < warp_ncol[k])
  int nadd;
  int warp_acc[3];
  int warp_ncol[3];
  signed char warp_col[3][32];
  const long long* gid;
  const uint8_t* emit;
  long long n, total, S;
  int job_words;          // 4 + ncol: slot, row, group, shard end, partials
  Layout tile, chunk;
};

struct AccH {
  using R = float;
  __device__ static R add(R s, R v) {
    return __half2float(__float2half_rn(s + v));
  }
  __device__ static __half out(R s) { return __float2half_rn(s); }
};
struct AccF {
  using R = float;
  __device__ static R add(R s, R v) { return s + v; }
  __device__ static float out(R s) { return s; }
};
struct AccD {
  using R = double;
  __device__ static R add(R s, R v) { return s + v; }
  __device__ static double out(R s) { return s; }
};

__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// s + x[a] + ... + x[b - 1], in that order; the next P values are loaded
// while the current P are added (two register sets in turn), so the adds
// wait on each other only
template <class A, int P, typename V>
__device__ __forceinline__ typename A::R add_rows(typename A::R s,
                                                  const V* x, int a,
                                                  int b) {
  using R = typename A::R;
  int k = a;
  if (b - a >= 2 * P) {
    R c0[P], c1[P];
#pragma unroll
    for (int u = 0; u < P; ++u) c0[u] = (R)widen(x[k + u]);
    for (k += P; k + 2 * P <= b; k += 2 * P) {
#pragma unroll
      for (int u = 0; u < P; ++u) c1[u] = (R)widen(x[k + u]);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c0[u]);
#pragma unroll
      for (int u = 0; u < P; ++u) c0[u] = (R)widen(x[k + P + u]);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c1[u]);
    }
    // c0 holds rows k - P .. k - 1
    if (k + P <= b) {
#pragma unroll
      for (int u = 0; u < P; ++u) c1[u] = (R)widen(x[k + u]);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c0[u]);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c1[u]);
      k += P;
    } else {
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c0[u]);
    }
  }
  for (; k < b; ++k) s = A::add(s, (R)widen(x[k]));
  return s;
}

// P values of shared memory at a 16-byte boundary, 16 bytes a load
template <int P>
__device__ __forceinline__ void load16(float (&c)[P], const float* x) {
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(x)[q];
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
  }
}
template <int P>
__device__ __forceinline__ void load16(double (&c)[P], const double* x) {
#pragma unroll
  for (int q = 0; q < P / 2; ++q) {
    const double2 v = reinterpret_cast<const double2*>(x)[q];
    c[2 * q] = v.x;
    c[2 * q + 1] = v.y;
  }
}

// add_rows for values already of the accumulator's type in a 16-byte
// aligned shared region: single rows up to a 16-byte boundary, then 16
// bytes a load
template <class A, int P>
__device__ __forceinline__ typename A::R add_aligned(
    typename A::R s, const typename A::R* x, int a, int b) {
  constexpr int W = 16 / sizeof(typename A::R);
  int k = a;
  for (; k < b && (k & (W - 1)); ++k) s = A::add(s, x[k]);
  if (b - k >= 2 * P) {
    typename A::R c0[P], c1[P];
    load16(c0, x + k);
    for (k += P; k + 2 * P <= b; k += 2 * P) {
      load16(c1, x + k);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c0[u]);
      load16(c0, x + k + P);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c1[u]);
    }
    if (k + P <= b) {
      load16(c1, x + k);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c0[u]);
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c1[u]);
      k += P;
    } else {
#pragma unroll
      for (int u = 0; u < P; ++u) s = A::add(s, c0[u]);
    }
  }
  for (; k < b; ++k) s = A::add(s, x[k]);
  return s;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + rows) of an array of es-byte values into dst: 16-byte
// cp.async pieces (row0 is a multiple of 16 and the array 16-byte
// aligned), the last < 16 bytes copied directly; thread t of nt
__device__ __forceinline__ void stage(unsigned char* dst, const void* src,
                                      int es, long long row0, int rows,
                                      int t, int nt) {
  const unsigned char* g =
      static_cast<const unsigned char*>(src) + row0 * es;
  const int bytes = rows * es;
  const int nv = bytes >> 4;
  for (int v = t; v < nv; v += nt) cp16(dst + 16 * v, g + 16 * v);
  for (int b = (nv << 4) + t; b < bytes; b += nt) dst[b] = g[b];
}

// a short-kernel thread's column c of the group whose run is tile rows
// [i, b): the sum goes to its slot, or to the job as a partial
template <class A, typename V>
__device__ void finish_column(const Params& p, const unsigned char* buf,
                              int c, int i, int b, long long* job,
                              long long slot) {
  const typename A::R s = add_rows<A, 4>(
      0, reinterpret_cast<const V*>(buf + p.tile.src[p.col_src[c]]), i, b);
  if (job)
    job[4 + c] = __double_as_longlong((double)s);
  else
    reinterpret_cast<decltype(A::out(s))*>(p.out[c])[slot] = A::out(s);
}

// the group g of shard w (ending at row se) whose run in the buffer is
// tile rows [i, b); `more`: it goes on at row t0 + b, so it is handed on
// to the job list with every column's partial sum
__device__ void run_group(const Params& p, const unsigned char* buf,
                          long long* ws, long long t0, int i, int b,
                          long long g, long long w, long long se,
                          bool more) {
  const long long slot = w * p.S + g;
  long long* job = nullptr;
  if (more) {
    const unsigned long long q =
        atomicAdd(reinterpret_cast<unsigned long long*>(ws), 1ULL);
    job = ws + 1 + (long long)q * p.job_words;
    job[0] = slot;
    job[1] = t0 + b;
    job[2] = g;
    job[3] = se;
  }
  for (int c = 0; c < p.ncol; ++c) {
    switch (p.col_kind[c]) {
      case HH: finish_column<AccH, __half>(p, buf, c, i, b, job, slot);
        break;
      case HF: finish_column<AccF, __half>(p, buf, c, i, b, job, slot);
        break;
      case HD: finish_column<AccD, __half>(p, buf, c, i, b, job, slot);
        break;
      case FF: finish_column<AccF, float>(p, buf, c, i, b, job, slot);
        break;
      case FD: finish_column<AccD, float>(p, buf, c, i, b, job, slot);
        break;
      default: finish_column<AccD, double>(p, buf, c, i, b, job, slot);
        break;
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)) : "memory");
}

// wait for the barrier's phase `parity` to complete; a copy that never
// lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (spin > (1LL << 26)) __trap();
  }
}

// bytes [0, bytes) of src into dst: the 16-byte multiple by one TMA bulk
// copy that completes on bar (the caller's expect_tx counts it), the rest
// by threads t of nt directly
__device__ __forceinline__ int bulk_bytes(int bytes) { return bytes & ~15; }

__device__ __forceinline__ void bulk_copy(unsigned char* dst,
                                          const unsigned char* src,
                                          int bytes,
                                          unsigned long long* bar) {
  if (bulk_bytes(bytes))
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(__cvta_generic_to_global(src)), "r"(bulk_bytes(bytes)),
        "r"(smem_addr(bar))
        : "memory");
}

// tile `tile`'s regions: its emit bytes and gids from HALO rows before it
// (its first row's predecessor), its values from its first row, all to
// AFTER rows past it
struct TileCopy {
  long long t0;
  int rows, after, h;
};

__device__ __forceinline__ TileCopy tile_copy(const Params& p,
                                              long long tile) {
  TileCopy c;
  c.t0 = tile * p.tile.rows;
  c.rows = (int)min((long long)p.tile.rows, p.total - c.t0);
  c.after = (int)min((long long)AFTER, p.total - c.t0 - c.rows);
  c.h = c.t0 ? HALO : 0;
  return c;
}

// region r of tile copy c in the buffer at buf (0 emit bytes, 1 gids, 2 +
// k source k): its destination and source; returns its bytes
__device__ __forceinline__ int tile_region(const Params& p,
                                           const TileCopy& c,
                                           unsigned char* buf, int r,
                                           unsigned char** dst,
                                           const unsigned char** src) {
  const int m = c.h + c.rows + c.after;
  if (r == 0) {
    *dst = buf + HALO - c.h;
    *src = p.emit + (c.t0 - c.h);
    return m;
  }
  if (r == 1) {
    *dst = buf + p.tile.gid + 8 * (HALO - c.h);
    *src = reinterpret_cast<const unsigned char*>(p.gid + (c.t0 - c.h));
    return 8 * m;
  }
  const int k = r - 2;
  *dst = buf + p.tile.src[k];
  *src = p.src[k] + c.t0 * p.src_es[k];
  return (c.rows + c.after) * p.src_es[k];
}

// copy tile `tile` into the buffer at buf: thread 0 issues one bulk copy
// a region on bar, every thread copies the regions' last < 16 bytes (the
// last tile's only)
__device__ void issue_tile(const Params& p, unsigned char* buf,
                           unsigned long long* bar, long long tile,
                           int tid) {
  const TileCopy c = tile_copy(p, tile);
  unsigned char* dst;
  const unsigned char* src;
  if (tid == 0) {
    // the buffer's earlier reads (ordered by the block barrier) come
    // before the copy engine's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    unsigned total = 0;
    for (int r = 0; r < 2 + p.nsrc; ++r)
      total += bulk_bytes(tile_region(p, c, buf, r, &dst, &src));
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)), "r"(total)
        : "memory");
    for (int r = 0; r < 2 + p.nsrc; ++r) {
      const int bytes = tile_region(p, c, buf, r, &dst, &src);
      bulk_copy(dst, src, bytes, bar);
    }
  }
  for (int r = 0; r < 2 + p.nsrc; ++r) {
    const int bytes = tile_region(p, c, buf, r, &dst, &src);
    for (int q = bulk_bytes(bytes) + tid; q < bytes; q += BT) dst[q] = src[q];
  }
}

// a block walks the tiles tile = blockIdx.x, + gridDim.x, ...: while it
// adds one tile's groups, the next tile's copy is in flight
__global__ void __launch_bounds__(BT, 3)
segment_sum_short(const __grid_constant__ Params p,
                  long long* __restrict__ ws) {
  extern __shared__ __align__(128) unsigned char sm[];
  // bit r % 32 of word r / 32: buffer row r ends a run (a boundary); a
  // word for every row the marking loop visits
  __shared__ unsigned bounds[(TILE_MAX + AFTER + BT - 1) / BT * BT / 32];
  __shared__ __align__(8) unsigned long long bar[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ntiles = (p.total + p.tile.rows - 1) / p.tile.rows;
  // rows a shard: a tile holds at most one shard start unless shards are
  // shorter than the rows it copies
  const bool small = p.n <= TILE_MAX + AFTER;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  long long tile = blockIdx.x;
  issue_tile(p, sm, &bar[0], tile, tid);
  unsigned parity = 0;   // bit b: the phase buffer b waits for
  for (int cur = 0; tile < ntiles; tile += gridDim.x, cur ^= 1) {
    const unsigned char* buf = sm + cur * p.tile.bytes;
    if (tile + gridDim.x < ntiles)
      issue_tile(p, sm + (cur ^ 1) * p.tile.bytes, &bar[cur ^ 1],
                 tile + gridDim.x, tid);
    mbar_wait(&bar[cur], (parity >> cur) & 1);
    parity ^= 1u << cur;
    __syncthreads();
    const TileCopy c = tile_copy(p, tile);
    const long long t0 = c.t0;
    const int rows = c.rows, n = c.rows + c.after;
    // the tile's first row is in shard w0; the next shard starts at row
    // fs of the tile
    const long long w0 = t0 / p.n;
    const int fs = (int)min((long long)n, (w0 + 1) * p.n - t0);
    const bool starts_shard = t0 == w0 * p.n;
    const uint8_t* e = buf + HALO;
    const long long* gd =
        reinterpret_cast<const long long*>(buf + p.tile.gid) + HALO;
    // this warp's start list: its rows' group starts in row order
    const int cap = p.tile.rows / (BT / 32);
    int* list = reinterpret_cast<int*>(const_cast<unsigned char*>(buf) +
                                       p.tile.list) + warp * cap;
    int nmine = 0;
    for (int base = warp * 32; base < n; base += BT) {
      const int i = base + lane;
      const bool in = i < n;
      const long long g = in ? gd[i] : 0;
      const int live = in ? e[i] : 0;
      // the row before: the lane below, or (lane 0) shared memory; row -1
      // is the halo, read only when the tile does not start a shard
      long long gp = __shfl_up_sync(~0u, g, 1);
      int lp = __shfl_up_sync(~0u, live, 1);
      if (lane == 0 && (i > 0 || !starts_shard)) {
        gp = gd[i - 1];
        lp = e[i - 1];
      }
      const bool first = i == 0 ? starts_shard
                                : i >= fs && (small ? (i - fs) % (int)p.n == 0
                                                    : i == fs);
      const bool bnd = in && (!live || first || !lp || gp != g);
      const bool start = i < rows && bnd && live && g >= 0 && g < p.S;
      const unsigned sw = __ballot_sync(~0u, start);
      const unsigned bw = __ballot_sync(~0u, bnd);
      if (lane == 0) bounds[i >> 5] = bw;
      if (start) list[nmine + __popc(sw & ((1u << lane) - 1))] = i;
      nmine += __popc(sw);
    }
    __syncthreads();
    // this warp's starts, one a lane at a time: each run ends at the next
    // boundary, or goes on past the rows copied
    const int nw = (n + 31) >> 5;
    for (int k = lane; k < nmine; k += 32) {
      const int i = list[k];
      int wd = (i + 1) >> 5;
      unsigned m = wd < nw ? bounds[wd] & (~0u << ((i + 1) & 31)) : 0u;
      while (!m && ++wd < nw) m = bounds[wd];
      const int b = m ? (wd << 5) + __ffs(m) - 1 : n;
      const long long w =
          i < fs ? w0 : w0 + 1 + (small ? (i - fs) / (int)p.n : 0);
      const long long se = (w + 1) * p.n;
      run_group(p, buf, ws, t0, i, b, gd[i], w, se,
                b == n && c.after == AFTER && t0 + b < se);
    }
    // the buffer is refilled two tiles on
    __syncthreads();
  }
}

__device__ __forceinline__ void loader_sync(int nl) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nl) : "memory");
}

// loaders: copy chunk ci (rows B + ci * CH ..., up to the shard end) into
// ring buffer ci % 3; one cp.async group, empty past the shard end
__device__ void issue_chunk(const Params& p, unsigned char* sm, int ci,
                            long long B, long long se, int lt, int nl) {
  const long long cs = B + (long long)ci * p.chunk.rows;
  unsigned char* buf = sm + (ci % 3) * p.chunk.bytes;
  if (cs < se) {
    const int rows = (int)min((long long)p.chunk.rows, se - cs);
    stage(buf, p.emit, 1, cs, rows, lt, nl);
    stage(buf + p.chunk.gid, p.gid, 8, cs, rows, lt, nl);
    for (int k = 0; k < p.nsrc; ++k)
      stage(buf + p.chunk.src[k], p.src[k], p.src_es[k], cs, rows, lt, nl);
  }
  cp_commit();
}

template <typename R, typename V>
__device__ void widen_rows(R* dst, const V* src, int a, int b, int lt,
                           int nl) {
  for (int k = a + lt; k < b; k += nl) dst[k] = (R)widen(src[k]);
}

// loaders, once chunk ci has landed: its first row (from `first`) that is
// not in group g, or the rows it holds, into *bad (set to CH before); and
// each column read into a wider accumulator widened into its own region
__device__ void count_chunk(const Params& p, unsigned char* sm, int ci,
                            long long B, int first, long long se,
                            long long g, int lt, int nl, int* bad) {
  const long long cs = B + (long long)ci * p.chunk.rows;
  const int len = (int)min((long long)p.chunk.rows, se - cs);
  unsigned char* buf = sm + (ci % 3) * p.chunk.bytes;
  const long long* gd = reinterpret_cast<const long long*>(buf + p.chunk.gid);
  int mine = len;
  for (int k = first + lt; k < len; k += nl)
    if (!buf[k] || gd[k] != g) {
      mine = k;
      break;
    }
  if (mine < p.chunk.rows) atomicMin(bad, mine);
  for (int c = 0; c < p.ncol; ++c) {
    const int kind = p.col_kind[c];
    if (kind == HH || kind == FF || kind == DD) continue;
    const unsigned char* v = buf + p.chunk.src[p.col_src[c]];
    unsigned char* o = buf + p.chunk.cvt[c];
    if (kind == HF)
      widen_rows(reinterpret_cast<float*>(o),
                 reinterpret_cast<const __half*>(v), first, len, lt, nl);
    else if (kind == HD)
      widen_rows(reinterpret_cast<double*>(o),
                 reinterpret_cast<const __half*>(v), first, len, lt, nl);
    else
      widen_rows(reinterpret_cast<double*>(o),
                 reinterpret_cast<const float*>(v), first, len, lt, nl);
  }
}

__global__ void __launch_bounds__(LB)
segment_sum_long(const __grid_constant__ Params p,
                 const long long* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char sm[];
  // a chunk's first row that is not in the group, in a ring: chunk i's is
  // read while chunk i + 1's is counted
  __shared__ int bad[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool loader = warp >= p.nadd;
  const int lt = threadIdx.x - 32 * p.nadd, nl = LB - 32 * p.nadd;
  const int CH = p.chunk.rows;
  const int acc = loader ? -1 : p.warp_acc[warp];
  const int col = (!loader && lane < p.warp_ncol[warp])
                      ? p.warp_col[warp][lane] : -1;
  // the adding lane's region in a chunk buffer: its source, or the
  // column widened
  int region = 0;
  if (col >= 0) {
    const int kind = p.col_kind[col];
    region = (kind == HH || kind == FF || kind == DD)
                 ? p.chunk.src[p.col_src[col]] : p.chunk.cvt[col];
  }
  const long long njobs = ws[0];
  for (long long q = blockIdx.x; q < njobs; q += gridDim.x) {
    const long long* job = ws + 1 + q * p.job_words;
    const long long slot = job[0], pos = job[1], g = job[2], se = job[3];
    const long long B = pos & ~15LL;   // chunks start 16-row aligned
    const int first0 = (int)(pos - B);
    float sf = 0.f;
    double sd = 0.0;
    if (col >= 0) {
      sd = __longlong_as_double(job[4 + col]);
      sf = (float)sd;
    }
    if (loader) {
      if (lt == 0) bad[0] = CH;
      issue_chunk(p, sm, 0, B, se, lt, nl);
      issue_chunk(p, sm, 1, B, se, lt, nl);
      cp_wait<1>();
      loader_sync(nl);
      count_chunk(p, sm, 0, B, first0, se, g, lt, nl, &bad[0]);
    }
    __syncthreads();
    for (int i = 0;; ++i) {
      const long long cs = B + (long long)i * CH;
      const int first = i == 0 ? first0 : 0;
      const int last = bad[i % 3];
      const bool more = last == CH && cs + CH < se;
      if (loader) {
        if (more) {
          if (lt == 0) bad[(i + 1) % 3] = CH;
          issue_chunk(p, sm, i + 2, B, se, lt, nl);
          cp_wait<1>();
          loader_sync(nl);
          count_chunk(p, sm, i + 1, B, 0, se, g, lt, nl, &bad[(i + 1) % 3]);
        }
      } else if (col >= 0 && last > first) {
        const unsigned char* v = sm + (i % 3) * p.chunk.bytes + region;
        if (acc == 0)
          sf = add_rows<AccH, 16>(sf, reinterpret_cast<const __half*>(v),
                                  first, last);
        else if (acc == 1)
          sf = add_aligned<AccF, 16>(sf, reinterpret_cast<const float*>(v),
                                     first, last);
        else
          sd = add_aligned<AccD, 16>(sd, reinterpret_cast<const double*>(v),
                                     first, last);
      }
      __syncthreads();
      if (!more) break;
    }
    if (col >= 0) {
      void* o = p.out[col];
      if (acc == 0)
        reinterpret_cast<__half*>(o)[slot] = __float2half_rn(sf);
      else if (acc == 1)
        reinterpret_cast<float*>(o)[slot] = sf;
      else
        reinterpret_cast<double*>(o)[slot] = sd;
    }
    // the ring's last chunks may still be landing: drain before reuse
    if (loader) cp_wait<0>();
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// a tile's layout (with the start list) or a chunk's (with the widened
// columns)
Layout make_layout(int rows, bool tile, const Params& p) {
  static const int acc_size[6] = {2, 4, 8, 4, 8, 8};   // by kind
  Layout L{};
  L.rows = rows;
  const int halo = tile ? HALO : 0, after = tile ? AFTER : 0;
  int off = round_up(halo + rows + after, 16);
  L.list = off;
  if (tile) off += rows * 4;
  L.gid = off;
  off += (halo + rows + after) * 8;
  int region = 0;
  for (int k = 0; k < p.nsrc; ++k, ++region) {
    off = round_up(off, 128) + 16 * (region % 8);
    L.src[k] = off;
    off += (rows + after) * p.src_es[k];
  }
  for (int c = 0; c < p.ncol; ++c) {
    const int kind = p.col_kind[c];
    L.cvt[c] = -1;
    if (tile || kind == HH || kind == FF || kind == DD) continue;
    off = round_up(off, 128) + 16 * (region++ % 8);
    L.cvt[c] = off;
    off += rows * acc_size[kind];
  }
  L.bytes = round_up(off, 16);
  return L;
}

int g_sms = 0;
int g_short_smem = 48 * 1024;   // dynamic shared bytes allowed so far
int g_long_smem = 48 * 1024;

// blocks of a kernel that fit on an SM with `smem` dynamic shared bytes,
// remembered for the last size asked (a launch's host time counts while
// the card waits for it)
struct Fit {
  int smem = -1, blocks = 0;
};
Fit g_short_fit, g_long_fit;

cudaError_t blocks_per_sm(const void* fn, int threads, int smem, Fit* fit,
                          int* blocks) {
  if (fit->smem != smem) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit->blocks, fn, threads, smem);
    if (err != cudaSuccess) return err;
    fit->smem = smem;
  }
  *blocks = fit->blocks;
  return cudaSuccess;
}

cudaError_t allow_smem(const void* fn, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the 64-bit words of the job list for W shards of n rows and ncol
// columns: a count, then 4 + ncol a job; a job's group has more than
// AFTER rows
long long sum_state_words(int W, long long n, int ncol) {
  return 1 + ((long long)W * n / AFTER + 1) * (4 + ncol);
}

// srcs[k]: source k, its type src_type[k] (0 float16, 1 float32, 2
// float64), each 16-byte aligned; column c sums source col_src[c] into
// outs[c] ([W, S], accumulator type col_acc[c]); gid int64 and emit bool
// [W, n], 16-byte aligned; state: sum_state_words(W, n, ncol) words
int launch_segment_sum(const void* const* srcs, const int* src_type,
                       int nsrc, const int* col_src, const int* col_acc,
                       void* const* outs, int ncol, const void* gid,
                       const void* emit, int W, long long n, long long S,
                       void* state, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nsrc < 1 || nsrc > MAXC || ncol < 1 || ncol > MAXC)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int size_of[3] = {2, 4, 8};
  Params p{};
  p.nsrc = nsrc;
  p.ncol = ncol;
  int tile_bytes = 13, chunk_bytes = 9;   // a row's
  for (int k = 0; k < nsrc; ++k) {
    if (src_type[k] < 0 || src_type[k] > 2)
      return static_cast<int>(cudaErrorInvalidValue);
    p.src[k] = static_cast<const unsigned char*>(srcs[k]);
    p.src_es[k] = size_of[src_type[k]];
    tile_bytes += p.src_es[k];
    chunk_bytes += p.src_es[k];
  }
  for (int c = 0; c < ncol; ++c) {
    const int k = col_src[c];
    const int kind = (k < 0 || k >= nsrc) ? -1 : kind_of(src_type[k],
                                                         col_acc[c]);
    if (kind < 0) return static_cast<int>(cudaErrorInvalidValue);
    p.col_src[c] = k;
    p.col_kind[c] = kind;
    p.out[c] = outs[c];
    if (kind == HF || kind == HD || kind == FD)
      chunk_bytes += size_of[col_acc[c]];
    cudaError_t err = cudaMemsetAsync(
        outs[c], 0, (size_t)W * S * size_of[col_acc[c]], st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = (long long)W * n;
  if (total == 0) return static_cast<int>(cudaSuccess);
  for (int a = 0; a < 3; ++a) {
    int m = 0;
    for (int c = 0; c < ncol; ++c)
      if (col_acc[c] == a) p.warp_col[p.nadd][m++] = (signed char)c;
    if (m) {
      p.warp_acc[p.nadd] = a;
      p.warp_ncol[p.nadd] = m;
      ++p.nadd;
    }
  }
  p.gid = static_cast<const long long*>(gid);
  p.emit = static_cast<const uint8_t*>(emit);
  p.n = n;
  p.total = total;
  p.S = S;
  p.job_words = 4 + ncol;
  const int tile =
      std::min(TILE_MAX, std::max(BT, TILE_BUDGET / tile_bytes / BT * BT));
  const int chunk = std::min(
      CHUNK_MAX, std::max(16, CHUNK_BUDGET / (3 * chunk_bytes) / 16 * 16));
  p.tile = make_layout(tile, true, p);
  p.chunk = make_layout(chunk, false, p);
  long long* ws = static_cast<long long*>(state);
  cudaError_t err;
  if ((err = cudaMemsetAsync(ws, 0, sizeof(long long), st)) != cudaSuccess)
    return static_cast<int>(err);
  if (g_sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return static_cast<int>(err);
  }
  const int short_smem = 2 * p.tile.bytes, long_smem = 3 * p.chunk.bytes;
  if ((err = allow_smem((const void*)segment_sum_short, short_smem,
                        &g_short_smem)) != cudaSuccess ||
      (err = allow_smem((const void*)segment_sum_long, long_smem,
                        &g_long_smem)) != cudaSuccess)
    return static_cast<int>(err);
  int short_per_sm = 0, per_sm = 0;
  if ((err = blocks_per_sm((const void*)segment_sum_short, BT, short_smem,
                           &g_short_fit, &short_per_sm)) != cudaSuccess ||
      (err = blocks_per_sm((const void*)segment_sum_long, LB, long_smem,
                           &g_long_fit, &per_sm)) != cudaSuccess)
    return static_cast<int>(err);
  const long long tiles = (total + tile - 1) / tile;
  const long long blocks =
      std::min(tiles, (long long)std::max(1, short_per_sm) * g_sms);
  segment_sum_short<<<(unsigned)blocks, BT, short_smem, st>>>(p, ws);
  if ((err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  segment_sum_long<<<std::max(1, per_sm) * g_sms, LB, long_smem, st>>>(p,
                                                                      ws);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
