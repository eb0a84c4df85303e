// K7 segment_sum: float group sums over rows sorted into contiguous groups,
// each group summed in row order, for sm_90a.
//
// Replaces the float SUM of the group-by's segment reduction, which the
// JAX package computes with `jax.ops.segment_sum(...,
// indices_are_sorted=True)` (cylon_tpu/ops/groupby.py:140). That sum adds
// a group's rows one after another, in row order, so its result is
// bit-reproducible. The port's earlier form, `index_add_`, adds with float
// atomics on the card, in no fixed order: the last bits of a sum changed
// from run to run. Here every group is summed in row order from +0.0, so
// the card's sums equal the CPU's (`index_add_` on the host also adds in
// index order) bit for bit, and equal themselves run to run.
//
// Input: W shards of n rows, sorted so that each shard's live rows (emit)
// form a prefix, grouped, with dense group ids (gid, int64) that do not
// decrease along the prefix; dead rows follow and are never read past
// their emit byte. Slots of groups that do not exist stay +0.0 (the
// launcher zeroes the output first).
//
// Two kernels, one order of adds:
//
// * `segment_sum_short`, a thread per row: the thread at a group's first
//   row adds the group's rows in order; every other thread exits after
//   reading its row's emit byte and gid (and its predecessor's). Since gid
//   does not decrease over the live prefix, a live row j + U - 1 with gid
//   g proves rows j .. j + U - 1 all belong to group g, so the loop checks
//   one row in U and adds U values without a test. A thread that has
//   added LONG rows and finds its group goes on hands the rest on: it
//   appends (slot, next row, partial sum) to a job list and exits. Its
//   loads sit on its add chain, which is cheap for the short groups of a
//   high-cardinality group-by and would cost ~100 cycles a row on a long
//   one.
// * `segment_sum_long`, a block per job (a grid of a few blocks per SM
//   walks the list): warps 1..7 read the run's next chunk of C rows,
//   coalesced, into shared memory while lane 0 of warp 0 adds the
//   current chunk in order from there, so a long group costs one
//   dependent add a row (~4 cycles for float32) and the global loads
//   overlap the adds. A chunk's members are a prefix of it (a group's
//   rows are contiguous), so a chunk with fewer than C members ends the
//   run.
//
// The job list's order depends on the atomics that fill it, but every
// job's sum does not: each slot is written once, by the one thread or
// block that finishes its group.
//
// float16 adds round through float32: fl16(fl32(a + b)) is the correctly
// rounded half sum (24 >= 2 * 11 + 2 bits), as the CPU's Half add gives.
// A partial sum handed on rides in a double, which holds a float16/32/64
// value exactly.
//
// Bound on an H100 (3.35 TB/s): bytes for many short groups (every row's
// emit byte and gid, every live row's value, W x S slots written); for a
// group of m rows, at least m dependent adds, the price of the row order.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 256;            // threads per block of the short kernel
constexpr int U = 8;               // rows added per membership test
constexpr long long LONG = 256;    // rows a start thread adds before handing on
constexpr int LB = 256;            // threads per block of the long kernel
constexpr int NL = LB - 32;        // its loader threads (warps 1..7)
constexpr int PER = 5;             // rows each loader reads per chunk
constexpr int C = NL * PER;        // rows per chunk
constexpr int JOB_WORDS = 5;       // slot, pos, g, end, partial (as bits)

template <typename T>
struct Acc {
  __device__ static T add(T s, T x) { return s + x; }
  __device__ static double wide(T s) { return (double)s; }
  __device__ static T narrow(double d) { return (T)d; }
};

template <>
struct Acc<__half> {
  __device__ static __half add(__half s, __half x) {
    return __float2half_rn(__half2float(s) + __half2float(x));
  }
  __device__ static double wide(__half s) { return (double)__half2float(s); }
  __device__ static __half narrow(double d) {
    return __float2half_rn((float)d);
  }
};

template <typename T>
__global__ void __launch_bounds__(BT)
segment_sum_short(const T* __restrict__ x, const long long* __restrict__ gid,
                  const uint8_t* __restrict__ emit, long long n,
                  long long total, long long S, T* __restrict__ out,
                  long long* __restrict__ ws) {
  const long long r = (long long)blockIdx.x * BT + threadIdx.x;
  if (r >= total || !emit[r]) return;
  const long long w = r / n;
  const long long base = w * n;
  const long long g = gid[r];
  if (r > base && emit[r - 1] && gid[r - 1] == g) return;  // not a start
  if (g < 0 || g >= S) return;
  const long long end = base + n;
  T s = T(0.0f);
  long long j = r;
  for (;;) {
    if (j - r >= LONG && j < end && emit[j] && gid[j] == g) {
      // a long group: hand the rest of the run to segment_sum_long
      const unsigned long long q =
          atomicAdd(reinterpret_cast<unsigned long long*>(ws), 1ULL);
      long long* job = ws + 1 + (long long)q * JOB_WORDS;
      job[0] = w * S + g;
      job[1] = j;
      job[2] = g;
      job[3] = end;
      job[4] = __double_as_longlong(Acc<T>::wide(s));
      return;
    }
    if (j + U <= end && emit[j + U - 1] && gid[j + U - 1] == g) {
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = x[j + u];
#pragma unroll
      for (int u = 0; u < U; ++u) s = Acc<T>::add(s, v[u]);
      j += U;
      continue;
    }
    // fewer than U rows of the group are left: one at a time
    while (j < end && emit[j] && gid[j] == g) {
      s = Acc<T>::add(s, x[j]);
      ++j;
    }
    break;
  }
  out[w * S + g] = s;
}

// warps 1..7: rows p0 .. p0 + C - 1 of the run of group g into buf (all
// loads issued before any test), their member count into *cnt
template <typename T>
__device__ void load_chunk(const T* __restrict__ x,
                           const long long* __restrict__ gid,
                           const uint8_t* __restrict__ emit, long long p0,
                           long long end, long long g, T* buf, int* cnt) {
  const int t = threadIdx.x - 32;
  uint8_t e[PER];
  long long k[PER];
  T v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const long long row = p0 + t + i * NL;
    const bool in = row < end;
    e[i] = in ? emit[row] : 0;
    k[i] = in ? gid[row] : -1;
    v[i] = in ? x[row] : T(0.0f);
  }
  int m = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (e[i] && k[i] == g) {
      buf[t + i * NL] = v[i];
      ++m;
    }
  }
  if (m) atomicAdd(cnt, m);
}

// lane 0 of warp 0: s + buf[0] + ... + buf[c - 1], in that order; the
// next V values are read from shared memory while the current V are
// added, so the adds wait on each other only
template <typename T>
__device__ T add_chunk(T s, const T* buf, int c) {
  constexpr int V = 16;
  int k = 0;
  if (c >= V) {
    T cur[V];
#pragma unroll
    for (int u = 0; u < V; ++u) cur[u] = buf[u];
    for (k = V; k + V <= c; k += V) {
      T nxt[V];
#pragma unroll
      for (int u = 0; u < V; ++u) nxt[u] = buf[k + u];
#pragma unroll
      for (int u = 0; u < V; ++u) s = Acc<T>::add(s, cur[u]);
#pragma unroll
      for (int u = 0; u < V; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < V; ++u) s = Acc<T>::add(s, cur[u]);
  }
  for (; k < c; ++k) s = Acc<T>::add(s, buf[k]);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(LB)
segment_sum_long(const T* __restrict__ x, const long long* __restrict__ gid,
                 const uint8_t* __restrict__ emit, T* __restrict__ out,
                 const long long* __restrict__ ws) {
  // two chunk buffers, as bytes (a __half array may not be __shared__)
  __shared__ __align__(16) unsigned char raw[2 * C * sizeof(T)];
  T* const buf = reinterpret_cast<T*>(raw);
  // member counts of chunks i, i + 1, i + 2 in a ring: chunk i's is read
  // while chunk i + 1's fills and chunk i - 1's (read in the previous
  // step) is zeroed for chunk i + 2
  __shared__ int cnt[3];
  const long long njobs = ws[0];
  for (long long q = blockIdx.x; q < njobs; q += gridDim.x) {
    const long long* job = ws + 1 + q * JOB_WORDS;
    const long long slot = job[0], g = job[2], end = job[3];
    long long pos = job[1];
    if (threadIdx.x < 3) cnt[threadIdx.x] = 0;
    __syncthreads();
    if (threadIdx.x >= 32) load_chunk(x, gid, emit, pos, end, g, buf,
                                      &cnt[0]);
    __syncthreads();
    T s = Acc<T>::narrow(__longlong_as_double(job[4]));
    for (int i = 0;; ++i) {
      const int c = cnt[i % 3];
      const bool more = c == C;
      if (threadIdx.x >= 32) {
        if (more) load_chunk(x, gid, emit, pos + C, end, g,
                             buf + ((i + 1) & 1) * C,
                             &cnt[(i + 1) % 3]);
      } else if (threadIdx.x == 0) {
        cnt[(i + 2) % 3] = 0;
        s = add_chunk(s, buf + (i & 1) * C, c);
      }
      __syncthreads();
      if (!more) break;
      pos += C;
    }
    if (threadIdx.x == 0) out[slot] = s;
  }
}

int g_long_blocks = 0;

template <typename T>
cudaError_t run(const void* x, const void* gid, const void* emit, int W,
                long long n, long long S, void* out, long long* ws,
                cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)W * S * sizeof(T),
                                    stream);
  if (err != cudaSuccess) return err;
  const long long total = (long long)W * n;
  if (total == 0) return cudaSuccess;
  err = cudaMemsetAsync(ws, 0, sizeof(long long), stream);
  if (err != cudaSuccess) return err;
  if (g_long_blocks == 0) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    g_long_blocks = sms * (2048 / LB);
  }
  const long long blocks = (total + BT - 1) / BT;
  segment_sum_short<T><<<(unsigned)blocks, BT, 0, stream>>>(
      (const T*)x, (const long long*)gid, (const uint8_t*)emit, n, total, S,
      (T*)out, ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  segment_sum_long<T><<<g_long_blocks, LB, 0, stream>>>(
      (const T*)x, (const long long*)gid, (const uint8_t*)emit, (T*)out, ws);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the 64-bit words of the job list for W shards of n rows: a count, then
// JOB_WORDS a job; a job's run has more than LONG rows
long long sum_state_words(int W, long long n) {
  return 1 + ((long long)W * n / LONG + 1) * JOB_WORDS;
}

// dtype: 0 float16, 1 float32, 2 float64
int launch_segment_sum(const void* x, const void* gid, const void* emit,
                       int dtype, int W, long long n, long long S, void* out,
                       void* state, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long* ws = (long long*)state;
  cudaError_t err;
  switch (dtype) {
    case 0: err = run<__half>(x, gid, emit, W, n, S, out, ws, st); break;
    case 1: err = run<float>(x, gid, emit, W, n, S, out, ws, st); break;
    case 2: err = run<double>(x, gid, emit, W, n, S, out, ws, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
