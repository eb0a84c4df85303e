// Single-pass chained scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016), and the coalesced tile load, shared by K3 (join_stream.cu) and
// K5 (setop_stream.cu), and by K6 (stream_compact.cu); K2 (partition.cu)
// uses the tile counter and the word conventions with a look-back of its
// own over many buckets.
//
// A kernel launches one block per (shard, tile) and takes its tile from an
// atomic counter (`take_tile`), so tiles start in stream order and a
// look-back only ever waits on a tile that is already running. A tile
// publishes its aggregate as soon as it has reduced its elements; warp 0
// then walks back over up to 32 predecessors at a time, combining their
// aggregates until it meets one that has published its inclusive prefix,
// and publishes its own inclusive prefix. The block-level scan is
// cub::BlockScan with `TilePrefix` as its prefix callback.
//
// A scan value V is V::NW 64-bit words. Bit 63 of a word marks it
// written, so a word is published with one store and read with one load,
// and a value counts as published when all its words are. The aggregate
// and the inclusive prefix live in separate words, so a reader that sees
// a tile half-way through publishing its inclusive prefix still reads a
// whole aggregate. State of one scan over T tiles: agg[NW][T] then
// incl[NW][T], all zero before the launch (the launcher's memset).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long WRITTEN = 1ull << 63;

struct ScanState {
  unsigned long long* agg;   // [NW][T]
  unsigned long long* incl;  // [NW][T]
  long long T;
};

// a scan's state at `base`: agg then incl, NW words per tile each
template <class V>
__host__ __device__ inline ScanState state_at(unsigned long long* base,
                                              long long T) {
  return ScanState{base, base + (long long)V::NW * T, T};
}

template <class V>
constexpr long long state_words(long long T) {
  return 2LL * V::NW * T;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// one word for a run composite (c, h): c in bits 0-30, h + 1 in 31-61
__device__ __forceinline__ unsigned long long pack_run(int c, int h) {
  return (unsigned long long)(unsigned)c
         | ((unsigned long long)(unsigned)(h + 1) << 31);
}
__device__ __forceinline__ int run_c(unsigned long long w) {
  return (int)(w & 0x7fffffffull);
}
__device__ __forceinline__ int run_h(unsigned long long w) {
  return (int)((w >> 31) & 0x7fffffffull) - 1;
}

// The run composite over a stream segment: c live rows of one kind, h the
// count of them before the segment's last run head (-1 without a head).
// Counts before a head never decrease along the stream, so the composite
// of two segments keeps the later head: h' >= 0 ? max(h, c + h') : h.
__device__ __forceinline__ void run_combine(int c, int h, int c2, int h2,
                                            int& co, int& ho) {
  ho = h2 >= 0 ? max(h, c + h2) : h;
  co = c + c2;
}

template <class V>
__device__ __forceinline__ void publish(const ScanState& s, long long g,
                                        bool inclusive, const V& v) {
  unsigned long long* dst = inclusive ? s.incl : s.agg;
#pragma unroll
  for (int k = 0; k < V::NW; ++k)
    st_relaxed(dst + k * s.T + g, v.word(k) | WRITTEN);
}

// Warp 0, all lanes: the exclusive prefix of tile t of the shard whose
// tile 0 has state index g0. Lane 0's value is the result.
template <class V>
__device__ V look_back(const ScanState& s, long long g0, long long t) {
  const int lane = threadIdx.x & 31;
  V excl = V::identity();
  long long pred = t - 1;
  while (true) {
    const long long k = pred - lane;  // lane 0: the nearest predecessor
    int status = 2;                   // 0 not yet, 1 aggregate, 2 inclusive
    V v = V::identity();
    if (k >= 0) {
      // both values in one round trip
      unsigned long long wi[V::NW], wa[V::NW];
#pragma unroll
      for (int i = 0; i < V::NW; ++i) {
        wi[i] = ld_relaxed(s.incl + i * s.T + g0 + k);
        wa[i] = ld_relaxed(s.agg + i * s.T + g0 + k);
      }
      bool inc = true, agg = true;
#pragma unroll
      for (int i = 0; i < V::NW; ++i) {
        inc = inc && (wi[i] & WRITTEN);
        agg = agg && (wa[i] & WRITTEN);
      }
      status = inc ? 2 : agg ? 1 : 0;
      if (status) v = V::from_words(inc ? wi : wa);
    }
    if (__any_sync(FULL, status == 0)) {
      __nanosleep(20);
      continue;
    }
    const unsigned pmask = __ballot_sync(FULL, status == 2);
    const int stop = pmask ? __ffs(pmask) - 1 : 31;
    if (lane > stop) v = V::identity();
    // ordered reduction: higher lanes hold older tiles
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V o = v.shfl_down(d);
      if (lane + d < 32) v = V::combine(o, v);
    }
    excl = V::combine(v, excl);
    if (pmask) return excl;
    pred -= 32;
  }
}

// cub::BlockScan prefix callback: called by warp 0 with the tile's
// aggregate; publishes it, looks back, publishes the inclusive prefix and
// returns the exclusive one. Lane 0 also leaves both in shared memory.
template <class V>
struct TilePrefix {
  ScanState s;
  long long g0;  // state index of the shard's tile 0
  long long t;   // tile within the shard
  V* s_excl;
  V* s_agg;
  __device__ V operator()(const V& agg) {
    const int lane = threadIdx.x & 31;
    V excl = V::identity();
    if (t == 0) {
      if (lane == 0) publish(s, g0, true, agg);
    } else {
      if (lane == 0) publish(s, g0 + t, false, agg);
      excl = look_back<V>(s, g0, t);
      if (lane == 0) publish(s, g0 + t, true, V::combine(excl, agg));
    }
    if (lane == 0) {
      *s_excl = excl;
      *s_agg = agg;
    }
    return excl;
  }
};

template <class V>
struct Combine {
  __device__ __forceinline__ V operator()(const V& a, const V& b) const {
    return V::combine(a, b);
  }
};

// The block's tile from the launch-wide counter, in start order.
__device__ __forceinline__ unsigned take_tile(unsigned* counter,
                                              unsigned* s_slot) {
  if (threadIdx.x == 0) *s_slot = atomicAdd(counter, 1u);
  __syncthreads();
  return *s_slot;
}

// Copy elements [g0 - 1, g0 + cnt) of up to three flat 32-bit streams of
// `total` elements into shared memory, dst[s][HALO + j] = src[s][g0 + j],
// with 16-byte loads from the aligned address at or below g0 - 1 (a
// stream whose base is not 16-byte aligned, or the last partial chunk,
// loads word by word). Every load of a thread is issued before its first
// store, so the tile costs one memory latency. Words past the range land
// in dst's slack.
template <int BT, int HALO, int TILE>
__device__ __forceinline__ void load_tile(const uint32_t* const* src,
                                          uint32_t* const* dst, int ns,
                                          long long g0, int cnt,
                                          long long total) {
  static_assert(HALO >= 4, "the aligned start may be 4 words early");
  constexpr int CH = (TILE / 4 + 2 + BT - 1) / BT;  // chunks per thread
  const long long first = g0 > 0 ? g0 - 1 : 0;
  const long long a = first & ~3LL;
  const long long e = g0 + cnt;
  const int chunks = e > a ? (int)((e - a + 3) >> 2) : 0;
  bool vec[3];
#pragma unroll
  for (int s = 0; s < 3; ++s)
    vec[s] = s < ns && ((uintptr_t)src[s] & 15) == 0;
  uint4 v[CH][3];
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int c = threadIdx.x + q * BT;
    const long long base = a + 4LL * c;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s >= ns || c >= chunks) continue;
      if (vec[s] && base + 4 <= total) {
        v[q][s] = __ldg(reinterpret_cast<const uint4*>(src[s] + base));
      } else {
        v[q][s].x = base < total ? src[s][base] : 0u;
        v[q][s].y = base + 1 < total ? src[s][base + 1] : 0u;
        v[q][s].z = base + 2 < total ? src[s][base + 2] : 0u;
        v[q][s].w = base + 3 < total ? src[s][base + 3] : 0u;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int c = threadIdx.x + q * BT;
    const int d = (int)(a + 4LL * c - g0) + HALO;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s >= ns || c >= chunks) continue;
      dst[s][d] = v[q][s].x;
      dst[s][d + 1] = v[q][s].y;
      dst[s][d + 2] = v[q][s].z;
      dst[s][d + 3] = v[q][s].w;
    }
  }
}

}  // namespace lookback
