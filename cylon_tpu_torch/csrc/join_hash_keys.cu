// K8 join_hash_keys: the hash stage of the join's hash-stream route in one
// pass, for sm_90a. For every row of each shard's concatenation [a rows |
// b rows] it writes the packed row tag, the key's u32 lanes, the two
// 32-bit row hashes and the packed sort key, each as an int64 word.
//
// Replaces no Pallas kernel. The JAX package builds the same values in
// plain jnp (cylon_tpu/ops/join.py:598-631), which XLA fuses into one
// elementwise pass; eager PyTorch runs that chain as ~100 int64 passes
// over the rows (ops/kernels.plain_join_hash_keys keeps it as the plain
// version). Per row:
//   tag  = side<<31 | emit<<30 | live<<29 | iota, live = emit & kv;
//   lanes: an 8-byte key column gives its hi and lo 32 bits, a narrower
//          one its zero-extended bits;
//   h1   = fmix32 of the 31-combine of fmix32(lane), h2 = fmix32b of the
//          33-combine (from 0x9E3779B9) of fmix32b(lane); all-ones at
//          rows that are not live;
//   key  = ((h2 << 32) | tag) ^ (1 << 63).
//
// Bound on an H100 (3.35 TB/s): bytes. A row reads its key columns and
// two mask bytes (key validity, emit) and writes (4 + lanes) int64 words:
// 56-58 bytes for one 8-byte key. The arithmetic, two avalanches a lane
// and two combines in 32-bit integers, is a few dozen operations a row,
// far below the time of the bytes.
//
// Design: a shard is a grid row (blockIdx.y); blocks walk the shard's
// tiles of TILE rows with a grid-stride loop, as many blocks as fit on
// the card at once. Thread t of a tile takes rows t, t + BT, ..., so each
// load and store of a warp covers consecutive rows (8-byte stores of a
// warp fill whole 128-byte lines), and a thread has the loads of UNROLL
// rows in flight before it uses any. The hashes run in wrapping uint32
// arithmetic, which gives the bits of the plain version's masked int64
// products. Each output is written once; the flags stay in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 256;               // threads per block
constexpr int UNROLL = 4;             // rows a thread a tile
constexpr int TILE = BT * UNROLL;     // rows per tile
constexpr int MAXC = 6;               // key columns (u32 lanes) a launch
constexpr uint32_t NULL_TAG = 0x9E3779B9u;
constexpr uint64_t SIGN64 = 0x8000000000000000ull;

struct Args {
  const void* a[MAXC];      // side a's key bits, [W, na] each
  const void* b[MAXC];      // side b's, [W, nb]
  int width[MAXC];          // bytes of column c's container: 1, 2, 4, 8
  long long* hi[MAXC];      // column c's first u32 lane (hi of 8 bytes)
  long long* lo[MAXC];      // its second (lo of 8 bytes), or null
  const uint8_t* akv;       // key validity, [W, na] / [W, nb]
  const uint8_t* bkv;
  const uint8_t* aemit;     // emit masks; null: every row emits
  const uint8_t* bemit;
  long long* tag;           // outputs, [W, na + nb] each
  long long* h1;
  long long* h2;
  long long* key;
  int ncols, W, na, nb;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t fmix32b(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

// the unsigned value of one key element of `width` bytes
__device__ __forceinline__ uint64_t load_bits(const void* p, int width,
                                              long long off) {
  switch (width) {
    case 8: return __ldg((const unsigned long long*)p + off);
    case 4: return __ldg((const unsigned int*)p + off);
    case 2: return __ldg((const unsigned short*)p + off);
    default: return __ldg((const unsigned char*)p + off);
  }
}

__global__ void __launch_bounds__(BT)
join_hash_keys_kernel(const Args p) {
  const int n = p.na + p.nb;
  const int tiles = (n + TILE - 1) / TILE;
  for (int w = blockIdx.y; w < p.W; w += gridDim.y) {
    const long long out0 = (long long)w * n;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int row[UNROLL];          // index in the shard's concatenation
      bool in[UNROLL], side_a[UNROLL];
      long long src[UNROLL];    // offset in its side's [W, n_side] inputs
      uint32_t flags[UNROLL], g1[UNROLL], g2[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = t * TILE + u * BT + (int)threadIdx.x;
        row[u] = i;
        in[u] = i < n;
        side_a[u] = i < p.na;
        src[u] = side_a[u] ? (long long)w * p.na + i
                           : (long long)w * p.nb + (i - p.na);
        g1[u] = 0u;
        g2[u] = NULL_TAG;
        flags[u] = 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!in[u]) continue;
        const uint8_t* em = side_a[u] ? p.aemit : p.bemit;
        const uint32_t e = em ? (__ldg(em + src[u]) != 0) : 1u;
        const uint32_t kv = __ldg((side_a[u] ? p.akv : p.bkv) + src[u]) != 0;
        flags[u] = (side_a[u] ? 1u << 31 : 0u) | (e << 30) | ((e & kv) << 29);
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < p.ncols) {
          const int width = p.width[c];
          uint64_t v[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            v[u] = in[u] ? load_bits(side_a[u] ? p.a[c] : p.b[c], width,
                                     src[u])
                         : 0ull;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (!in[u]) continue;
            const long long o = out0 + row[u];
            const uint32_t first = width == 8 ? (uint32_t)(v[u] >> 32)
                                              : (uint32_t)v[u];
            g1[u] = g1[u] * 31u + fmix32(first);
            g2[u] = g2[u] * 33u + fmix32b(first);
            p.hi[c][o] = first;
            if (width == 8) {
              const uint32_t second = (uint32_t)v[u];
              g1[u] = g1[u] * 31u + fmix32(second);
              g2[u] = g2[u] * 33u + fmix32b(second);
              p.lo[c][o] = second;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!in[u]) continue;
        const long long o = out0 + row[u];
        const bool live = (flags[u] >> 29) & 1u;
        const uint32_t r1 = live ? fmix32(g1[u]) : 0xFFFFFFFFu;
        const uint32_t r2 = live ? fmix32b(g2[u]) : 0xFFFFFFFFu;
        const uint32_t tg = flags[u] | (uint32_t)row[u];
        p.tag[o] = tg;
        p.h1[o] = r1;
        p.h2[o] = r2;
        p.key[o] = (long long)((((uint64_t)r2 << 32) | tg) ^ SIGN64);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int hash_key_columns() { return MAXC; }

// a, b: the sides' key-bit pointers; width: each column's bytes; hi, lo:
// each column's lane outputs (lo null for a column of <= 4 bytes); sms:
// the card's SM count. Returns cudaGetLastError after the launch.
int launch_join_hash_keys(const void* const* a, const void* const* b,
                          const int* width, int ncols, void* const* hi,
                          void* const* lo, const void* akv, const void* bkv,
                          const void* aemit, const void* bemit, void* tag,
                          void* h1, void* h2, void* key, int W, int na,
                          int nb, int sms, void* stream) {
  if (ncols < 1 || ncols > MAXC || W < 0 || na < 0 || nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((long long)na + nb + TILE - 1) / TILE;
  if (W == 0 || tiles == 0) return static_cast<int>(cudaSuccess);
  Args p{};
  for (int c = 0; c < ncols; ++c) {
    p.a[c] = a[c];
    p.b[c] = b[c];
    p.width[c] = width[c];
    p.hi[c] = (long long*)hi[c];
    p.lo[c] = (long long*)lo[c];
  }
  p.akv = (const uint8_t*)akv;
  p.bkv = (const uint8_t*)bkv;
  p.aemit = (const uint8_t*)aemit;
  p.bemit = (const uint8_t*)bemit;
  p.tag = (long long*)tag;
  p.h1 = (long long*)h1;
  p.h2 = (long long*)h2;
  p.key = (long long*)key;
  p.ncols = ncols;
  p.W = W;
  p.na = na;
  p.nb = nb;
  static int per_sm = 0;  // resident blocks an SM (the same on every H100)
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, join_hash_keys_kernel, BT, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gy = W < 65535 ? W : 65535;
  long long gx = (long long)sms * per_sm / gy;
  gx = gx < 1 ? 1 : (gx > tiles ? tiles : gx);
  join_hash_keys_kernel<<<dim3((unsigned)gx, (unsigned)gy), BT, 0,
                          (cudaStream_t)stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
