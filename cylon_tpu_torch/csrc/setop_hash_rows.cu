// K9 setop_hash_rows: the hash stage of the set ops' stream route in one
// pass, for sm_90a. For every row of each shard's concatenation [left rows
// | right rows] it writes the row tag and the row's canonical u32 lanes
// into the int32 stack that the route's sort carries, the two 32-bit row
// hashes as int64 words, and the row's side and live flags.
//
// Replaces no Pallas kernel. The JAX package builds the same values in
// plain jnp (cylon_tpu/ops/setops.py:183 `_col_lanes`, the tag and
// cylon_tpu/ops/hash.py:91 `hash2_streams`), which XLA fuses into one
// elementwise pass; eager PyTorch runs that chain as ~190 int64 passes over
// the rows (ops/kernels.plain_setop_hash_rows keeps it as the plain
// version). Per row:
//   tag   = side<<31 | live<<29 | iota (side 1 on left rows, live = the
//           side's emit mask, or 1 without one);
//   lanes = each column's canonical u32 lanes, in column order: an 8-byte
//           column gives its hi and lo 32 bits, a narrower one its bits
//           widened (1- and 2-byte signed integers sign-extend), a bool 0
//           or 1; a float's -0.0 counts as +0.0 (its bits, never its value,
//           so NaN payloads and float16 keep their bits); where the pair
//           has validity, a null cell's lanes are 0 and a validity lane
//           (1 valid, 0 null) follows the column's;
//   h1    = fmix32 of the 31-combine of fmix32(lane), h2 = fmix32b of the
//           33-combine (from 0x9E3779B9) of fmix32b(lane); all-ones where
//           the row is not live.
//
// Bound on an H100 (3.35 TB/s): bytes. A row must read its columns (and
// the validity and emit bytes it has) and write (1 + L) 4-byte words and
// the two 4-byte hashes: 44 bytes for an int64 and a float64 column. The
// route's sort takes h1 and h2 as int64 words and the side and live flags
// as bytes, which adds 10 bytes a row here.
// The arithmetic, two avalanches a lane and two combines in 32-bit
// integers, is a few dozen operations a row, far below the time of the
// bytes.
//
// Design: a shard is a grid row (blockIdx.y); blocks walk the shard's
// tiles of TILE rows with a grid-stride loop, as many blocks as fit on the
// card at once. Thread t of a tile takes rows t, t + BT, ..., so each load
// and store of a warp covers consecutive rows: a plane of the stack gets
// whole 128-byte lines from 4-byte stores, h1 and h2 from 8-byte ones. A
// thread issues the loads of a column for UNROLL rows before it uses any.
// The hashes run in wrapping uint32 arithmetic, which gives the bits of
// the plain version's masked int64 products. Each output is written once;
// the flags and the running hashes stay in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 256;               // threads per block
constexpr int UNROLL = 4;             // rows a thread a tile
constexpr int TILE = BT * UNROLL;     // rows per tile
constexpr int MAXL = 12;              // u32 lanes (and columns) a launch
constexpr uint32_t NULL_TAG = 0x9E3779B9u;

// how a column's element becomes its lanes
enum Mode : int { kBool = 0, kUnsigned = 1, kSigned = 2, kFloat = 3 };

struct Args {
  const void* l[MAXL];        // the left side's column storage, [W, nl]
  const void* r[MAXL];        // the right side's, [W, nr]
  const uint8_t* lv[MAXL];    // each column's validity, or null
  const uint8_t* rv[MAXL];
  int width[MAXL];            // bytes of column c's element: 1, 2, 4, 8
  int mode[MAXL];             // Mode of column c
  int has_v[MAXL];            // 1 where the pair has a validity lane
  const uint8_t* lemit;       // emit masks; null: every row emits
  const uint8_t* remit;
  int* stack;                 // [1 + L, W, n]: the tag, then the lanes
  long long* h1;              // [W, n] each
  long long* h2;
  uint8_t* side;
  uint8_t* live;
  int ncols, W, nl, nr;
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

// the bits of one element of `width` bytes, zero-extended
__device__ __forceinline__ uint64_t load_bits(const void* p, int width,
                                              long long off) {
  switch (width) {
    case 8: return __ldg((const unsigned long long*)p + off);
    case 4: return __ldg((const unsigned int*)p + off);
    case 2: return __ldg((const unsigned short*)p + off);
    default: return __ldg((const unsigned char*)p + off);
  }
}

// an element's canonical bits: a bool 0 or 1, a narrow signed integer
// sign-extended to 32 bits, a float's -0.0 made +0.0
__device__ __forceinline__ uint64_t canonical(uint64_t v, int width,
                                              int mode) {
  if (mode == kBool) return v != 0;
  if (mode == kSigned) {
    return width == 1 ? (uint32_t)(int32_t)(int8_t)v
                      : (uint32_t)(int32_t)(int16_t)v;
  }
  if (mode == kFloat) {
    const uint64_t magnitude =
        width == 8 ? 0x7FFFFFFFFFFFFFFFull : (1ull << (8 * width - 1)) - 1;
    return (v & magnitude) == 0 ? 0ull : v;
  }
  return v;
}

__global__ void __launch_bounds__(BT)
setop_hash_rows_kernel(const Args p) {
  const int n = p.nl + p.nr;
  const int tiles = (n + TILE - 1) / TILE;
  const long long plane = (long long)p.W * n;
  for (int w = blockIdx.y; w < p.W; w += gridDim.y) {
    const long long out0 = (long long)w * n;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int row[UNROLL];          // index in the shard's concatenation
      bool in[UNROLL], left[UNROLL];
      long long src[UNROLL];    // offset in its side's [W, n_side] inputs
      uint32_t live[UNROLL], g1[UNROLL], g2[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = t * TILE + u * BT + (int)threadIdx.x;
        row[u] = i;
        in[u] = i < n;
        left[u] = i < p.nl;
        src[u] = left[u] ? (long long)w * p.nl + i
                         : (long long)w * p.nr + (i - p.nl);
        g1[u] = 0u;
        g2[u] = NULL_TAG;
        live[u] = 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!in[u]) continue;
        const uint8_t* em = left[u] ? p.lemit : p.remit;
        live[u] = em ? (__ldg(em + src[u]) != 0) : 1u;
      }
      long long k = 1;          // the stack's next plane (0 is the tag)
      // the column loop unrolled, so that the argument arrays are read at
      // fixed offsets from the kernel's parameters
#pragma unroll
      for (int c = 0; c < MAXL; ++c) {
        if (c < p.ncols) {
          const int width = p.width[c], mode = p.mode[c];
          const bool has_v = p.has_v[c] != 0;
          uint64_t v[UNROLL];
          uint32_t valid[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            v[u] = in[u] ? load_bits(left[u] ? p.l[c] : p.r[c], width,
                                     src[u])
                         : 0ull;
            const uint8_t* vm = left[u] ? p.lv[c] : p.rv[c];
            valid[u] = (in[u] && vm) ? (__ldg(vm + src[u]) != 0) : 1u;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (!in[u]) continue;
            const long long o = out0 + row[u];
            const uint64_t bits =
                valid[u] ? canonical(v[u], width, mode) : 0ull;
            uint32_t lane =
                width == 8 ? (uint32_t)(bits >> 32) : (uint32_t)bits;
            g1[u] = g1[u] * 31u + fmix32(lane);
            g2[u] = g2[u] * 33u + fmix32b(lane);
            p.stack[k * plane + o] = (int)lane;
            if (width == 8) {
              lane = (uint32_t)bits;
              g1[u] = g1[u] * 31u + fmix32(lane);
              g2[u] = g2[u] * 33u + fmix32b(lane);
              p.stack[(k + 1) * plane + o] = (int)lane;
            }
            if (has_v) {
              lane = valid[u];
              g1[u] = g1[u] * 31u + fmix32(lane);
              g2[u] = g2[u] * 33u + fmix32b(lane);
              p.stack[(k + 1 + (width == 8)) * plane + o] = (int)lane;
            }
          }
          k += 1 + (width == 8) + has_v;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!in[u]) continue;
        const long long o = out0 + row[u];
        p.stack[o] = (int)((left[u] ? 1u << 31 : 0u) | (live[u] << 29)
                           | (uint32_t)row[u]);
        p.h1[o] = live[u] ? fmix32(g1[u]) : 0xFFFFFFFFu;
        p.h2[o] = live[u] ? fmix32b(g2[u]) : 0xFFFFFFFFu;
        p.side[o] = left[u];
        p.live[o] = (uint8_t)live[u];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int setop_hash_lanes() { return MAXL; }

// l, r: the sides' column storage pointers; lv, rv: their validity (null
// entries: none); width, mode, has_v: each column's element bytes, Mode and
// validity lane; stack: the int32 [1 + L, W, nl + nr] output; sms: the
// card's SM count. Returns cudaGetLastError after the launch.
int launch_setop_hash_rows(const void* const* l, const void* const* r,
                           const void* const* lv, const void* const* rv,
                           const int* width, const int* mode,
                           const int* has_v, int ncols, const void* lemit,
                           const void* remit, void* stack, void* h1,
                           void* h2, void* side, void* live, int W, int nl,
                           int nr, int sms, void* stream) {
  if (ncols < 1 || W < 0 || nl < 0 || nr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int lanes = 0;
  for (int c = 0; c < ncols && c < MAXL; ++c)
    lanes += 1 + (width[c] == 8) + (has_v[c] != 0);
  if (ncols > MAXL || lanes > MAXL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((long long)nl + nr + TILE - 1) / TILE;
  if (W == 0 || tiles == 0) return static_cast<int>(cudaSuccess);
  Args p{};
  for (int c = 0; c < ncols; ++c) {
    p.l[c] = l[c];
    p.r[c] = r[c];
    p.lv[c] = (const uint8_t*)lv[c];
    p.rv[c] = (const uint8_t*)rv[c];
    p.width[c] = width[c];
    p.mode[c] = mode[c];
    p.has_v[c] = has_v[c];
  }
  p.lemit = (const uint8_t*)lemit;
  p.remit = (const uint8_t*)remit;
  p.stack = (int*)stack;
  p.h1 = (long long*)h1;
  p.h2 = (long long*)h2;
  p.side = (uint8_t*)side;
  p.live = (uint8_t*)live;
  p.ncols = ncols;
  p.W = W;
  p.nl = nl;
  p.nr = nr;
  static int per_sm = 0;  // resident blocks an SM (the same on every H100)
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, setop_hash_rows_kernel, BT, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gy = W < 65535 ? W : 65535;
  long long gx = (long long)sms * per_sm / gy;
  gx = gx < 1 ? 1 : (gx > tiles ? tiles : gx);
  setop_hash_rows_kernel<<<dim3((unsigned)gx, (unsigned)gy), BT, 0,
                           (cudaStream_t)stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
