// K10 permute_rows: moves the rows of the stream routes' sort stages as
// records of 32-bit words, for sm_90a. One launch, per shard and per
// output row i, reads the row's words from
//   - a list of [W, n] streams (int64 ones narrowed to their low 32 bits
//     on load), or a record array of G 16-byte granules a row,
// at row i, or at row idx[w, i] of an int64 [W, n] permutation (as
// torch.sort returns it), and writes them
//   - as a record of G granules (words past the last are 0), or split
//     into an int32 [words, W, n] array, one plane a word,
// and optionally the next sort's int64 key from the row's first words:
// the value of word 0 (in [0, 2^32)), or ((w0 << 32) | w1) ^ (1 << 63).
//
// Replaces no Pallas kernel: it is the payload operands of XLA's
// jax.lax.sort (cylon_tpu/ops/join.py:632, :645 and
// cylon_tpu/ops/setops.py:239), which XLA's sort moves with its keys.
// torch.sort moves no payload, so the port's sort stages gathered each
// stream by the permutation, one int64 gather a stream, and narrowed it
// afterwards (ops/join.plain_stream_sort and
// ops/setops.plain_setop_stream_sort keep that as the plain version).
//
// Bound on an H100 (3.35 TB/s): bytes, and the DRAM sector. A random
// 4- or 8-byte read costs a whole 32-byte sector, so a row gathered as
// seven streams costs seven sectors; a row of up to eight words in one
// 32-byte record costs one. The stage must move each row's final index
// and each 32-bit word it hands on, read once and written once: 48 bytes
// a row for the join cell's five words, 64 for the union cell's seven.
// The route's launches move more than that (the packs read int64 words,
// the intermediate records are written and read again, the keys are
// written for the next sort).
//
// Design: a shard is a grid row (blockIdx.y); blocks walk the shard's
// tiles with a grid-stride loop, as many blocks as fit on the card at
// once. Thread t of a tile takes rows t, t + BT, ..., so the index loads,
// the stream loads of an identity or nearly ordered permutation, the key
// stores and each plane of a split store cover consecutive rows of a
// warp: whole 128-byte lines. A record is loaded and stored as G uint4
// vectors, 16-byte aligned, so a record of two granules sits in one
// sector. A thread starts the index loads of its U rows, then all their
// record or stream loads, before it stores any, so many random reads are
// in flight on every SM. The record's width is a template parameter and
// the key comes from the first words, so every word index is a constant
// and the words stay in registers (a key from any word, chosen at run
// time, put them in local memory: 128 bytes of stack a thread, and the
// join cell's three launches took 28.0 ms against 21.9); no shared
// memory. Measured on an H100 at the cells' shapes, loading a record's
// granules by neighbouring threads (whole sectors an instruction, words
// exchanged by shuffles), storing them so, streaming stores, or 8 or 2
// rows a thread each moved the join's or the union's launches by under
// 4%, so the plain form stays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 256;     // threads per block
constexpr int MAXW = 17;    // words a row: the join's 3 + 6 key lanes + 8
constexpr int MAXG = 5;     // 16-byte granules a record: ceil(MAXW / 4)
constexpr uint64_t SIGN64 = 0x8000000000000000ull;

struct Args {
  const void* src[MAXW];    // stream sources, [W, n] each (null: a record
  int width[MAXW];          // source); their element bytes, 4 or 8
  const uint4* rec_in;      // record source, [W, n, G] granules, or null
  const long long* idx;     // [W, n] permutation, or null: row i reads i
  uint4* rec_out;           // record destination, or null
  int* split;               // split destination [words, W, n], or null
  long long* key;           // [W, n] key of the next sort, or null
  int words, W, n;
  int key_words;            // 1: the value of word 0; 2: words 0 and 1
};

template <int G, int U>
__global__ void __launch_bounds__(BT)
permute_rows_kernel(const Args p) {
  constexpr int R = 4 * G;      // words a record
  constexpr int TILE = BT * U;  // rows per tile
  const int tiles = (p.n + TILE - 1) / TILE;
  const long long plane = (long long)p.W * p.n;
  for (int w = blockIdx.y; w < p.W; w += gridDim.y) {
    const long long base = (long long)w * p.n;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int row[U];
      long long from[U];      // the source row's offset, -1 past the end
#pragma unroll
      for (int u = 0; u < U; ++u) {
        row[u] = t * TILE + u * BT + (int)threadIdx.x;
        from[u] = -1;
        if (row[u] < p.n)
          from[u] = base + (p.idx ? __ldg(p.idx + base + row[u]) : row[u]);
      }
      uint32_t v[U][R];
      if (p.rec_in) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            uint4 q = make_uint4(0u, 0u, 0u, 0u);
            if (from[u] >= 0) q = __ldg(p.rec_in + from[u] * G + g);
            v[u][4 * g] = q.x;
            v[u][4 * g + 1] = q.y;
            v[u][4 * g + 2] = q.z;
            v[u][4 * g + 3] = q.w;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const bool have = k < p.words;
          const uint32_t* s = (const uint32_t*)p.src[k];
          const int step = have ? p.width[k] >> 2 : 0;  // low word first
#pragma unroll
          for (int u = 0; u < U; ++u)
            v[u][k] = have && from[u] >= 0 ? __ldg(s + from[u] * step) : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (row[u] >= p.n) continue;
        const long long o = base + row[u];
        if (p.rec_out) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            p.rec_out[o * G + g] = make_uint4(v[u][4 * g], v[u][4 * g + 1],
                                              v[u][4 * g + 2],
                                              v[u][4 * g + 3]);
        }
        if (p.split) {
#pragma unroll
          for (int k = 0; k < R; ++k)
            if (k < p.words) p.split[k * plane + o] = (int)v[u][k];
        }
        if (p.key)
          p.key[o] = p.key_words == 1
              ? (long long)v[u][0]
              : (long long)((((uint64_t)v[u][0] << 32) | v[u][1]) ^ SIGN64);
      }
    }
  }
}

// rows a thread: four for records of one or two granules, two past that,
// so the words of a thread's rows stay in registers
template <int G>
int launch_g(const Args& p, int sms, cudaStream_t stream) {
  constexpr int U = G <= 2 ? 4 : 2;
  static int per_sm = 0;  // resident blocks an SM (the same on every H100)
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, permute_rows_kernel<G, U>, BT, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = ((long long)p.n + BT * U - 1) / (BT * U);
  const int gy = p.W < 65535 ? p.W : 65535;
  long long gx = (long long)sms * per_sm / gy;
  gx = gx < 1 ? 1 : (gx > tiles ? tiles : gx);
  permute_rows_kernel<G, U><<<dim3((unsigned)gx, (unsigned)gy), BT, 0,
                              stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int permute_row_words() { return MAXW; }

// src, width: the stream sources and their element bytes (words of them;
// unread when rec_in is set); rec_in: the record source or null; idx: the
// permutation or null; rec_out / split: the destination (exactly one);
// key: the key output or null, from the first key_words words (1 or 2);
// sms: the card's SM count. Returns cudaGetLastError after the launch.
int launch_permute_rows(const void* const* src, const int* width,
                        int words, const void* rec_in, const void* idx,
                        void* rec_out, void* split, void* key, int key_words,
                        int W, int n, int sms, void* stream) {
  if (words < 1 || words > MAXW || W < 0 || n < 0
      || (rec_out == nullptr) == (split == nullptr)
      || (key != nullptr && (key_words < 1 || key_words > 2
                             || key_words > words)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0 || n == 0) return static_cast<int>(cudaSuccess);
  Args p{};
  if (rec_in == nullptr) {
    for (int k = 0; k < words; ++k) {
      if (width[k] != 4 && width[k] != 8)
        return static_cast<int>(cudaErrorInvalidValue);
      p.src[k] = src[k];
      p.width[k] = width[k];
    }
  }
  p.rec_in = (const uint4*)rec_in;
  p.idx = (const long long*)idx;
  p.rec_out = (uint4*)rec_out;
  p.split = (int*)split;
  p.key = (long long*)key;
  p.words = words;
  p.W = W;
  p.n = n;
  p.key_words = key_words;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((words + 3) / 4) {
    case 1: return launch_g<1>(p, sms, s);
    case 2: return launch_g<2>(p, sms, s);
    case 3: return launch_g<3>(p, sms, s);
    case 4: return launch_g<4>(p, sms, s);
    default: return launch_g<MAXG>(p, sms, s);
  }
}

}  // extern "C"
