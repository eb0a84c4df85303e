// cylon_tpu_torch native host runtime.
//
// The host half of the engine: the pieces that run before a table moves
// to the card or after it comes back, and would otherwise be bound by
// Python loops (reference: the partition kernels and murmur3 of
// arrow_partition_kernels.hpp:29-226 and util/murmur3.cpp, the CSV writer
// of table.cpp:1091-1142 PrintToOStream, the memory pool of
// ctx/memory_pool.hpp:25-66):
//   * row hashing + hash partition (bit-identical to ops/hash.py, so a
//     host ingest places rows where a device shuffle would),
//   * a multithreaded numeric CSV writer,
//   * Arrow validity-bitmap pack/unpack,
//   * an aligned, reusable staging-buffer pool.
//
// C API only, bound with ctypes by cylon_tpu_torch/native.py, which builds
// this file at first use with the host C++ compiler (g++ -O3 -std=c++17
// -shared -fPIC -pthread, or $CXX) into cylon_tpu_torch/_build/.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kNullTag = 0x9E3779B9u;  // ops/hash.py null hash tag

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

inline uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 33;
  return h;
}

// Run fn(begin, end) over [0, n) on up to nthreads threads.
template <typename F>
void parallel_for(int64_t n, int nthreads, F fn) {
  if (nthreads <= 1 || n < (1 << 14)) {
    fn(0, n);
    return;
  }
  int nt = nthreads;
  int64_t chunk = (n + nt - 1) / nt;
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    ts.emplace_back([=] { fn(b, e); });
  }
  for (auto& t : ts) t.join();
}

// A float cell: %g text with the digits that read back to the same bits
// (%.9g for float32, %.17g for float64). An integral value prints with
// no point and no exponent ("2", "-0"), which a CSV reader would type
// as an integer column: ".0" is appended, so a float column reads back
// as a float column. Text with an exponent or "inf" is left as it is.
int float_field(char* buf, size_t size, const char* fmt, double v) {
  int len = std::snprintf(buf, size, fmt, v);
  for (int k = 0; k < len; ++k)
    if (buf[k] != '-' && (buf[k] < '0' || buf[k] > '9')) return len;
  buf[len++] = '.';
  buf[len++] = '0';
  return len;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Row hashing / hash partition (host mirror of ops/hash.py: per-column
// fmix32 / fmix64-fold of order-normalized bits, 31*h + hc combine, final
// fmix32 — reference combine scheme arrow_partition_kernels.cpp:90-99).
// cols[i]: pointer to column i's order-normalized bits; widths[i] in {4,8};
// valids[i]: byte mask (1 = valid) or nullptr.
// ---------------------------------------------------------------------------

void ct_row_hash(const void** cols, const int32_t* widths,
                 const uint8_t** valids, int32_t ncols, int64_t n,
                 uint32_t* out, int32_t nthreads) {
  parallel_for(n, nthreads, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      uint32_t h = 0;
      for (int32_t c = 0; c < ncols; ++c) {
        uint32_t hc;
        if (widths[c] == 8) {
          uint64_t v = reinterpret_cast<const uint64_t*>(cols[c])[i];
          uint64_t m = fmix64(v);
          hc = static_cast<uint32_t>(m ^ (m >> 32));
        } else {
          hc = fmix32(reinterpret_cast<const uint32_t*>(cols[c])[i]);
        }
        if (valids[c] != nullptr && !valids[c][i]) hc = kNullTag;
        h = h * 31u + hc;
      }
      out[i] = fmix32(h);
    }
  });
}

// targets[i] = hash % world; counts[t] = per-target row count (len world).
void ct_partition_from_hash(const uint32_t* h, int64_t n, uint32_t world,
                            int32_t* targets, int64_t* counts,
                            int32_t nthreads) {
  int nt = nthreads < 1 ? 1 : nthreads;
  std::vector<std::vector<int64_t>> local(nt,
                                          std::vector<int64_t>(world, 0));
  std::atomic<int> tid{0};
  parallel_for(n, nt, [&](int64_t b, int64_t e) {
    auto& mine = local[tid.fetch_add(1) % nt];
    for (int64_t i = b; i < e; ++i) {
      uint32_t t = h[i] % world;
      targets[i] = static_cast<int32_t>(t);
      mine[t] += 1;
    }
  });
  for (uint32_t t = 0; t < world; ++t) {
    int64_t s = 0;
    for (int k = 0; k < nt; ++k) s += local[k][t];
    counts[t] = s;
  }
}

// Stable bucket gather: order[i] = input row of the i-th output row when
// rows are grouped by target (the split-kernel analog,
// arrow_kernels.cpp:24-134, as one permutation instead of per-target
// builders).
void ct_partition_order(const int32_t* targets, int64_t n,
                        const int64_t* counts, uint32_t world,
                        int64_t* order) {
  std::vector<int64_t> off(world + 1, 0);
  for (uint32_t t = 0; t < world; ++t) off[t + 1] = off[t] + counts[t];
  for (int64_t i = 0; i < n; ++i) order[off[targets[i]]++] = i;
}

// ---------------------------------------------------------------------------
// Validity bitmap pack/unpack (Arrow LSB bit order).
// ---------------------------------------------------------------------------

void ct_pack_bitmap(const uint8_t* bytes, int64_t n, uint8_t* bits) {
  int64_t nb = (n + 7) / 8;
  std::memset(bits, 0, nb);
  for (int64_t i = 0; i < n; ++i)
    if (bytes[i]) bits[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
}

void ct_unpack_bitmap(const uint8_t* bits, int64_t n, uint8_t* bytes) {
  for (int64_t i = 0; i < n; ++i)
    bytes[i] = (bits[i >> 3] >> (i & 7)) & 1u;
}

// ---------------------------------------------------------------------------
// Multithreaded numeric CSV writer (reference: Table::PrintToOStream /
// WriteCSV row-major stringify, table.cpp:1091-1142 — C++ there, C++ here;
// the Python fallback goes through pandas). dtype codes: 0=i32 1=i64
// 2=f32 3=f64 4=u32 5=u64. Null cells write empty fields; an integral
// float cell ends in ".0" (float_field).
// Returns bytes written, or -1 on IO error.
// ---------------------------------------------------------------------------

int64_t ct_write_csv(const void** cols, const int32_t* dtypes,
                     const uint8_t** valids, int32_t ncols, int64_t nrows,
                     const char** names, char sep, const char* path,
                     int32_t nthreads) {
  FILE* f = std::fopen(path, "wb");
  if (f == nullptr) return -1;
  std::string header;
  for (int32_t c = 0; c < ncols; ++c) {
    if (c) header.push_back(sep);
    header += names[c];
  }
  header.push_back('\n');

  int nt = nthreads < 1 ? 1 : nthreads;
  int64_t chunk = (nrows + nt - 1) / nt;
  std::vector<std::string> parts(nt);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(nrows, b + chunk);
    if (b >= e) break;
    ts.emplace_back([&, t, b, e] {
      std::string& s = parts[t];
      s.reserve(static_cast<size_t>((e - b) * ncols * 8));
      char buf[40];
      for (int64_t i = b; i < e; ++i) {
        for (int32_t c = 0; c < ncols; ++c) {
          if (c) s.push_back(sep);
          if (valids[c] != nullptr && !valids[c][i]) continue;
          int len = 0;
          switch (dtypes[c]) {
            case 0:
              len = std::snprintf(buf, sizeof buf, "%d",
                                  reinterpret_cast<const int32_t*>(cols[c])[i]);
              break;
            case 1:
              len = std::snprintf(
                  buf, sizeof buf, "%lld",
                  static_cast<long long>(
                      reinterpret_cast<const int64_t*>(cols[c])[i]));
              break;
            case 2: {
              // NaN serializes as an empty field, matching the pandas
              // fallback path so output is writer-independent.
              float v = reinterpret_cast<const float*>(cols[c])[i];
              if (std::isnan(v)) break;
              len = float_field(buf, sizeof buf, "%.9g",
                                static_cast<double>(v));
              break;
            }
            case 3: {
              double v = reinterpret_cast<const double*>(cols[c])[i];
              if (std::isnan(v)) break;
              len = float_field(buf, sizeof buf, "%.17g", v);
              break;
            }
            case 4:
              len = std::snprintf(buf, sizeof buf, "%u",
                                  reinterpret_cast<const uint32_t*>(cols[c])[i]);
              break;
            case 5:
              len = std::snprintf(
                  buf, sizeof buf, "%llu",
                  static_cast<unsigned long long>(
                      reinterpret_cast<const uint64_t*>(cols[c])[i]));
              break;
            default:
              break;
          }
          s.append(buf, static_cast<size_t>(len));
        }
        s.push_back('\n');
      }
    });
  }
  for (auto& t : ts) t.join();

  int64_t written = 0;
  if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
    std::fclose(f);
    return -1;
  }
  written += static_cast<int64_t>(header.size());
  for (auto& s : parts) {
    if (!s.empty() && std::fwrite(s.data(), 1, s.size(), f) != s.size()) {
      std::fclose(f);
      return -1;
    }
    written += static_cast<int64_t>(s.size());
  }
  std::fclose(f);
  return written;
}

// ---------------------------------------------------------------------------
// Staging buffer pool: aligned host buffers reused across host<->device
// transfers (the MemoryPool analog, ctx/memory_pool.hpp:25-66 — device
// memory is XLA's, but staging memory is ours). Power-of-two size classes;
// free buffers are kept per class until ct_pool_trim.
// ---------------------------------------------------------------------------

namespace {
std::mutex g_pool_mu;
std::multimap<size_t, void*> g_pool_free;
size_t g_pool_bytes_free = 0;
size_t g_pool_bytes_live = 0;

size_t size_class(size_t n) {
  size_t c = 4096;
  while (c < n) c <<= 1;
  return c;
}
}  // namespace

void* ct_pool_alloc(size_t n) {
  size_t cls = size_class(n);
  {
    std::lock_guard<std::mutex> lk(g_pool_mu);
    auto it = g_pool_free.find(cls);
    if (it != g_pool_free.end()) {
      void* p = it->second;
      g_pool_free.erase(it);
      g_pool_bytes_free -= cls;
      g_pool_bytes_live += cls;
      return p;
    }
  }
  void* p = nullptr;
  if (posix_memalign(&p, 64, cls) != 0) return nullptr;
  std::lock_guard<std::mutex> lk(g_pool_mu);
  g_pool_bytes_live += cls;
  return p;
}

void ct_pool_free(void* p, size_t n) {
  if (p == nullptr) return;
  size_t cls = size_class(n);
  std::lock_guard<std::mutex> lk(g_pool_mu);
  g_pool_free.emplace(cls, p);
  g_pool_bytes_free += cls;
  g_pool_bytes_live -= cls;
}

void ct_pool_trim() {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  for (auto& kv : g_pool_free) std::free(kv.second);
  g_pool_free.clear();
  g_pool_bytes_free = 0;
}

void ct_pool_stats(int64_t* bytes_live, int64_t* bytes_free) {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  *bytes_live = static_cast<int64_t>(g_pool_bytes_live);
  *bytes_free = static_cast<int64_t>(g_pool_bytes_free);
}

int32_t ct_version() { return 1; }

}  // extern "C"
