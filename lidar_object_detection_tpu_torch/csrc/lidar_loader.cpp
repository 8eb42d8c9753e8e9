// Native scan loader of the PyTorch port: the port's own copy of the JAX
// package's csrc/lidar_loader.cpp, so that a fault in this layer can still
// be found against the reference.
//
// The reference loads Velodyne scans one np.fromfile at a time inside its
// Python frame loop (V1_BBox_Pointwise_filtering.py:24-28).  To keep the
// card fed the host needs more, so this loader provides:
//
//   * lidar_load_scan         -- one scan read and padded to a fixed shape,
//                                one fread straight into the caller's
//                                buffer,
//   * lidar_load_scan_compact -- the same with the camera-frustum cull
//                                (Compaction below),
//   * lidar_prefetcher_*      -- a multi-threaded read-ahead over a frame
//                                list with a bounded completion queue,
//                                overlapping disk IO with device work.
//
// A plain C ABI, loaded with ctypes.  data/native.py builds it on first
// use with g++ -O3 -std=c++17 -fPIC -shared -pthread.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <cmath>

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#endif

namespace {

constexpr int kFloatsPerPoint = 4;

// Host-side FOV/depth culling ("compaction").  The device pipeline keeps
// the exact validity test (geom/projection.py point_validity); the host
// cull only needs to be CONSERVATIVE -- it may keep extra points (the
// device masks them) but must never drop a device-valid one.  `margin`
// (pixels, default 1.0) plus a fixed 1e-3 depth slack absorb any float32
// rounding differences against the device; the predicate skips the round()
// entirely and widens the bounds by margin+0.5 instead.
struct Compaction {
  bool enabled = false;
  float proj[12];   // row-major 3x4: intrinsics @ velo_to_rect[:3, :]
  float width = 0, height = 0;
  float depth_min = 0, depth_max = 0;
  float margin = 1.0f;
};

// Filter n raw points (in[4n]) into out[max_out*4]; returns the compacted
// count, or -1 on overflow (the caller reports it; nothing is truncated).
long compact_points_scalar(const Compaction& c, const float* in, long n,
                           float* out, long max_out, long m = 0) {
  const float* P = c.proj;
  const float u_lo = -(c.margin + 0.5f), u_hi = c.width - 0.5f + c.margin;
  const float v_lo = u_lo, v_hi = c.height - 0.5f + c.margin;
  const float d_lo = c.depth_min - 1e-3f, d_hi = c.depth_max + 1e-3f;
  for (long i = 0; i < n; ++i) {
    const float x = in[4 * i], y = in[4 * i + 1], z = in[4 * i + 2];
    const float pz = P[8] * x + P[9] * y + P[10] * z + P[11];
    if (!(pz > d_lo && pz < d_hi)) continue;
    const float az = std::fabs(pz) > 1e-6f ? std::fabs(pz) : 1e-6f;
    const float pu = (P[0] * x + P[1] * y + P[2] * z + P[3]) / az;
    const float pv = (P[4] * x + P[5] * y + P[6] * z + P[7]) / az;
    if (!(pu >= u_lo && pu <= u_hi && pv >= v_lo && pv <= v_hi)) continue;
    if (m == max_out) return -1;
    out[4 * m] = x;
    out[4 * m + 1] = y;
    out[4 * m + 2] = z;
    out[4 * m + 3] = in[4 * i + 3];
    ++m;
  }
  std::memset(out + 4 * m, 0, (size_t)(max_out - m) * 4 * sizeof(float));
  return m;
}

#if defined(__x86_64__) && defined(__GNUC__)
// AVX-512 compaction: 16 points per iteration.  The AoS scan layout stays
// in four zmm registers for the output side (VCOMPRESSPS preserves lane
// order, so each surviving point's x,y,z,r stay adjacent); x/y/z are
// deinterleaved with two-level VPERMT2PS for the predicate math.  The
// predicate uses FMA where the scalar path has separate mul/add -- a
// <=1-ulp difference absorbed by the CONSERVATIVE margin (see Compaction),
// and the overflow/padding semantics match compact_points_scalar exactly.
__attribute__((target("avx512f")))
long compact_points_avx512(const Compaction& c, const float* in, long n,
                           float* out, long max_out) {
  const float* P = c.proj;
  const __m512 p0 = _mm512_set1_ps(P[0]), p1 = _mm512_set1_ps(P[1]),
               p2 = _mm512_set1_ps(P[2]), p3 = _mm512_set1_ps(P[3]),
               p4 = _mm512_set1_ps(P[4]), p5 = _mm512_set1_ps(P[5]),
               p6 = _mm512_set1_ps(P[6]), p7 = _mm512_set1_ps(P[7]),
               p8 = _mm512_set1_ps(P[8]), p9 = _mm512_set1_ps(P[9]),
               p10 = _mm512_set1_ps(P[10]), p11 = _mm512_set1_ps(P[11]);
  const __m512 u_lo = _mm512_set1_ps(-(c.margin + 0.5f));
  const __m512 u_hi = _mm512_set1_ps(c.width - 0.5f + c.margin);
  const __m512 v_hi = _mm512_set1_ps(c.height - 0.5f + c.margin);
  const __m512 d_lo = _mm512_set1_ps(c.depth_min - 1e-3f);
  const __m512 d_hi = _mm512_set1_ps(c.depth_max + 1e-3f);
  const __m512 eps = _mm512_set1_ps(1e-6f);
  const __m512 ones = _mm512_set1_ps(1.0f);
  // lane j of idx_c{0,1,2} selects component {x,y,z} of point j%8 from a
  // pair of AoS registers; idx_cat merges two such low halves
  const __m512i idx_c0 = _mm512_setr_epi32(0, 4, 8, 12, 16, 20, 24, 28,
                                           0, 0, 0, 0, 0, 0, 0, 0);
  const __m512i idx_c1 = _mm512_setr_epi32(1, 5, 9, 13, 17, 21, 25, 29,
                                           0, 0, 0, 0, 0, 0, 0, 0);
  const __m512i idx_c2 = _mm512_setr_epi32(2, 6, 10, 14, 18, 22, 26, 30,
                                           0, 0, 0, 0, 0, 0, 0, 0);
  const __m512i idx_cat = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7,
                                            16, 17, 18, 19, 20, 21, 22, 23);
  // 4-bit point mask -> 16-bit float-lane mask (each bit replicated x4)
  static const uint16_t kExpand4[16] = {
      0x0000, 0x000F, 0x00F0, 0x00FF, 0x0F00, 0x0F0F, 0x0FF0, 0x0FFF,
      0xF000, 0xF00F, 0xF0F0, 0xF0FF, 0xFF00, 0xFF0F, 0xFFF0, 0xFFFF};

  long m = 0;
  long i = 0;
  for (; i + 16 <= n; i += 16) {
    const __m512 a = _mm512_loadu_ps(in + 4 * i);        // points i+0..3
    const __m512 b = _mm512_loadu_ps(in + 4 * i + 16);   // points i+4..7
    const __m512 cc = _mm512_loadu_ps(in + 4 * i + 32);  // points i+8..11
    const __m512 d = _mm512_loadu_ps(in + 4 * i + 48);   // points i+12..15
    const __m512 x = _mm512_permutex2var_ps(
        _mm512_permutex2var_ps(a, idx_c0, b), idx_cat,
        _mm512_permutex2var_ps(cc, idx_c0, d));
    const __m512 y = _mm512_permutex2var_ps(
        _mm512_permutex2var_ps(a, idx_c1, b), idx_cat,
        _mm512_permutex2var_ps(cc, idx_c1, d));
    const __m512 z = _mm512_permutex2var_ps(
        _mm512_permutex2var_ps(a, idx_c2, b), idx_cat,
        _mm512_permutex2var_ps(cc, idx_c2, d));

    const __m512 pz = _mm512_fmadd_ps(
        p8, x, _mm512_fmadd_ps(p9, y, _mm512_fmadd_ps(p10, z, p11)));
    __mmask16 keep = _mm512_kand(_mm512_cmp_ps_mask(pz, d_lo, _CMP_GT_OQ),
                                 _mm512_cmp_ps_mask(pz, d_hi, _CMP_LT_OQ));
    if (keep == 0) continue;
    const __m512 az = _mm512_max_ps(_mm512_abs_ps(pz), eps);
    const __m512 inv = _mm512_div_ps(ones, az);
    const __m512 pu = _mm512_mul_ps(
        _mm512_fmadd_ps(p0, x,
                        _mm512_fmadd_ps(p1, y, _mm512_fmadd_ps(p2, z, p3))),
        inv);
    const __m512 pv = _mm512_mul_ps(
        _mm512_fmadd_ps(p4, x,
                        _mm512_fmadd_ps(p5, y, _mm512_fmadd_ps(p6, z, p7))),
        inv);
    keep = _mm512_kand(keep, _mm512_cmp_ps_mask(pu, u_lo, _CMP_GE_OQ));
    keep = _mm512_kand(keep, _mm512_cmp_ps_mask(pu, u_hi, _CMP_LE_OQ));
    keep = _mm512_kand(keep, _mm512_cmp_ps_mask(pv, u_lo, _CMP_GE_OQ));
    keep = _mm512_kand(keep, _mm512_cmp_ps_mask(pv, v_hi, _CMP_LE_OQ));
    const unsigned bits = (unsigned)keep;
    const __m512 groups[4] = {a, b, cc, d};
    for (int g = 0; g < 4; ++g) {
      const unsigned sub = (bits >> (4 * g)) & 0xF;
      if (sub == 0) continue;
      const int cnt = __builtin_popcount(sub);
      if (m + cnt > max_out) return -1;
      _mm512_mask_compressstoreu_ps(out + 4 * m, kExpand4[sub], groups[g]);
      m += cnt;
    }
  }
  // scalar tail handles the remaining n%16 points + padding/overflow
  return compact_points_scalar(c, in + 4 * i, n - i, out, max_out, m);
}
#endif  // __x86_64__ && __GNUC__

long compact_points(const Compaction& c, const float* in, long n,
                    float* out, long max_out) {
#if defined(__x86_64__) && defined(__GNUC__)
  // LIDAR_LOADER_NO_AVX512=1 pins the scalar path (parity tests, timing)
  static const bool have_avx512 =
      __builtin_cpu_supports("avx512f") &&
      std::getenv("LIDAR_LOADER_NO_AVX512") == nullptr;
  if (have_avx512) return compact_points_avx512(c, in, n, out, max_out);
#endif
  return compact_points_scalar(c, in, n, out, max_out);
}

// Read one .bin scan into out[max_points*4], zero-padded; valid[i] marks
// real points.  Returns 0 on success, negative errno-style codes otherwise.
int load_scan_impl(const char* path, float* out, int32_t max_points,
                   uint8_t* valid, int32_t* num_points) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes < 0 || bytes % (kFloatsPerPoint * (long)sizeof(float)) != 0) {
    std::fclose(f);
    return -2;
  }
  long n = bytes / (kFloatsPerPoint * (long)sizeof(float));
  if (n > max_points) {
    std::fclose(f);
    return -3;
  }
  size_t want = (size_t)n * kFloatsPerPoint;
  size_t got = std::fread(out, sizeof(float), want, f);
  std::fclose(f);
  if (got != want) return -4;
  std::memset(out + want, 0,
              ((size_t)max_points * kFloatsPerPoint - want) * sizeof(float));
  if (valid != nullptr) {
    std::memset(valid, 1, (size_t)n);
    std::memset(valid + n, 0, (size_t)(max_points - n));
  }
  if (num_points != nullptr) *num_points = (int32_t)n;
  return 0;
}

// Read + cull + pad: the compacted variant.  `scratch` is a reusable
// per-thread raw buffer.  Returns 0 on success, -3 on overflow of either
// the raw scratch read or the compacted output.
int load_scan_compact_impl(const char* path, const Compaction& c,
                           float* out, int32_t max_out, uint8_t* valid,
                           int32_t* num_points, int32_t* num_raw,
                           std::vector<float>& scratch) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes < 0 || bytes % (kFloatsPerPoint * (long)sizeof(float)) != 0) {
    std::fclose(f);
    return -2;
  }
  long n = bytes / (kFloatsPerPoint * (long)sizeof(float));
  if ((size_t)(n * kFloatsPerPoint) > scratch.size()) {
    scratch.resize((size_t)n * kFloatsPerPoint);
  }
  size_t want = (size_t)n * kFloatsPerPoint;
  size_t got = std::fread(scratch.data(), sizeof(float), want, f);
  std::fclose(f);
  if (got != want) return -4;
  long m = compact_points(c, scratch.data(), n, out, max_out);
  if (m < 0) return -3;
  if (valid != nullptr) {
    std::memset(valid, 1, (size_t)m);
    std::memset(valid + m, 0, (size_t)(max_out - m));
  }
  if (num_points != nullptr) *num_points = (int32_t)m;
  if (num_raw != nullptr) *num_raw = (int32_t)n;
  return 0;
}

struct Completed {
  int32_t index;
  int32_t num_points;
  int status;
  std::vector<float> data;
  std::vector<uint8_t> valid;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int32_t max_points;
  size_t queue_depth;
  Compaction compaction;

  std::mutex mu;
  std::condition_variable cv_space;   // producers wait for queue space
  std::condition_variable cv_ready;   // consumer waits for completions
  std::queue<Completed> done;
  size_t next_task = 0;
  size_t delivered = 0;
  bool shutdown = false;
  std::vector<std::thread> workers;

  void worker() {
    std::vector<float> scratch;
    for (;;) {
      size_t idx;
      {
        std::lock_guard<std::mutex> lock(mu);
        if (shutdown || next_task >= paths.size()) return;
        idx = next_task++;
      }
      Completed c;
      c.index = (int32_t)idx;
      c.data.resize((size_t)max_points * kFloatsPerPoint);
      c.valid.resize((size_t)max_points);
      if (compaction.enabled) {
        c.status = load_scan_compact_impl(
            paths[idx].c_str(), compaction, c.data.data(), max_points,
            c.valid.data(), &c.num_points, nullptr, scratch);
      } else {
        c.status = load_scan_impl(paths[idx].c_str(), c.data.data(),
                                  max_points, c.valid.data(), &c.num_points);
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_space.wait(lock,
                    [&] { return done.size() < queue_depth || shutdown; });
      if (shutdown) return;
      done.push(std::move(c));
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

int lidar_load_scan(const char* path, float* out, int32_t max_points,
                    uint8_t* valid, int32_t* num_points) {
  return load_scan_impl(path, out, max_points, valid, num_points);
}

// Compacted single-scan load: proj is the row-major 3x4
// intrinsics @ velo_to_rect[:3, :] matrix; points failing the widened
// FOV/depth test are dropped before padding.  num_raw (optional) receives
// the pre-cull count.
int lidar_load_scan_compact(const char* path, const float* proj,
                            float width, float height, float depth_min,
                            float depth_max, float margin, float* out,
                            int32_t max_out, uint8_t* valid,
                            int32_t* num_points, int32_t* num_raw) {
  Compaction c;
  c.enabled = true;
  std::memcpy(c.proj, proj, 12 * sizeof(float));
  c.width = width;
  c.height = height;
  c.depth_min = depth_min;
  c.depth_max = depth_max;
  c.margin = margin;
  std::vector<float> scratch;
  return load_scan_compact_impl(path, c, out, max_out, valid, num_points,
                                num_raw, scratch);
}

static Prefetcher* prefetcher_init(const char** paths, int32_t n_paths,
                                   int32_t max_points, int32_t n_threads,
                                   int32_t queue_depth,
                                   const Compaction& compaction) {
  auto* p = new Prefetcher();
  p->paths.reserve(n_paths);
  for (int32_t i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
  p->max_points = max_points;
  p->queue_depth = queue_depth > 0 ? (size_t)queue_depth : 4;
  p->compaction = compaction;
  int threads = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < threads; ++t) {
    p->workers.emplace_back(&Prefetcher::worker, p);
  }
  return p;
}

void* lidar_prefetcher_create(const char** paths, int32_t n_paths,
                              int32_t max_points, int32_t n_threads,
                              int32_t queue_depth) {
  return prefetcher_init(paths, n_paths, max_points, n_threads, queue_depth,
                         Compaction());
}

// Prefetcher with in-thread compaction: each worker reads the raw scan and
// emits only the ~quarter of points that can pass the device's FOV/depth
// validity, padded to max_out.
void* lidar_prefetcher_create_compact(const char** paths, int32_t n_paths,
                                      int32_t max_out, int32_t n_threads,
                                      int32_t queue_depth, const float* proj,
                                      float width, float height,
                                      float depth_min, float depth_max,
                                      float margin) {
  Compaction c;
  c.enabled = true;
  std::memcpy(c.proj, proj, 12 * sizeof(float));
  c.width = width;
  c.height = height;
  c.depth_min = depth_min;
  c.depth_max = depth_max;
  c.margin = margin;
  return prefetcher_init(paths, n_paths, max_out, n_threads, queue_depth, c);
}

// Pops the next completed scan (arrival order; frame identity returned via
// *frame_index).  Returns the scan's load status, or 1 when exhausted.
int lidar_prefetcher_next(void* handle, float* out, uint8_t* valid,
                          int32_t* num_points, int32_t* frame_index) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  if (p->delivered >= p->paths.size()) return 1;
  p->cv_ready.wait(lock, [&] { return !p->done.empty(); });
  Completed c = std::move(p->done.front());
  p->done.pop();
  p->delivered++;
  p->cv_space.notify_one();
  lock.unlock();
  std::memcpy(out, c.data.data(), c.data.size() * sizeof(float));
  if (valid != nullptr) std::memcpy(valid, c.valid.data(), c.valid.size());
  if (num_points != nullptr) *num_points = c.num_points;
  if (frame_index != nullptr) *frame_index = c.index;
  return c.status;
}

void lidar_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->shutdown = true;
  }
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
