// Inside-count kernel (K1) of the fusion step, for sm_90a.
//
// Replaces: lidar_object_detection_tpu/ops/pallas_count.py,
//   pallas_inside_counts_packed (kernel body _count_kernel).
//
// What it computes, for every frame b of a batch.  Point p has the packed
// membership word bits[b, p] (bit d = the point lies in detection d's
// mask) and is inside box g when all three projections
// ((x*a_x + y*a_y) + z*a_z) + o of the box frame lie in [0, 1].
// counts[b, d, g] counts detection d's points inside box g, and
// totals[b, d] counts detection d's points.  Invalid boxes (box_mask
// false) never hold a point: the twin encodes them with zero axes and
// offset -2, whose projection is -2 or NaN, so skipping them changes
// nothing.
//
// What bounds it on an H100.  The bound counts the function's work: every
// point with a non-zero word against every valid box, about 15 fp32
// operations per (active point, valid box) pair; an invalid box holds no
// point by definition.  At the smoke's shapes (65 k active points of
// 131 k, 300 valid boxes of 384) that is 0.29 G operations per frame,
// 4.4 us at the 67 TFLOP/s peak, while the 2 MB of points and words take
// 0.6 us at 3.35 TB/s: bound by operations.  The peak counts a fused
// multiply-add as two operations; this kernel may not fuse (see below), so
// its floor in issued fp32 instructions for that work is about twice the
// bound.  It does less work than that instead: most pairs are culled.
//
// What the design does about it.
// * One launch per batch: the grid is (blocks per frame, B), with enough
//   blocks for every resident slot of the card.  A frame is cut into steps
//   of 512 consecutive points, and block i takes steps i, i + blocks, ...
//   (at most 32768 points), so that the active points, which a scan holds
//   in runs (the cars), spread over all blocks.
// * Full warps.  A block streams its steps (the next step's loads in
//   flight while this one is counted) and compacts the points with a
//   non-zero word into a shared buffer (a warp ballot, then a prefix over
//   the 16 warps).  Whenever 512 active points are buffered, they are
//   counted, 32 per warp, one per lane; so no lane tests boxes for a point
//   that has no detection.  Blocks of 512 threads (two on an SM) measured
//   faster than blocks of 256 (three on an SM): larger rounds sort into
//   tighter groups.
// * Groups that are small in space.  Before counting, the round's points
//   are sorted by cell of an 8 x 8 grid over their x-y extent, in Z order
//   (a counting sort in shared memory), so that the 32 points of a warp lie
//   close together even where the scan order does not put them so.
// * Culling by bounding boxes.  The block keeps each valid box's frame
//   (three float4) and the bounds of the corners' parallelepiped in shared
//   memory.  A warp takes the bounds of its 32 points and tests 32 boxes at
//   once, one per lane; only boxes whose widened bounds meet the group's go
//   on to the slab tests.  The widening keeps every point that tests inside
//   (see box_bounds); a box whose edges are not close to orthogonal is
//   never culled.
// * Slab tests by broadcast, early exits by vote.  A warp takes its
//   candidate boxes four at a time, so that four independent chains of
//   loads and products hide each other's latency; every lane reads the same
//   frame rows, and after each slab the warp votes and leaves the four
//   boxes when no lane is still inside any of them.
// * No per-hit atomics.  Per group, lane d holds the ballot of plane d of
//   the 32 words.  For a box that holds some of the points (ballot m), lane
//   d adds popc(m & plane_d) to the block's (D, G) table with one shared
//   atomic.  The table holds two 16-bit counters per 32-bit word (a block
//   counts at most 32768 points, so a counter never carries into its
//   neighbour).  At the end the block adds its non-zero counters to the
//   zeroed int32 output with global atomics.  Counts are integers: neither
//   the sort nor the order of the additions changes them.
// * Bit-for-bit equality with the twin.  Each projection is
//   ((x*a0 + y*a1) + z*a2) + o with every product and sum rounded on its
//   own (__fmul_rn / __fadd_rn), in the order of geom/boxes.py
//   inside_from_frame, so no fused multiply-add moves a point across a
//   face.  The slab tests are ANDed; their order does not matter.
//
// Profile builds (tools/k1_profile.py) define one of these; the library
// the port loads defines none.  K1_THREADS and K1_STEP replace kThreads
// and kStep.  K1_NO_SORT, K1_NO_CULL, K1_NO_SLABS and K1_LOAD_ONLY leave
// out the round's sort, the culling, the slab tests, or all counting: the
// counts are then wrong, only the time means something.  K1_PROFILE
// records, per block, its SM and start and end times, and per warp the
// clocks spent counting groups and waiting at the barrier after them, the
// groups and the steps of kStep boxes (inside_counts_profile_buffer).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef K1_THREADS
#define K1_THREADS 512
#endif
#ifndef K1_STEP
#define K1_STEP 4
#endif

constexpr int kThreads = K1_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 32768;     // points per block: 16-bit counters
constexpr int kGrid = 8;             // cells per axis of the round's sort
constexpr int kStep = K1_STEP;       // candidate boxes a warp tests at once
constexpr float kRound = 1e-4f;      // widening per unit of magnitude
constexpr float kSkew = 2e-2f;       // widening per unit of edge length
constexpr float kMaxSkew = 1e-3f;    // cosine x aspect above which no cull
constexpr unsigned kFull = 0xffffffffu;

#ifdef K1_PROFILE
// per block 1 + kWarps records of 4 words: {start ns, end ns, SM, 0},
// then per warp {clocks counting, clocks waiting, groups, steps}
__device__ unsigned long long* g_profile;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// around each round's count_group: the clocks spent counting, then those
// spent at a barrier until the block's slowest warp is done
#define K1_CLOCK(c) const long long c = clock64()
#define K1_ROUND_END(c)                                \
  do {                                                 \
    const long long c1_ = clock64();                   \
    __syncthreads();                                   \
    busy += c1_ - (c);                                 \
    wait += clock64() - c1_;                           \
    ++groups;                                          \
  } while (0)
#else
#define K1_CLOCK(c) (void)0
#define K1_ROUND_END(c) (void)0
#endif

__device__ __forceinline__ bool in_slab(float x, float y, float z,
                                        float4 f) {
  float p = __fadd_rn(__fmul_rn(x, f.x), __fmul_rn(y, f.y));
  p = __fadd_rn(p, __fmul_rn(z, f.z));
  p = __fadd_rn(p, f.w);
  return (p >= 0.0f) && (p <= 1.0f);
}

// warp-wide min / max; NaN lanes drop out (fminf / fmaxf)
__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The block's flags in thread order: how many threads before this one
// have the flag set, and how many in all.  Every thread calls it; the
// caller syncs again before the next call reuses s_warp_n.
__device__ __forceinline__ void block_prefix(bool flag, int* s_warp_n,
                                             int& before, int& added) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t bal = __ballot_sync(kFull, flag);
  if (lane == 0) s_warp_n[warp] = __popc(bal);
  __syncthreads();
  before = __popc(bal & ((1u << lane) - 1u));
  added = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp_n[w];
    before += w < warp ? c : 0;
    added += c;
  }
}

// Bounds of the region a box's frame holds, from its corners c (8 x 3):
// the parallelepiped c0 + t1 e1 + t2 e2 + t3 e3, t in [0, 1]^3, with e1,
// e2, e3 the edges to corners 1, 3 and 4, as geom/boxes.py box_frame takes
// them.  Returns lo (w: the widening) and hi.
//
// The frame's slabs hold exactly that parallelepiped only when the edges
// are orthogonal.  With cosines eta between edges and an aspect ratio r,
// the slabs' region reaches at most about 2 eta r times the summed edge
// lengths beyond it; kSkew widens by 2e-2 of that sum, ten times as much
// when eta r <= kMaxSkew, and a box past kMaxSkew is never culled
// (infinite widening).  The rounding of a projection, a few float32 ulps
// of the coordinates, is covered by kRound times the magnitudes of the box
// and (in count_group) of the points.  NaN or infinite corners give an
// infinite widening: nothing is culled.
__device__ __forceinline__ void box_bounds(const float* c, float4& lo,
                                           float4& hi) {
  float e[3][3];
  float len[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int corner = k == 0 ? 1 : (k == 1 ? 3 : 4);
#pragma unroll
    for (int a = 0; a < 3; ++a) e[k][a] = c[3 * corner + a] - c[a];
    len[k] = sqrtf(e[k][0] * e[k][0] + e[k][1] * e[k][1] +
                   e[k][2] * e[k][2]);
  }
  float cosine = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i + 1; j < 3; ++j) {
      const float dot = e[i][0] * e[j][0] + e[i][1] * e[j][1] +
                        e[i][2] * e[j][2];
      cosine = fmaxf(cosine, fabsf(dot) / (len[i] * len[j]));
    }
  }
  const float longest = fmaxf(len[0], fmaxf(len[1], len[2]));
  const float shortest = fminf(len[0], fminf(len[1], len[2]));
  const float skew = cosine * (longest / shortest);
  float b_lo[3], b_hi[3];
  float mag = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b_lo[a] = c[a] + fminf(e[0][a], 0.f) + fminf(e[1][a], 0.f) +
              fminf(e[2][a], 0.f);
    b_hi[a] = c[a] + fmaxf(e[0][a], 0.f) + fmaxf(e[1][a], 0.f) +
              fmaxf(e[2][a], 0.f);
    mag = fmaxf(mag, fmaxf(fabsf(b_lo[a]), fabsf(b_hi[a])));
  }
  float widen = kRound * mag + kSkew * (len[0] + len[1] + len[2]) + 1e-30f;
  if (!(skew <= kMaxSkew) || !isfinite(widen)) widen = INFINITY;
  lo = make_float4(b_lo[0], b_lo[1], b_lo[2], widen);
  hi = make_float4(b_hi[0], b_hi[1], b_hi[2], 0.f);
}

// 3 bits of v spread to bits 0, 2, 4
__device__ __forceinline__ int spread3(int v) {
  return (v & 1) | ((v & 2) << 1) | ((v & 4) << 2);
}

// src[0, n) -> dst[0, n) ordered by cell of a kGrid x kGrid grid over the
// points' x-y extent, cells in Z order; within a cell in no fixed order.
// Every thread of the block calls it (n <= kThreads).
__device__ void sort_round(const float4* __restrict__ src, int n,
                           float4* __restrict__ dst, int* s_hist,
                           float* s_red) {
  const int tid = threadIdx.x;
#ifdef K1_NO_SORT
  if (tid < n) dst[tid] = src[tid];
  __syncthreads();
  return;
#endif
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float nan = __int_as_float(0x7fffffff);
  const bool has = tid < n;
  const float4 p = has ? src[tid] : make_float4(nan, nan, nan, 0.f);
  const float x0 = warp_min(p.x), x1 = warp_max(p.x);
  const float y0 = warp_min(p.y), y1 = warp_max(p.y);
  if (lane == 0) {
    s_red[4 * warp] = x0;
    s_red[4 * warp + 1] = x1;
    s_red[4 * warp + 2] = y0;
    s_red[4 * warp + 3] = y1;
  }
  if (tid < kGrid * kGrid) s_hist[tid] = 0;
  __syncthreads();
  float bx0 = s_red[0], bx1 = s_red[1], by0 = s_red[2], by1 = s_red[3];
  for (int w = 1; w < kWarps; ++w) {
    bx0 = fminf(bx0, s_red[4 * w]);
    bx1 = fmaxf(bx1, s_red[4 * w + 1]);
    by0 = fminf(by0, s_red[4 * w + 2]);
    by1 = fmaxf(by1, s_red[4 * w + 3]);
  }
  // a NaN or infinite scale puts a point in cell 0 or kGrid - 1: only the
  // order suffers
  const float sx = kGrid / (bx1 - bx0);
  const float sy = kGrid / (by1 - by0);
  const int cx = min(kGrid - 1, max(0, __float2int_rz((p.x - bx0) * sx)));
  const int cy = min(kGrid - 1, max(0, __float2int_rz((p.y - by0) * sy)));
  const int key = spread3(cx) | (spread3(cy) << 1);
  const int rank = has ? atomicAdd(&s_hist[key], 1) : 0;
  __syncthreads();
  if (warp == 0) {                       // exclusive scan of the 64 counts
    const int a = s_hist[2 * lane];
    const int b = s_hist[2 * lane + 1];
    int incl = a + b;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    const int excl = incl - a - b;
    s_hist[2 * lane] = excl;
    s_hist[2 * lane + 1] = excl + a;
  }
  __syncthreads();
  if (has) dst[s_hist[key] + rank] = p;
  __syncthreads();
}

// One warp, one group of up to 32 points (one per lane; a lane without a
// point holds NaN coordinates and word 0), against the block's valid
// boxes.  s_lo / s_hi hold each box's bounds (lo.w its widening, hi.w its
// index as int bits).
__device__ __forceinline__ void count_group(
    const float4* __restrict__ s_box, const float4* __restrict__ s_lo,
    const float4* __restrict__ s_hi, int num_valid,
    uint32_t* __restrict__ s_cnt, int num_boxes, int num_det, float4 pt,
    int lane, int& total, unsigned long long& steps) {
  const uint32_t word = __float_as_uint(pt.w);
  uint32_t plane = 0u;
  for (int d = 0; d < num_det; ++d) {
    const uint32_t v = __ballot_sync(kFull, (word >> d) & 1u);
    if (lane == d) plane = v;
  }
  total += __popc(plane);
  const float gx0 = warp_min(pt.x), gx1 = warp_max(pt.x);
  const float gy0 = warp_min(pt.y), gy1 = warp_max(pt.y);
  const float gz0 = warp_min(pt.z), gz1 = warp_max(pt.z);
  const float mag = fmaxf(fmaxf(fmaxf(fabsf(gx0), fabsf(gx1)),
                                fmaxf(fabsf(gy0), fabsf(gy1))),
                          fmaxf(fabsf(gz0), fabsf(gz1)));
  const float gm = kRound * mag;
  for (int k0 = 0; k0 < num_valid; k0 += 32) {
    const int k = k0 + lane;
    bool cand = false;
    if (k < num_valid) {
      const float4 lo = s_lo[k];
      const float4 hi = s_hi[k];
      const float m = gm + lo.w;
      // a NaN anywhere keeps the box
      cand = !((gx0 > hi.x + m) || (gx1 < lo.x - m) || (gy0 > hi.y + m) ||
               (gy1 < lo.y - m) || (gz0 > hi.z + m) || (gz1 < lo.z - m));
#ifdef K1_NO_CULL
      cand = true;
#endif
    }
    uint32_t cands = __ballot_sync(kFull, cand);
#ifdef K1_NO_SLABS
    total += __popc(cands);
    cands = 0u;
#endif
    while (cands != 0u) {
      ++steps;
      // up to kStep candidates at once, their slab tests independent; an
      // empty slot takes the padding box at num_valid, which holds nothing
      int j[kStep];
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
        j[q] = cands != 0u ? k0 + __ffs(cands) - 1 : num_valid;
        cands &= cands - 1u;
      }
      bool in[kStep];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
        in[q] = in_slab(pt.x, pt.y, pt.z, s_box[3 * j[q]]);
        any |= in[q];
      }
      if (!__any_sync(kFull, any)) continue;
      any = false;
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
        in[q] = in_slab(pt.x, pt.y, pt.z, s_box[3 * j[q] + 1]) & in[q];
        any |= in[q];
      }
      if (!__any_sync(kFull, any)) continue;
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
        in[q] = in_slab(pt.x, pt.y, pt.z, s_box[3 * j[q] + 2]) & in[q];
        const uint32_t m = __ballot_sync(kFull, in[q]);
        if (m != 0u && lane < num_det) {
          const uint32_t c = __popc(m & plane);
          if (c != 0u) {
            const int e = lane * num_boxes + __float_as_int(s_hi[j[q]].w);
            atomicAdd(&s_cnt[e >> 1], c << ((e & 1) * 16));
          }
        }
      }
    }
  }
}

// grid (blocks per frame, B), block kThreads.  Dynamic shared memory:
// box frames (3 (G + 1) float4), box bounds (2 G float4), the point buffer
// (2 kThreads float4), the sorted round (kThreads float4), box indices
// (G int), the count table ((D G + 1) / 2 words).
__global__ void __launch_bounds__(kThreads, 2) inside_counts_kernel(
    const float* __restrict__ points, const int32_t* __restrict__ bits,
    const float4* __restrict__ frame, const float* __restrict__ corners,
    const bool* __restrict__ box_mask, int num_points, int num_boxes,
    int num_det, int32_t* __restrict__ counts,
    int32_t* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  float4* s_lo = s_box + 3 * (num_boxes + 1);
  float4* s_hi = s_lo + num_boxes;
  float4* s_pts = s_hi + num_boxes;
  float4* s_sorted = s_pts + 2 * kThreads;
  int* s_gidx = reinterpret_cast<int*>(s_sorted + kThreads);
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(s_gidx + num_boxes);
  __shared__ int s_warp_n[kWarps];
  __shared__ int s_tot[32];
  __shared__ int s_hist[kGrid * kGrid];
  __shared__ float s_red[4 * kWarps];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the block's steps of kThreads points: blockIdx.x, + gridDim.x, ...
  const int num_steps = (num_points + kThreads - 1) / kThreads;
  const int stride = gridDim.x * kThreads;
  if (static_cast<int>(blockIdx.x) >= num_steps) return;   // before any sync
#ifdef K1_PROFILE
  const unsigned long long t_start = global_ns();
  unsigned long long busy = 0, wait = 0, groups = 0;
#endif

  const uint32_t det_mask =
      num_det >= 32 ? kFull : ((1u << num_det) - 1u);
  const float* f_pts = points + static_cast<size_t>(b) * num_points * 3;
  const int32_t* f_bits = bits + static_cast<size_t>(b) * num_points;
  // the first step's points, loaded before the box table is built
  uint32_t word = 0u;
  float x = 0.f, y = 0.f, z = 0.f;
  if (blockIdx.x * kThreads + tid < num_points) {
    const int p = blockIdx.x * kThreads + tid;
    word = static_cast<uint32_t>(f_bits[p]) & det_mask;
    x = f_pts[3 * p];
    y = f_pts[3 * p + 1];
    z = f_pts[3 * p + 2];
  }

  // the frame's valid boxes, compacted in order
  const bool* f_mask = box_mask + static_cast<size_t>(b) * num_boxes;
  int num_valid = 0;                     // the same in every thread
  for (int g0 = 0; g0 < num_boxes; g0 += kThreads) {
    const int g = g0 + tid;
    const bool ok = g < num_boxes && f_mask[g];
    int before, added;
    block_prefix(ok, s_warp_n, before, added);
    if (ok) s_gidx[num_valid + before] = g;
    num_valid += added;
    __syncthreads();
  }
  const float4* f_frame = frame + static_cast<size_t>(b) * num_boxes * 3;
  // the valid boxes' frames, then one padding box that holds nothing
  for (int i = tid; i < 3 * (num_valid + 1); i += kThreads)
    s_box[i] = i < 3 * num_valid ? f_frame[3 * s_gidx[i / 3] + i % 3]
                                 : make_float4(0.f, 0.f, 0.f, -2.f);
  const float* f_corners =
      corners + static_cast<size_t>(b) * num_boxes * 24;
  for (int k = tid; k < num_valid; k += kThreads) {
    const int g = s_gidx[k];
    float4 lo, hi;
    box_bounds(f_corners + 24 * g, lo, hi);
    hi.w = __int_as_float(g);
    s_lo[k] = lo;
    s_hi[k] = hi;
  }
  const int cnt_words = (num_det * num_boxes + 1) / 2;
  for (int i = tid; i < cnt_words; i += kThreads) s_cnt[i] = 0u;
  if (tid < 32) s_tot[tid] = 0;

  int total = 0;
  unsigned long long steps = 0;   // read by profile builds only
  int n = 0;      // active points in the buffer: the same in every thread
  for (int base = blockIdx.x * kThreads; base < num_points; base += stride) {
    // the next step's points, loaded while this step is counted
    const int q = base + stride + tid;
    uint32_t next_word = 0u;
    float nx = 0.f, ny = 0.f, nz = 0.f;
    if (q < num_points) {
      next_word = static_cast<uint32_t>(f_bits[q]) & det_mask;
      nx = f_pts[3 * q];
      ny = f_pts[3 * q + 1];
      nz = f_pts[3 * q + 2];
    }
    int before, added;
    block_prefix(word != 0u, s_warp_n, before, added);
    if (word != 0u)
      s_pts[n + before] = make_float4(x, y, z, __uint_as_float(word));
    n += added;
    __syncthreads();
    if (n >= kThreads) {
#ifdef K1_LOAD_ONLY
      total += __float_as_uint(s_pts[tid].w) != 0u;
#else
      // sort_round reads s_pts[0, kThreads) and syncs before it returns
      sort_round(s_pts, kThreads, s_sorted, s_hist, s_red);
      K1_CLOCK(c0);
      count_group(s_box, s_lo, s_hi, num_valid, s_cnt, num_boxes, num_det,
                  s_sorted[tid], lane, total, steps);
      K1_ROUND_END(c0);
#endif
      const int rest = n - kThreads;     // < kThreads: no overlap
      if (tid < rest) s_pts[tid] = s_pts[kThreads + tid];
      n = rest;
    }
    word = next_word;
    x = nx;
    y = ny;
    z = nz;
  }
  __syncthreads();
#ifndef K1_LOAD_ONLY
  if (n > 0) {                           // the last, partial round
    sort_round(s_pts, n, s_sorted, s_hist, s_red);
    K1_CLOCK(c0);
    if (warp * 32 < n) {
      const float nan = __int_as_float(0x7fffffff);
      const float4 pt = tid < n ? s_sorted[tid]
                                : make_float4(nan, nan, nan, 0.f);
      count_group(s_box, s_lo, s_hi, num_valid, s_cnt, num_boxes, num_det,
                  pt, lane, total, steps);
    }
    K1_ROUND_END(c0);
  }
#endif
  if (lane < num_det && total != 0) atomicAdd(&s_tot[lane], total);
  __syncthreads();

  int32_t* f_counts = counts + static_cast<size_t>(b) * num_det * num_boxes;
  for (int i = tid; i < cnt_words; i += kThreads) {
    const uint32_t w = s_cnt[i];
    if (w == 0u) continue;
    if (w & 0xffffu)
      atomicAdd(&f_counts[2 * i], static_cast<int>(w & 0xffffu));
    if (w >> 16) atomicAdd(&f_counts[2 * i + 1], static_cast<int>(w >> 16));
  }
  if (tid < num_det && s_tot[tid] != 0)
    atomicAdd(&totals[b * num_det + tid], s_tot[tid]);
#ifdef K1_PROFILE
  unsigned long long* rec =
      g_profile + 4ull * (1 + kWarps) *
                      (static_cast<size_t>(blockIdx.y) * gridDim.x +
                       blockIdx.x);
  if (lane == 0) {
    unsigned long long* w = rec + 4 * (1 + warp);
    w[0] = busy;
    w[1] = wait;
    w[2] = groups;
    w[3] = steps;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    rec[0] = t_start;
    rec[1] = global_ns();
    rec[2] = sm;
  }
#endif
}

// The launch's shared memory and grid: blocks per frame, and the blocks
// one SM holds at once.
cudaError_t launch_shape(int batch, int num_points, int num_boxes,
                         int num_det, int num_sms, size_t* smem,
                         int* per_frame, int* per_sm) {
  *smem = sizeof(float4) * (5 * num_boxes + 3 + 3 * kThreads) +
          sizeof(int) * num_boxes +
          sizeof(uint32_t) * ((num_det * num_boxes + 1) / 2);
  cudaError_t err = cudaFuncSetAttribute(
      inside_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, inside_counts_kernel, kThreads, *smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  // enough blocks for every resident slot of the card, each with at least
  // two steps of points and at most kMaxChunk points
  const long long steps = (num_points + kThreads - 1) / kThreads;
  long long blocks = (static_cast<long long>(*per_sm) * num_sms + batch - 1) /
                     batch;
  if (blocks > (steps + 1) / 2) blocks = (steps + 1) / 2;
  const long long fewest = (steps + kMaxChunk / kThreads - 1) /
                           (kMaxChunk / kThreads);
  if (blocks < fewest) blocks = fewest;
  *per_frame = static_cast<int>(blocks);
  return cudaSuccess;
}

}  // namespace

// points (B, P, 3) f32, bits (B, P) i32, frame (B, G, 12) f32 (per box
// a0 o0 a1 o1 a2 o2), corners (B, G, 8, 3) f32 (those the frame was made
// from), box_mask (B, G) bool; counts (B, D, G) and totals (B, D) i32,
// zeroed by the caller.  Returns cudaGetLastError().
extern "C" int inside_counts_launch(const void* points, const void* bits,
                                    const void* frame, const void* corners,
                                    const void* box_mask, int batch,
                                    int num_points, int num_boxes,
                                    int num_det, void* counts, void* totals,
                                    int num_sms, void* stream) {
  if (batch <= 0 || num_points <= 0 || num_boxes <= 0 || num_det <= 0)
    return 0;
  if (num_det > 32 || batch > 65535) return cudaErrorInvalidValue;
  size_t smem;
  int per_frame, per_sm;
  const cudaError_t err = launch_shape(batch, num_points, num_boxes,
                                       num_det, num_sms, &smem, &per_frame,
                                       &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(per_frame), batch);
  inside_counts_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int32_t*>(bits),
      static_cast<const float4*>(frame), static_cast<const float*>(corners),
      static_cast<const bool*>(box_mask), num_points, num_boxes, num_det,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(totals));
  return static_cast<int>(cudaGetLastError());
}

#ifdef K1_PROFILE
// Where a profile build records (see g_profile): a zeroed device buffer of
// 4 (1 + threads / 32) words per block of the grid.  Returns the CUDA
// error code.
extern "C" int inside_counts_profile_buffer(void* buffer) {
  unsigned long long* p = static_cast<unsigned long long*>(buffer);
  return static_cast<int>(cudaMemcpyToSymbol(g_profile, &p, sizeof(p)));
}

// The grid inside_counts_launch makes for these sizes: blocks per frame,
// the blocks one SM holds at once, and threads per block.
extern "C" int inside_counts_grid(int batch, int num_points, int num_boxes,
                                  int num_det, int num_sms, int* per_frame,
                                  int* per_sm, int* threads) {
  size_t smem;
  *threads = kThreads;
  return static_cast<int>(launch_shape(batch, num_points, num_boxes,
                                       num_det, num_sms, &smem, per_frame,
                                       per_sm));
}
#endif
