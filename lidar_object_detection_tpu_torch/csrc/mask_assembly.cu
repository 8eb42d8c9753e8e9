// Stack-free mask assembly kernels (K2, K3) of the YOLO-seg decode, and the
// relative cut's peak pass, for sm_90a, over a batch of frames: one launch
// each per batch.  The peak pass is described at its own kernel,
// mask_peak_kernel, below.
//
// Replace: lidar_object_detection_tpu/ops/pallas_masks.py,
//   pallas_assemble_masks (:246, kernel body _mask_kernel) -> mask_kernel<kAssemble>
//   pallas_count_above    (:282, kernel body _count_kernel) -> mask_kernel<kCount>
// and, with no Pallas counterpart, the relative-threshold peak of
// lidar_object_detection_tpu/models/yolo/postprocess.py:438-443 (XLA:
// max(where(in_box, field, 0)) per detection over the upsampled field)
//                                                         -> mask_peak_kernel
// pallas_assemble_masks_guarded (:309) is their composition: K3 counts at
// the primary cut, then K2 picks each detection's cut on the device
// (counts >= min_pixels ? threshold : floor, pallas_masks.py:327-329) from
// K3's counts, so a guarded batch is two launches and no host sync.
//
// What they compute.  The input is a cropped proto-resolution probability
// table (B, D, mh, mw).  Each output pixel (y, x) of frame b takes, for
// every detection d, the bilinear value of the exact jax.image.resize taps:
// rows y0, y0+1 with weights wy0, wy1 and columns x0, x0+1 with weights
// wx0, wx1,
//   c(x') = wy0 * t[b, d, y0, x'] + wy1 * t[b, d, y0+1, x']
//   v     = wx0 * c(x0) + wx1 * c(x0+1)
// each product and sum rounded on its own (__fmul_rn / __fadd_rn, in the
// order of the PyTorch twin, so the two agree bit for bit).  The pixel
// belongs to detection d when d is valid, the pixel lies in d's half-open
// box [x1, x2) x [y1, y2), and v > cut[d].  K2 ORs the detections' bits
// into one 32-bit word per pixel; K3 counts, per detection, the pixels
// that pass.
//
// What bounds them on an H100.  The function needs, per valid box, only
// the table rows and columns its pixel range reaches through the taps
// (about 1-3 KB for a car), and 3 fp32 operations per (output row, reached
// column) of the box plus 4 per (pixel, detection) pair inside it
// (chip_smoke.mask_bound).  At the main path's shapes (B = 4, D = 32
// slots, 42 x 160 tables, 376 x 1408 frames, 10 valid boxes) K2 writes
// 8.5 MB of words: 2.5 us at 3.35 TB/s, bound by bytes.  K3 writes 512
// bytes and is bound by its operations, about 0.015 us there and 0.3 us
// on a dense batch (103 of 128 slots valid, boxes up to 600 x 300).  At
// these sizes both are bound in practice by latency and launch (measured
// 9-10 us on the main path, PERF.md).
//
// Why not tensor cores.  The TPU kernel x-interpolates with a dense
// (mw, 128) column-weight matrix because that feeds its matrix unit.  The
// matrix has two nonzeros per column, so a wgmma over it would do about
// mw / 2 = 80 times the work the function needs, and the kernels are bound
// by bytes anyway.
//
// What the design does about it.
// * Tiles.  One block of 128 threads owns a tile of kRows = 2 output rows
//   by 512 columns of one frame: grid (column tiles, row tiles, B), every
//   frame of the batch in one launch.  Two rows per block was the fastest
//   of 1, 2, 4 and 8 on the card (PERF.md, runs C-F).  Each
//   thread owns 4 adjacent columns and keeps their column taps in
//   registers.
// * Any width.  Where W % 4 == 0 (mask_kernel<mode, true>) a quad's taps
//   are three 16-byte loads and its words one 16-byte store.  Otherwise
//   (mask_kernel<mode, false>, chosen per launch) a row of words does not
//   start on a 16-byte boundary and the last quad of a row runs past W:
//   that instantiation loads each tap on its own, the columns past W
//   padded with the taps of column W - 1, and stores each word on its own,
//   none past W.  The pixels past W take part in nothing: every box's
//   columns are clamped to [0, W), so no detection covers them.
// * Culling.  At the start of a tile, warp 0 loads every slot's box,
//   validity and cut at once and runs a ballot over the D <= 32 slots:
//   valid, a non-empty box, and a box whose pixel ranges [ceil x1, ceil x2)
//   x [ceil y1, ceil y2) meet the tile.  Per row a second ballot keeps the
//   detections whose box covers that row, and each thread ANDs it with the
//   detections whose columns meet its 4 pixels, then walks the set bits
//   (__ffs), not all D slots.  For an integer x, x >= x1 iff x >= ceil(x1)
//   and x < x2 iff x < ceil(x2), so the integer ranges are the float tests
//   exactly and culling changes no result.  A tile with no active
//   detection writes zeros (K2) or leaves (K3).
// * Reads.  A pixel reads its detection's two table rows through L1 (the
//   tables of a batch, 3.4 MB, stay in L2).  A quad that reads at most 3
//   table columns (upsampling by 2 or more: 160 -> 1408 is 8.8)
//   y-interpolates them once and picks each pixel's two; no integer
//   divide anywhere.  Measured on the card (chip_smoke.py, PERF.md): the
//   first version, which y-interpolated each row's active columns into
//   shared memory (one warp per detection, a barrier per row) and differed
//   in its setup and K3 loop too, took 1.1-1.4 times as long in K2 and
//   1.7-2.5 times in K3 at B = 4 (each at its best rows per block), so
//   nothing is staged and no cp.async is used; an L1 prefetch of each
//   tile's table rows gained nothing; two detections per step took more
//   registers and 5-20 % more time.
// * Stores.  K2 writes each thread's 4 words as one 16-byte int4 (where
//   W % 4 == 0; else word by word).
// * Counts.  K3 walks the detections that meet a warp's columns uniformly
//   across the warp; lane d keeps the warp's count of detection d (one
//   __reduce_add_sync per step), the warps meet in shared counters, and
//   each block adds one global atomic per detection it counted into the
//   zeroed (B, D) output: integer atomics are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxDet = 32;
constexpr int kRows = 2;                   // output rows a block
constexpr int kThreads = 128;              // one block: 4 warps
constexpr int kTileCols = 4 * kThreads;    // 4 adjacent pixels a thread
constexpr unsigned kFull = 0xffffffffu;
// what mask_kernel computes
constexpr int kAssemble = 0;               // K2: packed words (B, H, W)
constexpr int kCount = 1;                  // K3: pixels over the cut (B, D)

struct Args {
  const float* table;     // (B, D, mh, mw)
  const int32_t* y0;      // (H,) row taps and weights
  const float* wy0;
  const float* wy1;
  const int32_t* x0;      // (W,) column taps and weights
  const float* wx0;
  const float* wx1;
  const float4* boxes;    // (B, D) xyxy
  const uint8_t* valid;   // (B, D)
  const float* thr;       // (B, D) cut, or the primary cut when guarded;
                          // null for the peak pass
  const int32_t* guard;   // (B, D) K3's counts at thr, or null
  float floor;            // the cut of a guarded detection under min_pixels
  int min_pixels;
  int num_det, mh, mw, height, width;
};

// The tile's active detections, set up by warp 0.
struct Tile {
  int x_lo[kMaxDet];      // pixel columns [x_lo, x_hi) of the box
  int x_hi[kMaxDet];
  float cut[kMaxDet];
  uint32_t active;        // the active detections
  uint32_t row_mask[kRows];
  int src0[kRows];        // per tile row: table rows and weights
  int src1[kRows];
  float w0[kRows];
  float w1[kRows];
};

__device__ __forceinline__ int clamp_ceil(float v, int hi) {
  return static_cast<int>(
      fminf(fmaxf(ceilf(v), 0.0f), static_cast<float>(hi)));
}

__device__ void setup_tile(const Args& a, int b, int x_begin, int x_end,
                           int y_begin, int y_end, Tile& t) {
  const int d = threadIdx.x;  // warp 0: one lane per detection slot
  // every load first, so that the setup waits for one round trip
  const size_t i = static_cast<size_t>(b) * a.num_det + d;
  const bool slot = d < a.num_det;
  float4 bx = make_float4(0.f, 0.f, 0.f, 0.f);
  bool valid = false;
  float cut = 0.f;
  int guard = 0;
  if (slot) {
    bx = a.boxes[i];
    valid = a.valid[i] != 0;
    if (a.thr != nullptr) cut = a.thr[i];
    if (a.guard != nullptr) guard = a.guard[i];
  }
  const int y = y_begin + d;
  if (d < kRows && y < y_end) {
    const int s0 = a.y0[y];
    t.src0[d] = s0;
    t.src1[d] = min(s0 + 1, a.mh - 1);
    t.w0[d] = a.wy0[y];
    t.w1[d] = a.wy1[y];
  }
  const int cx0 = clamp_ceil(bx.x, a.width);
  const int cx1 = clamp_ceil(bx.z, a.width);
  const int cy0 = clamp_ceil(bx.y, a.height);
  const int cy1 = clamp_ceil(bx.w, a.height);
  // the float compares are false for a NaN coordinate
  const bool on = slot && valid && bx.x < bx.z && bx.y < bx.w &&
                  max(cx0, x_begin) < min(cx1, x_end) &&
                  max(cy0, y_begin) < min(cy1, y_end);
  if (on) {
    t.x_lo[d] = cx0;
    t.x_hi[d] = cx1;
    t.cut[d] = (a.guard != nullptr && guard < a.min_pixels) ? a.floor : cut;
  }
  const uint32_t active = __ballot_sync(kFull, on);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int yr = y_begin + r;
    const uint32_t m = __ballot_sync(kFull, on && cy0 <= yr && yr < cy1);
    if (d == 0) t.row_mask[r] = m;
  }
  if (d == 0) t.active = active;
}

struct Quad {  // one thread's 4 adjacent pixels of a row
  int x;
  int base;           // first table column the quad reads
  int i0[4], i1[4];   // each pixel's two table columns, from base
  float w0[4], w1[4];
  bool narrow;        // the quad reads at most 3 table columns
};

__device__ __forceinline__ float lerp_rn(float w0, float a, float w1,
                                         float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__device__ __forceinline__ float pick3(int i, float v0, float v1, float v2) {
  return i == 0 ? v0 : (i == 1 ? v1 : v2);
}

// Calls visit(p, in, v) with the value v of pixel p of the quad, in tile
// row r, for detection d (whose box covers row r); in says whether the
// pixel lies in d's columns (the wide path visits only those).  The table
// is read through L1: a detection's two table rows serve every pixel of
// the tile row.  A quad that reads at most 3 table columns (upsampling by
// 2 or more) y-interpolates them once.
template <typename Visit>
__device__ __forceinline__ void quad_visit(const Args& a, const Tile& t,
                                           const Quad& q, int b, int r,
                                           int d, Visit visit) {
  const float* row0 = a.table +
      ((static_cast<size_t>(b) * a.num_det + d) * a.mh + t.src0[r]) * a.mw +
      q.base;
  const float* row1 = row0 + (t.src1[r] - t.src0[r]) * a.mw;
  const float wy0 = t.w0[r];
  const float wy1 = t.w1[r];
  const int lo = t.x_lo[d] - q.x;
  const int hi = t.x_hi[d] - q.x;
  if (q.narrow) {
    const int last = a.mw - 1 - q.base;
    const int k1 = min(1, last);
    const int k2 = min(2, last);
    const float v0 = lerp_rn(wy0, __ldg(row0), wy1, __ldg(row1));
    const float v1 = lerp_rn(wy0, __ldg(row0 + k1), wy1, __ldg(row1 + k1));
    const float v2 = lerp_rn(wy0, __ldg(row0 + k2), wy1, __ldg(row1 + k2));
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float v = lerp_rn(q.w0[p], pick3(q.i0[p], v0, v1, v2),
                              q.w1[p], pick3(q.i1[p], v0, v1, v2));
      visit(p, p >= lo && p < hi, v);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p < lo || p >= hi) continue;
      const float ca = lerp_rn(wy0, __ldg(row0 + q.i0[p]), wy1,
                               __ldg(row1 + q.i0[p]));
      const float cb = lerp_rn(wy0, __ldg(row0 + q.i1[p]), wy1,
                               __ldg(row1 + q.i1[p]));
      visit(p, true, lerp_rn(q.w0[p], ca, q.w1[p], cb));
    }
  }
}

// Bit p set where pixel p of the quad belongs to detection d: inside its
// columns and over its cut.
__device__ __forceinline__ uint32_t quad_bits(const Args& a, const Tile& t,
                                              const Quad& q, int b, int r,
                                              int d) {
  const float cut = t.cut[d];
  uint32_t bits = 0u;
  quad_visit(a, t, q, b, r, d, [&](int p, bool in, float v) {
    bits |= static_cast<uint32_t>(in && v > cut) << p;
  });
  return bits;
}

// The quad's 4 words of tile row r: one int4 where rows are 16-byte
// aligned (W % 4 == 0), else word by word, none past the row's end.
template <bool kAligned>
__device__ __forceinline__ void store_quad(int32_t* row, int width, int x,
                                           const uint32_t (&w)[4]) {
  if (kAligned) {
    *reinterpret_cast<int4*>(row) =
        make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                  static_cast<int>(w[2]), static_cast<int>(w[3]));
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (x + p < width) row[p] = static_cast<int>(w[p]);
  }
}

template <int kMode, bool kAligned>
__global__ void __launch_bounds__(kThreads)
mask_kernel(Args a, int32_t* __restrict__ out) {
  __shared__ Tile t;
  __shared__ int s_cnt[kMaxDet];
  const int x_begin = blockIdx.x * kTileCols;
  const int x_end = min(x_begin + kTileCols, a.width);
  const int y_begin = blockIdx.y * kRows;
  const int y_end = min(y_begin + kRows, a.height);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < 32) {
    setup_tile(a, b, x_begin, x_end, y_begin, y_end, t);
    s_cnt[tid] = 0;
  }
  // the thread's column taps, loaded while warp 0 sets up the tile
  Quad q;
  q.x = x_begin + 4 * tid;
  const bool has_quad = q.x < a.width;
  if (has_quad) {
    int c0[4];
    if (kAligned) {
      const int4 c = *reinterpret_cast<const int4*>(a.x0 + q.x);
      const float4 f0 = *reinterpret_cast<const float4*>(a.wx0 + q.x);
      const float4 f1 = *reinterpret_cast<const float4*>(a.wx1 + q.x);
      c0[0] = c.x; c0[1] = c.y; c0[2] = c.z; c0[3] = c.w;
      q.w0[0] = f0.x; q.w0[1] = f0.y; q.w0[2] = f0.z; q.w0[3] = f0.w;
      q.w1[0] = f1.x; q.w1[1] = f1.y; q.w1[2] = f1.z; q.w1[3] = f1.w;
    } else {
      // columns past W take column W - 1's taps: no box reaches them
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int xc = min(q.x + p, a.width - 1);
        c0[p] = a.x0[xc];
        q.w0[p] = a.wx0[xc];
        q.w1[p] = a.wx1[xc];
      }
    }
    q.base = c0[0];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      q.i0[p] = c0[p] - q.base;
      q.i1[p] = min(c0[p] + 1, a.mw - 1) - q.base;
    }
    q.narrow = q.i1[3] <= 2;
  }
  __syncthreads();
  const uint32_t active = t.active;
  const int rows = y_end - y_begin;
  int32_t* words =
      out + (static_cast<size_t>(b) * a.height + y_begin) * a.width + q.x;
  if (active == 0u) {
    if (kMode == kAssemble && has_quad) {
      const uint32_t zero[4] = {0u, 0u, 0u, 0u};
      for (int r = 0; r < rows; ++r)
        store_quad<kAligned>(words + static_cast<size_t>(r) * a.width,
                             a.width, q.x, zero);
    }
    return;
  }
  // the active detections whose columns meet this thread's 4 pixels
  uint32_t col_mask = 0u;
#pragma unroll
  for (int d = 0; d < kMaxDet; ++d)
    if (((active >> d) & 1u) && t.x_lo[d] < q.x + 4 && t.x_hi[d] > q.x)
      col_mask |= 1u << d;
  if (!has_quad) col_mask = 0u;

  if (kMode == kCount) {
    // lane d keeps its warp's count of detection d; the loop over the
    // detections that meet the warp's columns is uniform across the warp
    const uint32_t warp_cols = __reduce_or_sync(kFull, col_mask);
    int acc = 0;
    for (int r = 0; r < rows; ++r) {
      for (uint32_t rest = t.row_mask[r] & warp_cols; rest != 0u;
           rest &= rest - 1u) {
        const int d = __ffs(rest) - 1;
        const int c = ((col_mask >> d) & 1u)
                          ? __popc(quad_bits(a, t, q, b, r, d)) : 0;
        const int s = __reduce_add_sync(kFull, c);
        if (lane == d) acc += s;
      }
    }
    if (acc != 0) atomicAdd(&s_cnt[lane], acc);
    __syncthreads();
    if (tid < a.num_det && s_cnt[tid] != 0)
      atomicAdd(&out[static_cast<size_t>(b) * a.num_det + tid], s_cnt[tid]);
  } else if (has_quad) {
    for (int r = 0; r < rows; ++r) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (uint32_t rest = t.row_mask[r] & col_mask; rest != 0u;
           rest &= rest - 1u) {
        const int d = __ffs(rest) - 1;
        const uint32_t bits = quad_bits(a, t, q, b, r, d);
#pragma unroll
        for (int p = 0; p < 4; ++p) w[p] |= ((bits >> p) & 1u) << d;
      }
      store_quad<kAligned>(words + static_cast<size_t>(r) * a.width,
                           a.width, q.x, w);
    }
  }
}

// The relative cut's peak pass: per valid detection, the largest v of the
// pixels inside its box (0 when none is; an invalid detection's peak is
// 0, since its cut is never used).  The relative cut is threshold x peak,
// which K2 then applies as per-detection cuts.
//
// What bounds it on an H100: the table entries its boxes reach and the
// taps, and 4 fp32 operations a pixel of a box (chip_smoke.mask_bound).
// At the relative decode's 12 valid boxes that is 1.7e-5 ms, at a dense
// batch (103 of 128 boxes, up to 600 x 300) about 3e-4 ms: below what one
// launch costs, so the pass is bound by its critical path.
//
// The design, redesigned for Hopper (the first version was a mode of K2
// and K3's frame-major kernel: 2,256 blocks for 376 x 1408 frames at B = 4,
// each loading and balloting all 32 slots' boxes, most finding nothing,
// and on dense tables each pixel walked its overlapping detections one
// after another, though the output is per detection):
// * Detection-major.  A work item is one box's band of kPeakRows rows by
//   kPeakCols columns, and one warp takes an item at a time, so only the
//   boxes' pixels are visited.  A box's items are ceil(rows / kPeakRows)
//   x ceil(cols / kPeakCols) of its clamped pixel ranges, 0 for an
//   invalid or empty box.
// * No host sync and no block per possible item.  The grid is a fixed
//   kPeakBlocksPerSm blocks an SM (fewer where the frames are small).
//   Every block computes the prefix of the B x D boxes' item counts
//   itself (one box a thread, a warp scan and one over the warps, in
//   chunks of kPeakThreads boxes: any B x D), and its warps take the
//   chunk's items in a grid-stride loop, an item's box found by a binary
//   search over the prefix in shared memory.
// * Within an item a lane keeps 4 columns' taps in registers, reads each
//   row's table entries for them (through L1: neighbouring columns share
//   them), and takes the max in registers; then __reduce_max_sync and one
//   global atomicMax per item.  The values are probabilities (>= 0), whose
//   float bits order as signed integers, so the max on the int bits into
//   a zeroed (B, D) output is exact in any order; a negative value's bits
//   are a negative integer and lose to the 0 start, as they lose to
//   max(where(in_box, v, 0)).
// * The interpolation is K2's and K3's (the same taps, lerp_rn in the
//   twin's order), so the peaks are the twin's float bits; any width (the
//   taps are read one by one; every box is clamped to [0, W)).
constexpr int kPeakThreads = 256;          // 8 warps
constexpr int kPeakRows = 4;               // an item: 4 rows
constexpr int kPeakCols = 128;             // by 128 columns, 4 a lane
constexpr int kPeakLaneCols = kPeakCols / 32;
constexpr int kPeakBlocksPerSm = 2;

__device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__global__ void __launch_bounds__(kPeakThreads)
mask_peak_kernel(Args a, int boxes, int32_t* __restrict__ out) {
  __shared__ int s_first[kPeakThreads];   // each box's first item
  __shared__ int4 s_box[kPeakThreads];    // its pixels [x, y) x [z, w)
  __shared__ int s_warp[kPeakThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = gridDim.x * (kPeakThreads / 32);
  const int first_item = blockIdx.x * (kPeakThreads / 32) + warp;
  for (int c0 = 0; c0 < boxes; c0 += kPeakThreads) {
    // this chunk's boxes and their items
    const int i = c0 + tid;
    int4 r = make_int4(0, 0, 0, 0);
    int items = 0;
    if (i < boxes) {
      const float4 bx = a.boxes[i];
      r = make_int4(clamp_ceil(bx.x, a.width), clamp_ceil(bx.z, a.width),
                    clamp_ceil(bx.y, a.height), clamp_ceil(bx.w, a.height));
      // the float compares are false for a NaN coordinate
      if (a.valid[i] != 0 && bx.x < bx.z && bx.y < bx.w && r.x < r.y &&
          r.z < r.w)
        items = ceil_div(r.y - r.x, kPeakCols) * ceil_div(r.w - r.z,
                                                          kPeakRows);
    }
    int incl = items;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    s_box[tid] = r;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kPeakThreads / 32; ++w) {
      const int c = s_warp[w];
      total += c;
      before += w < warp ? c : 0;
    }
    s_first[tid] = before + incl - items;
    __syncthreads();
    const int n_box = min(kPeakThreads, boxes - c0);
    for (int item = first_item; item < total; item += warps) {
      // the item's box: the last whose first item is <= item (a box of
      // no items shares its first item with the next)
      int lo = 0, hi = n_box;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_first[mid] <= item) lo = mid; else hi = mid;
      }
      const int4 bp = s_box[lo];
      const int tiles = ceil_div(bp.y - bp.x, kPeakCols);
      const int local = item - s_first[lo];
      const int band = local / tiles;
      const int x_begin = bp.x + (local - band * tiles) * kPeakCols;
      const int x_end = min(x_begin + kPeakCols, bp.y);
      const int y_begin = bp.z + band * kPeakRows;
      const int y_end = min(y_begin + kPeakRows, bp.w);
      const size_t box = static_cast<size_t>(c0) + lo;   // b * D + d
      const float* table = a.table + box * a.mh * a.mw;
      // the lane's columns: their taps (past the item's end, its first)
      bool in[kPeakLaneCols];
      int ca[kPeakLaneCols], cb[kPeakLaneCols];
      float u0[kPeakLaneCols], u1[kPeakLaneCols];
#pragma unroll
      for (int q = 0; q < kPeakLaneCols; ++q) {
        const int x = x_begin + lane + 32 * q;
        in[q] = x < x_end;
        const int xc = in[q] ? x : x_begin;
        ca[q] = a.x0[xc];
        cb[q] = min(ca[q] + 1, a.mw - 1);
        u0[q] = a.wx0[xc];
        u1[q] = a.wx1[xc];
      }
      int peak = 0;
#pragma unroll
      for (int dy = 0; dy < kPeakRows; ++dy) {
        const int y = y_begin + dy;
        if (y >= y_end) break;
        const int s0 = a.y0[y];
        const float* row0 = table + static_cast<size_t>(s0) * a.mw;
        const float* row1 =
            table + static_cast<size_t>(min(s0 + 1, a.mh - 1)) * a.mw;
        const float w0 = a.wy0[y], w1 = a.wy1[y];
#pragma unroll
        for (int q = 0; q < kPeakLaneCols; ++q) {
          const float va = lerp_rn(w0, __ldg(row0 + ca[q]), w1,
                                   __ldg(row1 + ca[q]));
          const float vb = lerp_rn(w0, __ldg(row0 + cb[q]), w1,
                                   __ldg(row1 + cb[q]));
          const float v = lerp_rn(u0[q], va, u1[q], vb);
          peak = in[q] ? max(peak, __float_as_int(v)) : peak;
        }
      }
      peak = __reduce_max_sync(kFull, peak);
      if (lane == 0 && peak > 0) atomicMax(out + box, peak);
    }
    __syncthreads();   // the next chunk writes the prefix again
  }
}

template <bool kAligned>
void launch_mode(int mode, dim3 grid, cudaStream_t s, const Args& a,
                 int32_t* o) {
  if (mode == kCount)
    mask_kernel<kCount, kAligned><<<grid, kThreads, 0, s>>>(a, o);
  else
    mask_kernel<kAssemble, kAligned><<<grid, kThreads, 0, s>>>(a, o);
}

int launch(int mode, Args a, int batch, void* out, void* stream) {
  if (batch <= 0 || a.height <= 0 || a.width <= 0) return 0;
  if (a.num_det < 0 || a.num_det > kMaxDet || a.mh < 1 || a.mw < 1 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.width + kTileCols - 1) / kTileCols,
                  (a.height + kRows - 1) / kRows, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  if (a.width % 4 == 0)
    launch_mode<true>(mode, grid, s, a, o);
  else
    launch_mode<false>(mode, grid, s, a, o);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* table, int num_det, int mh, int mw,
               const void* y0, const void* wy0, const void* wy1,
               const void* x0, const void* wx0, const void* wx1,
               const void* boxes, const void* valid, const void* thr,
               int height, int width) {
  Args a{};
  a.table = static_cast<const float*>(table);
  a.y0 = static_cast<const int32_t*>(y0);
  a.wy0 = static_cast<const float*>(wy0);
  a.wy1 = static_cast<const float*>(wy1);
  a.x0 = static_cast<const int32_t*>(x0);
  a.wx0 = static_cast<const float*>(wx0);
  a.wx1 = static_cast<const float*>(wx1);
  a.boxes = static_cast<const float4*>(boxes);
  a.valid = static_cast<const uint8_t*>(valid);
  a.thr = static_cast<const float*>(thr);
  a.num_det = num_det;
  a.mh = mh;
  a.mw = mw;
  a.height = height;
  a.width = width;
  return a;
}

}  // namespace

// table (B, D, mh, mw) f32; row taps y0 (H,) i32, wy0, wy1 (H,) f32; column
// taps x0 (W,) i32, wx0, wx1 (W,) f32; boxes (B, D, 4) f32; valid (B, D)
// bool; thr (B, D) f32.  K3 adds per-detection pixel counts into counts (B, D) i32, zeroed by the caller.
// Returns cudaGetLastError().
extern "C" int mask_count_launch(const void* table, int batch, int num_det,
                                 int mh, int mw, const void* y0,
                                 const void* wy0, const void* wy1,
                                 const void* x0, const void* wx0,
                                 const void* wx1, const void* boxes,
                                 const void* valid, const void* thr,
                                 int height, int width, void* counts,
                                 void* stream) {
  Args a = make_args(table, num_det, mh, mw, y0, wy0, wy1, x0, wx0, wx1,
                     boxes, valid, thr, height, width);
  return launch(kCount, a, batch, counts, stream);
}

// Same operands without the cuts; max-es into peaks (B, D) i32, zeroed by
// the caller, the float bits of each valid detection's largest in-box
// value.  One launch of mask_peak_kernel.
extern "C" int mask_peak_launch(const void* table, int batch, int num_det,
                                int mh, int mw, const void* y0,
                                const void* wy0, const void* wy1,
                                const void* x0, const void* wx0,
                                const void* wx1, const void* boxes,
                                const void* valid, int height, int width,
                                void* peaks, void* stream) {
  if (batch <= 0 || num_det == 0 || height <= 0 || width <= 0) return 0;
  if (num_det < 0 || num_det > kMaxDet || mh < 1 || mw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(table, num_det, mh, mw, y0, wy0, wy1, x0, wx0, wx1,
                     boxes, valid, nullptr, height, width);
  const long long n_boxes = static_cast<long long>(batch) * num_det;
  if (n_boxes > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // every box covering the frame: an upper bound of the items
  const long long most = n_boxes * ((height + kPeakRows - 1) / kPeakRows) *
                         ((width + kPeakCols - 1) / kPeakCols);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long warps = kPeakThreads / 32;
  const int blocks = static_cast<int>(
      std::min<long long>(static_cast<long long>(kPeakBlocksPerSm) * sms,
                          (most + warps - 1) / warps));
  mask_peak_kernel<<<blocks, kPeakThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int>(n_boxes), static_cast<int32_t*>(peaks));
  return static_cast<int>(cudaGetLastError());
}

// Same operands; K2 writes out (B, H, W) i32 packed words.  With guard
// (B, D) i32 (K3's counts at thr) non-null, detection d of frame b cuts at
// thr where guard >= min_pixels and at floor otherwise; with guard null,
// at thr.
extern "C" int mask_assemble_launch(const void* table, int batch,
                                    int num_det, int mh, int mw,
                                    const void* y0, const void* wy0,
                                    const void* wy1, const void* x0,
                                    const void* wx0, const void* wx1,
                                    const void* boxes, const void* valid,
                                    const void* thr, const void* guard,
                                    float floor, int min_pixels, int height,
                                    int width, void* out, void* stream) {
  Args a = make_args(table, num_det, mh, mw, y0, wy0, wy1, x0, wx0, wx1,
                     boxes, valid, thr, height, width);
  a.guard = static_cast<const int32_t*>(guard);
  a.floor = floor;
  a.min_pixels = min_pixels;
  return launch(kAssemble, a, batch, out, stream);
}
