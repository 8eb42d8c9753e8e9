// Stack-free mask assembly kernels (K2, K3) of the YOLO-seg decode, for
// sm_90a.
//
// Replace: lidar_object_detection_tpu/ops/pallas_masks.py,
//   pallas_assemble_masks (kernel body _mask_kernel) -> mask_assemble_kernel
//   pallas_count_above    (kernel body _count_kernel) -> mask_count_kernel
// pallas_assemble_masks_guarded is their composition (count, per-detection
// cut, assemble) and stays two launches here too (ops/mask_assembly.py).
//
// What they compute.  The input is a cropped proto-resolution probability
// table (D, mh, mw).  Each output pixel (y, x) takes, for every detection
// d, the bilinear value of the exact jax.image.resize taps: rows y0, y0+1
// with weights wy0, wy1 and columns x0, x0+1 with weights wx0, wx1,
//   c(x') = wy0 * t[d, y0, x'] + wy1 * t[d, y0+1, x']
//   v     = wx0 * c(x0) + wx1 * c(x0+1)
// each product and sum rounded on its own (__fmul_rn / __fadd_rn, in the
// order of the PyTorch twin, so the two agree bit for bit).  The pixel
// belongs to detection d when v > thr[d] and the pixel lies in d's
// half-open box [x1, x2) x [y1, y2) (an invalid detection arrives with an
// empty box).  K2 ORs the detections' bits into one 32-bit word per pixel;
// K3 counts, per detection, the pixels that pass.
//
// What bounds them on an H100.  Per frame they read a 0.86 MB table and
// K2 writes a 2.1 MB word image (376 x 1408 x 4 B): about 1 us of memory
// traffic at 3.35 TB/s.  The arithmetic is about 7 fp32 operations for
// each (pixel, detection) pair inside a box, at most 32 x 529k pairs, or
// some 2 us at 67 TFLOP/s.  Both are small; at these sizes the launch and
// the tail of the grid matter as much.
//
// What the design does about it.  The TPU kernel x-interpolates with a
// dense (mw, 128) weight matrix to feed its matrix unit, and K3 sums into
// one output block across a sequential grid.  Here one block owns one
// output row: it y-interpolates the two table rows of every detection once
// into shared memory (D x mw floats), and then each thread reads the two
// column taps of its pixels directly.  A detection whose box does not hold
// the pixel is skipped before any arithmetic.  K3 keeps per-thread counts
// in registers, reduces them across the warp, and adds each block's sums
// into the zeroed int32 output with atomics (exact in any order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDet = 32;

struct Taps {
  const float* table;  // (D, mh, mw)
  const int32_t* y0;   // (H,)
  const float* wy0;
  const float* wy1;
  const int32_t* x0;   // (W,)
  const float* wx0;
  const float* wx1;
  const float* boxes;  // (D, 4) xyxy, invalid -> empty
  const float* thr;    // (D,)
  int num_det, mh, mw, height, width;
};

// Loads the block's row of y-interpolated table values and the boxes.
__device__ void load_row(const Taps& t, int y, float* s_comb, float* s_box,
                         float* s_thr) {
  const int r0 = t.y0[y];
  const int r1 = min(r0 + 1, t.mh - 1);
  const float w0 = t.wy0[y];
  const float w1 = t.wy1[y];
  for (int i = threadIdx.x; i < t.num_det * t.mw; i += blockDim.x) {
    const int d = i / t.mw;
    const int j = i - d * t.mw;
    const float* base = t.table + static_cast<size_t>(d) * t.mh * t.mw;
    s_comb[i] = __fadd_rn(__fmul_rn(w0, base[r0 * t.mw + j]),
                          __fmul_rn(w1, base[r1 * t.mw + j]));
  }
  for (int i = threadIdx.x; i < t.num_det * 4; i += blockDim.x)
    s_box[i] = t.boxes[i];
  for (int i = threadIdx.x; i < t.num_det; i += blockDim.x)
    s_thr[i] = t.thr[i];
  __syncthreads();
}

__device__ __forceinline__ bool pixel_on(const Taps& t, const float* s_comb,
                                         const float* s_box,
                                         const float* s_thr, int d, float xf,
                                         float yf, int c0, int c1, float w0,
                                         float w1) {
  const float* b = s_box + 4 * d;
  if (!(xf >= b[0] && xf < b[2] && yf >= b[1] && yf < b[3])) return false;
  const float* row = s_comb + d * t.mw;
  const float v = __fadd_rn(__fmul_rn(w0, row[c0]), __fmul_rn(w1, row[c1]));
  return v > s_thr[d];
}

__global__ void mask_assemble_kernel(Taps t, int32_t* __restrict__ out) {
  // D * mw y-interpolated values, then the boxes and the thresholds
  extern __shared__ __align__(16) float s_comb[];
  float* s_box = s_comb + t.num_det * t.mw;
  float* s_thr = s_box + 4 * t.num_det;
  const int y = blockIdx.x;
  load_row(t, y, s_comb, s_box, s_thr);
  const float yf = static_cast<float>(y);
  for (int x = threadIdx.x; x < t.width; x += blockDim.x) {
    const int c0 = t.x0[x];
    const int c1 = min(c0 + 1, t.mw - 1);
    const float w0 = t.wx0[x];
    const float w1 = t.wx1[x];
    const float xf = static_cast<float>(x);
    uint32_t word = 0u;
    for (int d = 0; d < t.num_det; ++d)
      if (pixel_on(t, s_comb, s_box, s_thr, d, xf, yf, c0, c1, w0, w1))
        word |= 1u << d;
    out[static_cast<size_t>(y) * t.width + x] = static_cast<int32_t>(word);
  }
}

__global__ void mask_count_kernel(Taps t, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) float s_comb[];
  float* s_box = s_comb + t.num_det * t.mw;
  float* s_thr = s_box + 4 * t.num_det;
  const int y = blockIdx.x;
  load_row(t, y, s_comb, s_box, s_thr);
  const float yf = static_cast<float>(y);
  int cnt[kMaxDet];
#pragma unroll
  for (int d = 0; d < kMaxDet; ++d) cnt[d] = 0;
  for (int x = threadIdx.x; x < t.width; x += blockDim.x) {
    const int c0 = t.x0[x];
    const int c1 = min(c0 + 1, t.mw - 1);
    const float w0 = t.wx0[x];
    const float w1 = t.wx1[x];
    const float xf = static_cast<float>(x);
#pragma unroll
    for (int d = 0; d < kMaxDet; ++d)
      if (d < t.num_det &&
          pixel_on(t, s_comb, s_box, s_thr, d, xf, yf, c0, c1, w0, w1))
        ++cnt[d];
  }
  // all lanes are converged here: reduce each count across the warp and
  // let lane 0 add the warp's sums
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 0; d < kMaxDet; ++d) {
    if (d >= t.num_det) break;
    const int s = __reduce_add_sync(0xffffffffu, cnt[d]);
    if (lane == 0 && s != 0) atomicAdd(&counts[d], s);
  }
}

int launch(bool count, const void* table, int num_det, int mh, int mw,
           const void* y0, const void* wy0, const void* wy1, const void* x0,
           const void* wx0, const void* wx1, const void* boxes,
           const void* thr, int height, int width, void* out,
           void* stream) {
  if (num_det <= 0 || height <= 0 || width <= 0) return 0;
  if (num_det > kMaxDet) return static_cast<int>(cudaErrorInvalidValue);
  Taps t{static_cast<const float*>(table), static_cast<const int32_t*>(y0),
         static_cast<const float*>(wy0),   static_cast<const float*>(wy1),
         static_cast<const int32_t*>(x0),  static_cast<const float*>(wx0),
         static_cast<const float*>(wx1),   static_cast<const float*>(boxes),
         static_cast<const float*>(thr),   num_det, mh, mw, height, width};
  const size_t smem = sizeof(float) * (num_det * mw + 5 * num_det);
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count) {
    err = cudaFuncSetAttribute(mask_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mask_count_kernel<<<height, kThreads, smem, s>>>(
        t, static_cast<int32_t*>(out));
  } else {
    err = cudaFuncSetAttribute(mask_assemble_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mask_assemble_kernel<<<height, kThreads, smem, s>>>(
        t, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (D, mh, mw) f32; row taps y0 (H,) i32, wy0, wy1 (H,) f32; column
// taps x0 (W,) i32, wx0, wx1 (W,) f32; boxes (D, 4) f32; thr (D,) f32.
// K2 writes out (H, W) i32 packed words.  Returns cudaGetLastError().
extern "C" int mask_assemble_launch(const void* table, int num_det, int mh,
                                    int mw, const void* y0, const void* wy0,
                                    const void* wy1, const void* x0,
                                    const void* wx0, const void* wx1,
                                    const void* boxes, const void* thr,
                                    int height, int width, void* out,
                                    void* stream) {
  return launch(false, table, num_det, mh, mw, y0, wy0, wy1, x0, wx0, wx1,
                boxes, thr, height, width, out, stream);
}

// Same operands; K3 adds per-detection pixel counts into counts (D,) i32,
// zeroed by the caller.
extern "C" int mask_count_launch(const void* table, int num_det, int mh,
                                 int mw, const void* y0, const void* wy0,
                                 const void* wy1, const void* x0,
                                 const void* wx0, const void* wx1,
                                 const void* boxes, const void* thr,
                                 int height, int width, void* counts,
                                 void* stream) {
  return launch(true, table, num_det, mh, mw, y0, wy0, wy1, x0, wx0, wx1,
                boxes, thr, height, width, counts, stream);
}
