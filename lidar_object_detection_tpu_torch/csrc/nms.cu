// Greedy non-maximum suppression (K5) of the YOLO-seg decode, for sm_90a.
//
// Replaces: lidar_object_detection_tpu/ops/pallas_nms.py, pallas_nms
//   (kernel body _nms_kernel) -> nms_kernel.
//
// What it computes, per frame of N candidates (boxes xyxy, scores, valid):
// alive = valid & isfinite(score).  Each of M output slots takes the alive
// candidate of the highest score (ties to the lowest index), writes its
// index and keep = true, and kills every candidate whose IoU with it is
// strictly greater than the threshold, itself included.  A slot with no
// alive candidate writes index 0 and keep = false.  M may exceed N.
// The semantics are those of ops/nms.py (nms_plain), the PyTorch twin.
//
// The IoU follows geom/boxes.py (iou_2d_matrix) operation for operation,
// each rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn),
// so that no fused multiply-add moves a value across the threshold: the
// kernel and its twin agree bit for bit.  min / max propagate NaN, as
// torch.minimum / torch.maximum do.
//
// What bounds it on an H100.  Greedy NMS needs the IoU of each pick with
// the N candidates, not all N^2 pairs: 11 fp32 operations per (pick,
// candidate) pair (2 min, 2 max, 4 add or subtract, 1 multiply, 1 divide,
// 1 compare with the threshold), 3 per box for its area, and N compares
// per argmax step.  At 4 frames x 256 candidates and the full 32 picks
// that is about 0.4 M operations, 0.006 us at 67 TFLOP/s; it moves about
// 23 KB (boxes, scores, valid in; indices and flags out), 0.007 us at
// 3.35 TB/s.  So it is bound by bytes on paper, and in fact by the M
// serial argmax steps, each a block-wide reduction with two barriers, and
// by the launch.  This kernel also computes all N rows of IoUs where only
// the picks' rows are needed.
//
// What the design does about it.  The TPU kernel keeps the (N, N) float32
// IoU matrix in VMEM (256 KiB at N = 256), more than the 227 KB of shared
// memory an H100 block may hold.  Here each IoU is reduced at once to one
// bit: the block keeps an N x ceil(N / 32) suppression bitmask in shared
// memory (8 KiB at N = 256).  One block runs one frame, so the frames of
// a batch run in parallel in one launch.  Thread i owns candidate i: it
// computes row i of the bitmask from the boxes in shared memory (the same
// box j is read by every thread at once, a broadcast), and holds its own
// alive flag and score in registers.  Each of the M steps is a block
// argmax of (score, index) pairs -- warp shuffles, then the warp leaders
// through shared memory, ties to the lower index -- after which every
// thread reads one bit of the winner's row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 1024;
constexpr int kMaxWarps = kMaxN / 32;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// IoU of boxes a and b (xyxy), in the operation order of iou_2d_matrix.
__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float iw = __fsub_rn(nan_min(a[2], b[2]), nan_max(a[0], b[0]));
  const float ih = __fsub_rn(nan_min(a[3], b[3]), nan_max(a[1], b[1]));
  const bool empty = (iw <= 0.0f) || (ih <= 0.0f);
  const float inter = empty ? 0.0f : __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(__fsub_rn(a[2], a[0]), __fsub_rn(a[3], a[1]));
  const float area_b = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// (value, index) a beats (value, index) b: higher value, then lower index.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// grid (B,), block (threads >= N, a multiple of 32).  Dynamic shared
// memory: boxes (N, 4) floats, then the (N, words) suppression bitmask.
__global__ void nms_kernel(const float* __restrict__ boxes,
                           const float* __restrict__ scores,
                           const bool* __restrict__ valid, int n, int m,
                           float thr, int64_t* __restrict__ out_idx,
                           bool* __restrict__ out_keep) {
  extern __shared__ float smem[];
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_idx[kMaxWarps];
  __shared__ int s_best;
  __shared__ bool s_ok;

  const int frame = blockIdx.x;
  const int i = threadIdx.x;
  const int words = (n + 31) / 32;
  float* s_box = smem;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + 4 * n);
  const float* f_boxes = boxes + static_cast<size_t>(frame) * n * 4;

  const float neg = -INFINITY;
  float base = neg;
  bool alive = false;
  if (i < n) {
    for (int k = 0; k < 4; ++k) s_box[4 * i + k] = f_boxes[4 * i + k];
    const float s = scores[static_cast<size_t>(frame) * n + i];
    alive = valid[static_cast<size_t>(frame) * n + i] && isfinite(s);
    base = alive ? s : neg;
  }
  __syncthreads();

  if (i < n) {
    const float* mine = s_box + 4 * i;
    for (int w = 0; w < words; ++w) {
      uint32_t word = 0;
      const int stop = min(32, n - 32 * w);
      for (int b = 0; b < stop; ++b) {
        const int j = 32 * w + b;
        if (iou(mine, s_box + 4 * j) > thr) word |= 1u << b;
      }
      s_bits[i * words + w] = word;
    }
  }
  __syncthreads();

  const int lane = i & 31;
  const int warp = i >> 5;
  const int num_warps = blockDim.x >> 5;
  int64_t* f_idx = out_idx + static_cast<size_t>(frame) * m;
  bool* f_keep = out_keep + static_cast<size_t>(frame) * m;

  for (int slot = 0; slot < m; ++slot) {
    float v = alive ? base : neg;
    int at = i;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, at, off);
      if (beats(ov, oi, v, at)) {
        v = ov;
        at = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = v;
      s_idx[warp] = at;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < num_warps ? s_val[lane] : neg;
      at = lane < num_warps ? s_idx[lane] : kMaxN;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, at, off);
        if (beats(ov, oi, v, at)) {
          v = ov;
          at = oi;
        }
      }
      if (lane == 0) {
        // no alive candidate: every value is -inf and the lowest index,
        // 0, wins, as the twin's argmax does
        const bool ok = v > neg;
        s_best = at;
        s_ok = ok;
        f_idx[slot] = ok ? at : 0;
        f_keep[slot] = ok;
      }
    }
    __syncthreads();
    const int best = s_best;
    if (s_ok && i < n) {
      const bool hit = (s_bits[best * words + (i >> 5)] >> (i & 31)) & 1u;
      if (hit || i == best) alive = false;
    }
  }
}

}  // namespace

extern "C" int nms_launch(const void* boxes, const void* scores,
                          const void* valid, int batch, int n, int m,
                          float thr, void* out_idx, void* out_keep,
                          void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || m < 1) return cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  const int words = (n + 31) / 32;
  const size_t smem = sizeof(float) * 4 * n + sizeof(uint32_t) * n * words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const bool*>(valid), n, m, thr,
      static_cast<int64_t*>(out_idx), static_cast<bool*>(out_keep));
  return cudaGetLastError();
}
