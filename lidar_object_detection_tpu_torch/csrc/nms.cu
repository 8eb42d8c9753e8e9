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
// kernel and its twin agree bit for bit.  It is iou(box[pick], box[j]),
// the row of the pick that the twin reads.  min / max propagate NaN, as
// torch.minimum / torch.maximum do.  The threshold arrives as the float32
// the twin compares with.
//
// What bounds it on an H100.  Greedy NMS needs the IoU of each pick with
// the N candidates, not all N^2 pairs: 11 fp32 operations per (pick,
// candidate) pair (2 min, 2 max, 4 add or subtract, 1 multiply, 1 divide,
// 1 compare with the threshold), 3 per box for its area, and N compares
// per argmax step.  The decode's frames pick 0 to 6 boxes of 256, so the
// bound is set by the bytes (about 21 bytes per candidate): some 45 KB,
// 0.01 us at 3.35 TB/s, for the 8 frames of a TTA batch.  In practice it
// is the latency of the few serial argmax steps and the launch.
//
// What the design does about it.
// * One warp per frame, one block per frame: the frames of a batch (both
//   TTA views, 2B frames) run in parallel in one launch.  Lane l owns the
//   candidates l, l + 32, l + 64, ...: their scores in registers and their
//   alive flags as the bits of one register.  The kernel is compiled for
//   8, 16 and 32 candidates per lane and launched with the fewest that
//   hold N, since every scan of a step unrolls over them.  The boxes of
//   the frame sit in shared memory, 16 bytes each, read as float4.
// * An argmax step is warp shuffles only: each lane scans its own alive
//   candidates (ascending index, strict >, so ties keep the lower index),
//   then five butterfly rounds of (score, index) pairs give every lane the
//   winner, ties to the lower index.  No block barrier.
// * Lazy rows: after a pick, each lane computes the IoU of the pick with
//   its alive candidates only, skipping the division where the boxes do
//   not overlap.  That is at most picks x N IoUs per frame, not N^2.
// * An early exit: once no candidate of the frame is alive, the warp
//   writes the remaining slots as (0, false) at once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// iou(a, b) > thr for boxes a and b (xyxy), a's area given, in the
// operation order of iou_2d_matrix.  The division is skipped where the
// boxes do not overlap: the IoU is then 0, as the twin computes it.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b,
                                          float thr) {
  const float iw = __fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x));
  const float ih = __fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y));
  float v = 0.0f;
  if (!((iw <= 0.0f) || (ih <= 0.0f))) {
    const float inter = __fmul_rn(iw, ih);
    const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    if (uni > 0.0f) v = __fdiv_rn(inter, uni);
  }
  return v > thr;
}

// (value, index) a beats (value, index) b: higher value, then lower index.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// grid (B,), block 32 (one warp), N <= 32 kPerLane.  Dynamic shared
// memory: the frame's boxes, (N,) float4.
template <int kPerLane>
__global__ void __launch_bounds__(32) nms_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    const bool* __restrict__ valid, int n, int m, float thr,
    int64_t* __restrict__ out_idx, bool* __restrict__ out_keep) {
  extern __shared__ float4 s_box[];
  const int frame = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(frame) * n;
  for (int j = lane; j < n; j += 32) s_box[j] = boxes[base + j];

  float sc[kPerLane];
  uint32_t alive = 0u;          // bit k: candidate 32 k + lane is alive
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = 32 * k + lane;
    sc[k] = -INFINITY;
    if (j < n) {
      const float s = scores[base + j];
      if (valid[base + j] && isfinite(s)) {
        sc[k] = s;
        alive |= 1u << k;
      }
    }
  }
  __syncwarp();

  int64_t* f_idx = out_idx + static_cast<size_t>(frame) * m;
  bool* f_keep = out_keep + static_cast<size_t>(frame) * m;
  int slot = 0;
  for (; slot < m; ++slot) {
    if (__ballot_sync(kFull, alive != 0u) == 0u) break;
    float bv = -INFINITY;
    int bi = 32 * kPerLane;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (((alive >> k) & 1u) && sc[k] > bv) {
        bv = sc[k];
        bi = 32 * k + lane;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int pick = bi;        // the same in every lane
    if (lane == 0) {
      f_idx[slot] = pick;
      f_keep[slot] = true;
    }
    const float4 a = s_box[pick];
    const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (((alive >> k) & 1u) && iou_above(a, area_a, s_box[32 * k + lane],
                                           thr))
        alive &= ~(1u << k);
    }
    if (lane == (pick & 31)) alive &= ~(1u << (pick >> 5));
  }
  for (int s = slot + lane; s < m; s += 32) {
    f_idx[s] = 0;
    f_keep[s] = false;
  }
}

}  // namespace

// boxes (B, N, 4) f32, 16-byte aligned; scores (B, N) f32; valid (B, N)
// bool; out_idx (B, M) i64 and out_keep (B, M) bool.  Returns
// cudaGetLastError().
extern "C" int nms_launch(const void* boxes, const void* scores,
                          const void* valid, int batch, int n, int m,
                          float thr, void* out_idx, void* out_keep,
                          void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || m < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const size_t smem = sizeof(float4) * n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* b4 = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  const bool* va = static_cast<const bool*>(valid);
  int64_t* idx = static_cast<int64_t*>(out_idx);
  bool* keep = static_cast<bool*>(out_keep);
  // as few candidates per lane as N allows: the scans of a step unroll
  // over them
  if (n <= 256)
    nms_kernel<8><<<batch, 32, smem, st>>>(b4, sc, va, n, m, thr, idx, keep);
  else if (n <= 512)
    nms_kernel<16><<<batch, 32, smem, st>>>(b4, sc, va, n, m, thr, idx,
                                            keep);
  else
    nms_kernel<32><<<batch, 32, smem, st>>>(b4, sc, va, n, m, thr, idx,
                                            keep);
  return cudaGetLastError();
}
