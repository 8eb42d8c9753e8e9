// Inside-count kernel (K1) of the fusion step, for sm_90a.
//
// Replaces: lidar_object_detection_tpu/ops/pallas_count.py,
//   pallas_inside_counts_packed (kernel body _count_kernel).
//
// What it computes.  For every point p with packed membership word bits[p]
// (bit d = the point lies in detection d's mask) and every box g, the point
// is inside g when all three projections (x*a_x + y*a_y) + z*a_z + o lie in
// [0, 1].  counts[d, g] counts the points of detection d inside box g, and
// totals[d] counts detection d's points.  Invalid boxes arrive with zero
// axes and offset -2 and so never hold a point.
//
// What bounds it on an H100.  Each point with a non-zero word is tested
// against all G boxes: about 15 fp32 operations per (point, box) pair, or
// 131072 x 384 x 15 = 0.75 G operations when every point is active.  That
// is some 11 us at the 67 TFLOP/s fp32 peak; the 2 MB of points and words
// take under 1 us at 3.35 TB/s.  So the kernel is bound by operations, and
// by the atomics that add up the hits.
//
// What the design does about it.  The TPU kernel accumulates into one
// output block that a sequential grid revisits.  CUDA blocks run in
// parallel and in no order, so here each block walks its own points in a
// grid-stride loop, keeps the G box frames and a private (D, G) count table
// in shared memory, adds hits with shared-memory atomics, and at the end
// adds its non-zero entries into the zeroed int32 output with global
// atomics.  The counts are integers, so the order of the additions does not
// change the result.  A point whose word is 0 skips the box loop entirely.
// The projection is written with __fmul_rn / __fadd_rn in the order the
// PyTorch twin uses (geom/boxes.py: inside_from_frame), so no fused
// multiply-add changes a boundary test and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void inside_counts_kernel(const float* __restrict__ points,
                                     const int32_t* __restrict__ bits,
                                     const float* __restrict__ frame,
                                     int num_points, int num_boxes,
                                     int num_det, int32_t* __restrict__ counts,
                                     int32_t* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_frame = reinterpret_cast<float*>(smem);                // G * 12
  int32_t* s_counts = reinterpret_cast<int32_t*>(s_frame + num_boxes * 12);
  int32_t* s_totals = s_counts + num_det * num_boxes;             // D

  for (int i = threadIdx.x; i < num_boxes * 12; i += blockDim.x)
    s_frame[i] = frame[i];
  for (int i = threadIdx.x; i < num_det * num_boxes; i += blockDim.x)
    s_counts[i] = 0;
  for (int i = threadIdx.x; i < num_det; i += blockDim.x) s_totals[i] = 0;
  __syncthreads();

  const uint32_t det_mask =
      num_det >= 32 ? 0xffffffffu : ((1u << num_det) - 1u);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < num_points;
       p += gridDim.x * blockDim.x) {
    const uint32_t word = static_cast<uint32_t>(bits[p]) & det_mask;
    if (word == 0u) continue;
    for (uint32_t w = word; w != 0u; w &= w - 1u)
      atomicAdd(&s_totals[__ffs(w) - 1], 1);
    const float x = points[3 * p + 0];
    const float y = points[3 * p + 1];
    const float z = points[3 * p + 2];
    for (int g = 0; g < num_boxes; ++g) {
      const float* f = s_frame + 12 * g;   // a0 (3), o0, a1 (3), o1, a2, o2
      bool inside = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* a = f + 4 * k;
        float proj = __fadd_rn(__fmul_rn(x, a[0]), __fmul_rn(y, a[1]));
        proj = __fadd_rn(proj, __fmul_rn(z, a[2]));
        proj = __fadd_rn(proj, a[3]);
        inside = inside && (proj >= 0.0f) && (proj <= 1.0f);
      }
      if (!inside) continue;
      for (uint32_t w = word; w != 0u; w &= w - 1u)
        atomicAdd(&s_counts[(__ffs(w) - 1) * num_boxes + g], 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < num_det * num_boxes; i += blockDim.x)
    if (s_counts[i] != 0) atomicAdd(&counts[i], s_counts[i]);
  for (int i = threadIdx.x; i < num_det; i += blockDim.x)
    if (s_totals[i] != 0) atomicAdd(&totals[i], s_totals[i]);
}

}  // namespace

// points (P, 3) f32, bits (P,) i32, frame (G, 12) f32; counts (D, G) and
// totals (D,) i32, zeroed by the caller.  Returns cudaGetLastError().
extern "C" int inside_counts_launch(const void* points, const void* bits,
                                    const void* frame, int num_points,
                                    int num_boxes, int num_det, void* counts,
                                    void* totals, int num_sms, void* stream) {
  if (num_points <= 0 || num_boxes <= 0 || num_det <= 0) return 0;
  const size_t smem = sizeof(float) * 12 * num_boxes +
                      sizeof(int32_t) * (num_det * num_boxes + num_det);
  cudaError_t err = cudaFuncSetAttribute(
      inside_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = (num_points + kThreads - 1) / kThreads;
  const int max_blocks = 2 * num_sms;
  if (blocks > max_blocks) blocks = max_blocks;
  inside_counts_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int32_t*>(bits),
      static_cast<const float*>(frame), num_points, num_boxes, num_det,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(totals));
  return static_cast<int>(cudaGetLastError());
}
