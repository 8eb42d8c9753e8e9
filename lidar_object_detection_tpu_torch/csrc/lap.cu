// Exact min-cost assignment (V5's Hungarian matching) for sm_90a.
//
// Replaces: lidar_object_detection_tpu/ops/lap.py, lap (lines 36-120) ->
//   lap_kernel.  That function is not a Pallas kernel: it is a fixed-trip
//   lax.scan nest that XLA compiles into one loop on the device.  Written
//   op by op in PyTorch it would launch some ten small kernels for each of
//   its R * 2R steps (10^4 launches per batch at 32 x 384), so the whole
//   solve is this one kernel.  ops/lap.py (lap_plain) is its twin.
//
// What it computes, per frame: the (R, C) float32 costs, R <= C, with
// PAD_COST = 1e6 written into every masked row and column, are solved by
// shortest augmenting paths, one Dijkstra phase per row:
//   cand  = ((min_val + cost[i][j]) - u[i]) - v[j]      (unscanned j)
//   spc[j], path[j] = cand, i   where cand < spc[j]
//   j*    = argmin over j of (scanned ? inf : spc[j]), ties to the lowest j
//   the phase ends at the first unassigned j*, else i = row4col[j*];
// then u[cur] += min_val, u[r] = (u[r] + min_val) - spc[col4row[r]] for
// the other rows the phase reached, v[j] = v[j] - (min_val - spc[j]) for
// the scanned columns, and the augmentation along path.  Output: col4row,
// (R,) int32.  The order of every float32 operation is JAX's, each
// rounded on its own (__fadd_rn / __fsub_rn); there are no products, so
// no fused multiply-add could arise anyway.  Ties go to the lowest index,
// as jnp.argmin breaks them: padded rows, whose costs all tie, are solved
// as JAX and the twin solve them.  Costs are finite (PAD_COST at most).
//
// JAX bounds every loop statically (R Dijkstra steps and R augmentation
// steps per phase, each frozen once done).  Here loops are dynamic: a
// phase stops at its first unassigned column, which is where the fixed
// form freezes, so the pops, duals and result are the same.
//
// What bounds it on an H100.  The work is tiny: the cost once (B x R x C
// x 4 bytes, 48 KB a frame at 32 x 384), the masks, col4row; about 6
// operations per column for each scanned column (a candidate of three
// adds, a compare, a select and the argmin compare), some 10^6 a frame.
// Its bound is well under a microsecond.  What it takes is the dependent
// chain: each Dijkstra step needs the argmin of the step before, so a
// frame makes its scanned columns (up to R (R + 3) / 2 = 560 at R = 32)
// one after another, each a block-wide reduction.
//
// What the design does about it.
// * One thread block per frame, all frames of a batch in one launch, so
//   frames run side by side on the SMs and a batch costs one frame's
//   chain.
// * The masked cost, u, v, spc, path, the scanned flags, row4col and
//   col4row live in shared memory (about 56 KB at 32 x 384): no step
//   touches device memory.
// * Columns are spread over the block's threads (j = tid, tid + T, ...);
//   a thread updates only its own columns' spc, path and scanned flag, so
//   a Dijkstra step needs one barrier: the argmin is a warp-shuffle
//   reduction, then each warp's winner goes to a double-buffered slot and
//   every thread reduces the warps' winners itself, in warp order, so
//   that all threads hold the same j* and min_val without a second
//   barrier.
// * The duals are updated in parallel; the augmentation (at most k + 1
//   edges in phase k) is one thread's walk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPadCost = 1.0e6f;
constexpr size_t kMaxSmem = 232448;   // what one H100 block can use

// (value, index) a beats b: the lower value, then the lower index.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// grid (B,), block kThreads.  Dynamic shared memory: see lap_smem_bytes.
__global__ void __launch_bounds__(kThreads) lap_kernel(
    const float* __restrict__ cost, const bool* __restrict__ row_mask,
    const bool* __restrict__ col_mask, int r, int c,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[2][kWarps];
  __shared__ int red_j[2][kWarps];

  const int frame = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  size_t off = 0;
  float* s_cost = reinterpret_cast<float*>(smem + off);
  off = align16(off + sizeof(float) * r * c);
  float* s_v = reinterpret_cast<float*>(smem + off);
  off = align16(off + sizeof(float) * c);
  float* s_spc = reinterpret_cast<float*>(smem + off);
  off = align16(off + sizeof(float) * c);
  int* s_path = reinterpret_cast<int*>(smem + off);
  off = align16(off + sizeof(int) * c);
  int* s_row4col = reinterpret_cast<int*>(smem + off);
  off = align16(off + sizeof(int) * c);
  float* s_u = reinterpret_cast<float*>(smem + off);
  off = align16(off + sizeof(float) * r);
  int* s_col4row = reinterpret_cast<int*>(smem + off);
  off = align16(off + sizeof(int) * r);
  unsigned char* s_sc = smem + off;
  off = align16(off + c);
  unsigned char* s_sr = smem + off;

  // the masked cost, PAD_COST in masked rows and columns
  const float* f_cost = cost + static_cast<size_t>(frame) * r * c;
  const bool* f_rows = row_mask + static_cast<size_t>(frame) * r;
  const bool* f_cols = col_mask + static_cast<size_t>(frame) * c;
  for (int idx = tid; idx < r * c; idx += kThreads) {
    const int row = idx / c;
    const int col = idx - row * c;
    s_cost[idx] = (f_rows[row] && f_cols[col]) ? f_cost[idx] : kPadCost;
  }
  for (int j = tid; j < c; j += kThreads) {
    s_v[j] = 0.0f;
    s_row4col[j] = -1;
  }
  for (int row = tid; row < r; row += kThreads) {
    s_u[row] = 0.0f;
    s_col4row[row] = -1;
  }

  int parity = 0;
  for (int cur = 0; cur < r; ++cur) {
    for (int j = tid; j < c; j += kThreads) {
      s_spc[j] = INFINITY;
      s_path[j] = -1;
      s_sc[j] = 0;
    }
    for (int row = tid; row < r; row += kThreads) s_sr[row] = 0;
    __syncthreads();

    // Dijkstra over the columns from row cur; every thread holds the same
    // i and min_val
    int i = cur;
    float min_val = 0.0f;
    int sink = -1;
    for (;;) {
      if (tid == 0) s_sr[i] = 1;
      const float* crow = s_cost + static_cast<size_t>(i) * c;
      const float ui = s_u[i];
      float bv = INFINITY;
      int bj = c;
      for (int j = tid; j < c; j += kThreads) {
        float m = INFINITY;
        if (!s_sc[j]) {
          const float cand =
              __fsub_rn(__fsub_rn(__fadd_rn(min_val, crow[j]), ui), s_v[j]);
          m = s_spc[j];
          if (cand < m) {
            m = cand;
            s_spc[j] = cand;
            s_path[j] = i;
          }
        }
        if (beats(m, j, bv, bj)) {
          bv = m;
          bj = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oj = __shfl_xor_sync(kFull, bj, o);
        if (beats(ov, oj, bv, bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (lane == 0) {
        red_v[parity][warp] = bv;
        red_j[parity][warp] = bj;
      }
      __syncthreads();
      bv = red_v[parity][0];
      bj = red_j[parity][0];
      for (int w = 1; w < kWarps; ++w) {
        if (beats(red_v[parity][w], red_j[parity][w], bv, bj)) {
          bv = red_v[parity][w];
          bj = red_j[parity][w];
        }
      }
      // the next step writes the other slot: a warp reaches it only after
      // every warp passed this step's barrier, past its reads of this one
      parity ^= 1;
      if (tid == bj % kThreads) s_sc[bj] = 1;   // the column's owner
      min_val = bv;
      const int owner = s_row4col[bj];
      if (owner < 0) {
        sink = bj;
        break;
      }
      i = owner;
    }
    __syncthreads();

    // dual updates, from the duals and spc before them
    for (int row = tid; row < r; row += kThreads) {
      if (row == cur) {
        s_u[row] = __fadd_rn(s_u[row], min_val);
      } else if (s_sr[row]) {
        const int col = min(max(s_col4row[row], 0), c - 1);
        s_u[row] = __fsub_rn(__fadd_rn(s_u[row], min_val), s_spc[col]);
      }
    }
    for (int j = tid; j < c; j += kThreads) {
      if (s_sc[j]) s_v[j] = __fsub_rn(s_v[j], __fsub_rn(min_val, s_spc[j]));
    }
    __syncthreads();

    // augment along the alternating path back to cur
    if (tid == 0) {
      int j = sink;
      for (;;) {
        const int row = s_path[j];
        s_row4col[j] = row;
        const int next = s_col4row[row];
        s_col4row[row] = j;
        if (row == cur) break;
        j = next;
      }
    }
    __syncthreads();
  }

  int32_t* f_out = out + static_cast<size_t>(frame) * r;
  for (int row = tid; row < r; row += kThreads) f_out[row] = s_col4row[row];
}

size_t lap_smem_bytes(int r, int c) {
  auto a16 = [](size_t n) { return (n + 15) & ~static_cast<size_t>(15); };
  return a16(sizeof(float) * r * c) + 2 * a16(sizeof(float) * c) +
         2 * a16(sizeof(int) * c) + a16(sizeof(float) * r) +
         a16(sizeof(int) * r) + a16(c) + a16(r);
}

}  // namespace

// cost (B, R, C) f32; row_mask (B, R) and col_mask (B, C) bool; out (B, R)
// i32.  1 <= R <= C, and the masked cost must fit in one block's shared
// memory.  Returns cudaGetLastError() (cudaErrorInvalidValue for shapes
// the kernel does not take).
extern "C" int lap_launch(const void* cost, const void* row_mask,
                          const void* col_mask, int batch, int r, int c,
                          void* out, void* stream) {
  if (batch < 1 || r < 1 || r > c) return cudaErrorInvalidValue;
  const size_t smem = lap_smem_bytes(r, c);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  lap_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const bool*>(row_mask),
      static_cast<const bool*>(col_mask), r, c, static_cast<int32_t*>(out));
  return cudaGetLastError();
}
