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
// PAD_COST = 1e6 in every masked row and column, are solved by shortest
// augmenting paths, one Dijkstra phase per row:
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
// operations per column for each scanned column, some 10^6 a frame.  Its
// bound is well under a microsecond.  What it takes is the dependent
// chain: each Dijkstra step needs the argmin of the step before, so a
// frame makes its scanned columns (up to R (R + 3) / 2 = 560 at R = 32)
// one after another.  A step's latency is the whole cost.
//
// What the design does about it: no block barrier on the chain.
// * One warp per frame (a block of 32 threads), all frames of a batch in
//   one launch.  Lane l owns the columns j = l + 32 k.  For C <= 1024 the
//   kernel is instantiated on K = columns per lane (1, 2, 4, 8, 12, 16,
//   24 or 32), and a lane keeps its columns' spc, v and path, and a
//   bitmask of the columns still free (in range, not scanned), in
//   registers.  Wider C (small R) take the instantiation K = 0, whose
//   per-lane state lives in shared memory (still touched by its owner
//   alone).
// * The cost comes into shared memory once per frame with one bulk
//   asynchronous copy (cp.async.bulk, completion on an mbarrier), and
//   PAD_COST is written into the masked entries once.
// * A step's argmin: each lane's least value by a tree of minima, and
//   the lowest of its columns that holds it (a lane's columns ascend with
//   the slot); then two warp-wide reductions,
//   __reduce_min_sync of an order-preserving 32-bit key of the value and
//   __reduce_min_sync of the column among the lanes that hold the least
//   key.  The key is made of v + 0.0f, so that -0.0 and +0.0, equal as
//   floats, tie and go to the lower index as jnp.argmin has them.  The
//   popped value is the key's float: spc is never -0.0 (a candidate is
//   -0.0 only if min_val is, and min_val starts at +0.0 and is a popped
//   spc), so the key gives its bits back.
// * The next row and its dual come in one 8-byte shared load: each column
//   keeps a link (row4col[j], u[row4col[j]]), rewritten where u or
//   row4col change (the phase's dual updates and its augmentation); K = 0
//   keeps row4col alone (4 bytes a column, so that C = 1600 fits at
//   R = 32) and reads u by the row.
// * The duals are updated in registers and by each scanned column's owner
//   (u of the row it leads to); the augmentation (at most k + 1 edges in
//   phase k) is lane 0's walk through shared memory, fenced by
//   __syncwarp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;
constexpr float kPadCost = 1.0e6f;
constexpr size_t kMaxSmem = 232448;   // what one H100 block can use

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// An order-preserving key of a float (no NaN here): a < b as floats iff
// key(a) < key(b); -0.0 is keyed as +0.0.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The float of a key: order_key(x) gives back x + 0.0f.
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A column's candidate from row i, in JAX's order.
__device__ __forceinline__ float candidate(float min_val, float cost,
                                           float ui, float v) {
  return __fsub_rn(__fsub_rn(__fadd_rn(min_val, cost), ui), v);
}

// Shared state of one frame, written by its phase ends: per column the
// path and the row assigned to it; per row u and col4row.  With kLink
// (the register instantiations) a column keeps its row as a link
// (row4col[j], u[row4col[j]] as bits), so that a step's next row and its
// dual come in one 8-byte shared load; the link is rewritten where u or
// row4col change (the phase's dual updates and its augmentation).  K = 0
// keeps row4col alone, 4 bytes a column less, and reads u by the row.
template <bool kLink>
struct Frame {
  const float* cost;   // (R, C), PAD_COST in the masked entries
  int2* link;          // kLink: (row4col, u bits) per column
  int* row4col;        // !kLink
  int* path;
  float* u;
  int* col4row;
  int c;

  // (row4col[j], u[row4col[j]]), the u only where the row is >= 0
  __device__ int2 lookup(int j) const {
    if (kLink) return link[j];
    const int row = row4col[j];
    return make_int2(row, row >= 0 ? __float_as_int(u[row]) : 0);
  }
  // the augmentation's edge: column j to row, whose u is final
  __device__ void assign(int j, int row) const {
    if (kLink) link[j] = make_int2(row, __float_as_int(u[row]));
    else row4col[j] = row;
  }
  // The phase end for one scanned column j: the dual u of the row it
  // leads to, and v[j], from the duals and spc before them.
  __device__ void scanned_dual(int j, float min_val, float spc,
                               float& v) const {
    const int2 l = lookup(j);
    if (l.x >= 0) {
      const float nu =
          __fsub_rn(__fadd_rn(__int_as_float(l.y), min_val), spc);
      u[l.x] = nu;
      if (kLink) link[j].y = __float_as_int(nu);
    }
    v = __fsub_rn(v, __fsub_rn(min_val, spc));
  }
};

// A lane's K columns j = lane + 32 k in registers.
template <int K>
struct RegCols {
  float spc_[K], v_[K];
  int path_[K];
  uint32_t in_range_ = 0, free_ = 0;   // bit k: j < C; and not scanned
  int lane_;

  __device__ RegCols(int c, int lane, unsigned char*) : lane_(lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v_[k] = 0.0f;
      path_[k] = -1;
      if (lane + kLanes * k < c) in_range_ |= 1u << k;
    }
  }
  __device__ void reset() {
    free_ = in_range_;
#pragma unroll
    for (int k = 0; k < K; ++k) spc_[k] = INFINITY;
  }
  // Relax the free columns from row i; the lane's lowest (spc, column)
  // among them, (inf, some column) where none is free.
  __device__ void relax(const Frame<true>& fr, int i, float min_val,
                        float ui, float& best, uint32_t& best_j) {
    const float* crow = fr.cost + static_cast<size_t>(i) * fr.c;
    float val[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // loaded for every slot (the row's padding covers j >= C), used
      // for the free ones
      const bool f = (free_ & (1u << k)) != 0u;
      const float cand =
          candidate(min_val, crow[lane_ + kLanes * k], ui, v_[k]);
      const bool better = f && cand < spc_[k];
      spc_[k] = better ? cand : spc_[k];
      path_[k] = better ? i : path_[k];
      val[k] = f ? spc_[k] : INFINITY;
    }
    // the least value by a tree of minima; then the lowest slot that
    // holds it, off the chain (it overlaps the warp's first reduction).
    // A lane's columns ascend with the slot: its lowest column.
    float t[K];
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = val[k];
#pragma unroll
    for (int s = 1; s < K; s *= 2) {
#pragma unroll
      for (int k = 0; k + s < K; k += 2 * s) t[k] = fminf(t[k], t[k + s]);
    }
    best = t[0];
    int sl = K - 1;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) sl = val[k] == best ? k : sl;
    best_j = static_cast<uint32_t>(lane_ + kLanes * sl);
  }
  __device__ void pop(uint32_t j) {
    if (static_cast<int>(j & 31u) == lane_) free_ &= ~(1u << (j >> 5));
  }
  // The phase end of the lane's scanned columns: duals, and the path
  // into shared memory for the augmentation.
  __device__ void finish(const Frame<true>& fr, float min_val) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((in_range_ & ~free_) >> k) & 1u) {
        const int j = lane_ + kLanes * k;
        fr.scanned_dual(j, min_val, spc_[k], v_[k]);
        fr.path[j] = path_[k];
      }
    }
  }
};

// K = 0: the same state in shared memory (spc, v, then a scanned byte per
// column; path is the frame's), for C > 1024.
struct SmemCols {
  float* spc_;
  float* v_;
  unsigned char* sc_;
  int lane_, c_;

  __device__ SmemCols(int c, int lane, unsigned char* state)
      : spc_(reinterpret_cast<float*>(state)),
        v_(reinterpret_cast<float*>(state + align16(sizeof(float) * c))),
        sc_(state + 2 * align16(sizeof(float) * c)), lane_(lane), c_(c) {
    for (int j = lane; j < c; j += kLanes) v_[j] = 0.0f;
  }
  __device__ void reset() {
    for (int j = lane_; j < c_; j += kLanes) {
      spc_[j] = INFINITY;
      sc_[j] = 0;
    }
  }
  __device__ void relax(const Frame<false>& fr, int i, float min_val,
                        float ui, float& best, uint32_t& best_j) {
    const float* crow = fr.cost + static_cast<size_t>(i) * fr.c;
    best = INFINITY;
    best_j = static_cast<uint32_t>(lane_);
    for (int j = lane_; j < c_; j += kLanes) {   // ascending j
      if (sc_[j]) continue;
      const float cand = candidate(min_val, crow[j], ui, v_[j]);
      if (cand < spc_[j]) {
        spc_[j] = cand;
        fr.path[j] = i;
      }
      if (spc_[j] < best) {
        best = spc_[j];
        best_j = static_cast<uint32_t>(j);
      }
    }
  }
  __device__ void pop(uint32_t j) {
    if (static_cast<int>(j & 31u) == lane_) sc_[j] = 1;
  }
  __device__ void finish(const Frame<false>& fr, float min_val) {
    for (int j = lane_; j < c_; j += kLanes)
      if (sc_[j]) fr.scanned_dual(j, min_val, spc_[j], v_[j]);
  }
};

template <int K>
using Cols = typename std::conditional<K == 0, SmemCols,
                                      RegCols<(K > 0 ? K : 1)>>::type;

// Shared memory of one frame: the cost and 128 bytes past it (a row's
// slots beyond C read there), the links (8 bytes a column; K = 0:
// row4col, 4), path, u, col4row, the row mask and the mbarrier; then
// (K = 0) spc, v and the scanned flags.  4 R C + 12 C + 9 R bytes and
// some, 4 R C + 17 C + 9 R for K = 0: C up to 1600 at R = 32.
size_t lap_smem_bytes(int r, int c, int k) {
  const size_t n = align16(sizeof(float) * r * c) + 128 +
                   align16((k > 0 ? sizeof(int2) : sizeof(int)) * c) +
                   align16(sizeof(int) * c) + align16(sizeof(float) * r) +
                   align16(sizeof(int) * r) + align16(r) + 16;
  return k > 0 ? n : n + 2 * align16(sizeof(float) * c) + align16(c);
}

// grid (B,), block 32 (one warp, one frame).  Dynamic shared memory:
// lap_smem_bytes(r, c, K).
template <int K>
__global__ void __launch_bounds__(kLanes, 1) lap_kernel(
    const float* __restrict__ cost, const bool* __restrict__ row_mask,
    const bool* __restrict__ col_mask, int r, int c,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int frame = blockIdx.x;
  const int lane = threadIdx.x;

  size_t off = 0;
  float* s_cost = reinterpret_cast<float*>(smem + off);
  off += align16(sizeof(float) * r * c) + 128;
  int2* s_link = reinterpret_cast<int2*>(smem + off);   // K = 0: row4col
  off += align16((K > 0 ? sizeof(int2) : sizeof(int)) * c);
  int* s_path = reinterpret_cast<int*>(smem + off);
  off += align16(sizeof(int) * c);
  float* s_u = reinterpret_cast<float*>(smem + off);
  off += align16(sizeof(float) * r);
  int* s_col4row = reinterpret_cast<int*>(smem + off);
  off += align16(sizeof(int) * r);
  unsigned char* s_rows = smem + off;
  off += align16(r);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + off);
  off += 16;

  const float* f_cost = cost + static_cast<size_t>(frame) * r * c;
  const bool* f_rows = row_mask + static_cast<size_t>(frame) * r;
  const bool* f_cols = col_mask + static_cast<size_t>(frame) * c;
  const uint32_t bytes = static_cast<uint32_t>(sizeof(float) * r * c);
  const bool bulk = (bytes & 15u) == 0 &&
                    (reinterpret_cast<uintptr_t>(f_cost) & 15u) == 0;
  if (bulk && lane == 0) {
    // one bulk asynchronous copy of the frame's cost, completing on an
    // mbarrier; the rest of the set-up runs meanwhile
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(s_bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(s_bar)),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s_cost)),
        "l"(f_cost), "r"(bytes), "r"(smem_addr(s_bar))
        : "memory");
  }
  const Frame<(K > 0)> fr{s_cost, s_link, reinterpret_cast<int*>(s_link),
                          s_path, s_u, s_col4row, c};
  for (int j = lane; j < c; j += kLanes) {
    if (K > 0) s_link[j] = make_int2(-1, 0);
    else fr.row4col[j] = -1;
    s_path[j] = f_cols[j] ? 1 : 0;   // the column mask, for the set-up
  }
  for (int row = lane; row < r; row += kLanes) {
    s_u[row] = 0.0f;
    s_col4row[row] = -1;
    s_rows[row] = f_rows[row] ? 1 : 0;
  }
  Cols<K> cols(c, lane, smem + off);
  __syncwarp();   // the mbarrier's init, before any lane waits on it
  if (bulk) {
    uint32_t ready = 0;
    while (!ready) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(ready)
          : "r"(smem_addr(s_bar))
          : "memory");
    }
  }
  // PAD_COST into the masked rows and columns: a lane writes (and later
  // reads) only its own columns
  for (int row = 0; row < r; ++row) {
    const bool row_real = s_rows[row];
    for (int j = lane; j < c; j += kLanes) {
      const size_t idx = static_cast<size_t>(row) * c + j;
      if (!(row_real && s_path[j])) s_cost[idx] = kPadCost;
      else if (!bulk) s_cost[idx] = f_cost[idx];
    }
  }
  s_cost[r * c + lane] = 0.0f;   // the padding past the last row
  __syncwarp();

  for (int cur = 0; cur < r; ++cur) {
    cols.reset();
    // Dijkstra over the columns from row cur; every lane holds the same
    // i, u[i] and min_val
    int i = cur;
    float ui = s_u[cur];
    float min_val = 0.0f;
    uint32_t sink;
    for (;;) {
      float best;
      uint32_t best_j;
      cols.relax(fr, i, min_val, ui, best, best_j);
      const uint32_t key = order_key(best);
      const uint32_t kmin = __reduce_min_sync(kFull, key);
      const uint32_t jmin =
          __reduce_min_sync(kFull, key == kmin ? best_j : kNone);
      min_val = key_value(kmin);
      cols.pop(jmin);
      const int2 l = fr.lookup(static_cast<int>(jmin));
      if (l.x < 0) {
        sink = jmin;
        break;
      }
      i = l.x;
      ui = __int_as_float(l.y);
    }

    // dual updates, from the duals and spc before them: each scanned
    // column's owner updates its v and the u of the row it leads to
    cols.finish(fr, min_val);
    if (lane == 0) s_u[cur] = __fadd_rn(s_u[cur], min_val);
    __syncwarp();

    // augment along the alternating path back to cur, relinking each
    // column to its new row and that row's u
    if (lane == 0) {
      int j = static_cast<int>(sink);
      for (;;) {
        const int row = s_path[j];
        const int next = s_col4row[row];
        fr.assign(j, row);
        s_col4row[row] = j;
        if (row == cur) break;
        j = next;
      }
    }
    __syncwarp();
  }

  int32_t* f_out = out + static_cast<size_t>(frame) * r;
  for (int row = lane; row < r; row += kLanes) f_out[row] = s_col4row[row];
}

template <int K>
cudaError_t launch(const float* cost, const bool* row_mask,
                   const bool* col_mask, int batch, int r, int c,
                   int32_t* out, cudaStream_t stream) {
  const size_t smem = lap_smem_bytes(r, c, K);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lap_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  lap_kernel<K><<<batch, kLanes, smem, stream>>>(cost, row_mask, col_mask,
                                                  r, c, out);
  return cudaGetLastError();
}

}  // namespace

// cost (B, R, C) f32; row_mask (B, R) and col_mask (B, C) bool; out (B, R)
// i32.  1 <= R <= C, and one frame's cost and state must fit in one
// block's shared memory (C up to about 1600 at R = 32).  Returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes the kernel does not
// take).
extern "C" int lap_launch(const void* cost, const void* row_mask,
                          const void* col_mask, int batch, int r, int c,
                          void* out, void* stream) {
  if (batch < 1 || r < 1 || r > c) return cudaErrorInvalidValue;
  const auto* f = static_cast<const float*>(cost);
  const auto* rm = static_cast<const bool*>(row_mask);
  const auto* cm = static_cast<const bool*>(col_mask);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  const int per = (c + kLanes - 1) / kLanes;
  if (per <= 1) return launch<1>(f, rm, cm, batch, r, c, o, s);
  if (per <= 2) return launch<2>(f, rm, cm, batch, r, c, o, s);
  if (per <= 4) return launch<4>(f, rm, cm, batch, r, c, o, s);
  if (per <= 8) return launch<8>(f, rm, cm, batch, r, c, o, s);
  if (per <= 12) return launch<12>(f, rm, cm, batch, r, c, o, s);
  if (per <= 16) return launch<16>(f, rm, cm, batch, r, c, o, s);
  if (per <= 24) return launch<24>(f, rm, cm, batch, r, c, o, s);
  if (per <= 32) return launch<32>(f, rm, cm, batch, r, c, o, s);
  return launch<0>(f, rm, cm, batch, r, c, o, s);
}
