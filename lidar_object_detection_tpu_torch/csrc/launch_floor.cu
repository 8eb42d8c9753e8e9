// An empty kernel, for measurements only: one block of one thread that
// does nothing.  Timed as the port's kernels are timed (chip_smoke.py
// time_gpu: CUDA events around one launch after a ~1 ms card sleep), it
// gives the practical floor under every kernel's time on the card: the
// launch, the block's scheduling and the events' resolution.  Replaces
// no TPU kernel; no path of the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches on `stream`; returns cudaGetLastError().
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
