// Two probes of the card for the chain term of the general banded DP's
// bound (chip_smoke.general_bound; csrc/banded_general.cu's header): the
// latency of one dependent Hopper DPX instruction, and an empty launch
// through the same ctypes route as the port's kernels. Neither is a port of
// a TPU kernel and nothing in the pipeline calls them.
//
// dpx_chain_kernel runs, on one thread, n dependent __viaddmin_s32 (x =
// min(x + a, cap), with a and cap given at run time so nothing folds) and
// writes x and the clock64 cycles the chain took; timing two values of n
// with chip_smoke.device_ms gives the latency a step in seconds.
//
// Built by allpathslg_tpu_torch/ops/cuda/nvcc.py like the kernels and bound
// with ctypes (ops/cuda/chain_probe.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 16;

__global__ void dpx_chain_kernel(int n, int a, int cap, int32_t* out,
                                 long long* cycles) {
  int x = static_cast<int>(threadIdx.x);
  const long long t0 = clock64();
  for (int i = 0; i < n; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x = __viaddmin_s32(x, a, cap);
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// n dependent DPX instructions (n a multiple of 16) on one thread; x lands
// in out[0] (int32) and the chain's clock64 cycles in cycles[0] (int64).
int chain_probe_dpx(int n, int a, int cap, int32_t* out, long long* cycles,
                    void* stream) {
  dpx_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      n, a, cap, out, cycles);
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing.
int chain_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
