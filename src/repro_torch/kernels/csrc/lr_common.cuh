// What the LR-head kernels share: infl_scores.cu's one warp a row, and
// lr_gather.cuh's reductions over many rows (lr_grad, lr_hvp,
// minibatch_grad, replay_correction).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chef {

constexpr int kWarp = 32;
constexpr int kRowWarps = 8;     // infl_scores: rows (one warp each) per block
constexpr int kMaxClasses = 16;  // kernels/common.py: MAX_CLASSES

// The residual a many-rows kernel forms for each row (lr_gather.cuh).
enum Residual { kGrad = 0, kHvp = 1, kCorr = 2 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace chef

extern "C" const char* chef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
