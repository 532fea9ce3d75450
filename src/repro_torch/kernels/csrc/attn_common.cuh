// What the two attention kernels share: loads that widen float32 or bfloat16
// to float32, the store back, the masked-score constant and the error text.
// All arithmetic is float32, whatever the type of the inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chef {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF: masked scores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Whether the key at position kp is visible to the query at position qp:
// causal (kp <= qp) and, with a window, qp - kp < window.
__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  return (!causal || qp >= kp) && (window == 0 || qp - kp < window);
}

}  // namespace chef

extern "C" const char* chef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
