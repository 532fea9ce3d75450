// Eq. 6 INFL score matrix (replaces the TPU kernel
// repro/kernels/infl_scores.py::infl_scores_pallas):
//     u = x.v^T;  base = sum_c (y_c + (1 - gamma)(p_c - y_c)) u_c;  S[:, c] = base - u_c
//
// Bound: device-memory bytes, one read of Xa [N, D] (the [N, C] P, Y and S are
// C/D of that). One warp per row reads the row with lane-strided scalar loads
// (coalesced for any D, so the odd D = d+1 needs no padding), sums the C dot
// products with warp shuffles and writes the row's C scores: one pass, no
// reduction across blocks. The TPU kernel masks the class lanes that ops.py
// padded to 128; here C is exact (a template parameter), so there is nothing
// to mask.
#include "lr_common.cuh"

namespace chef {

template <int C>
__global__ void __launch_bounds__(kRowWarps * kWarp)
infl_scores_kernel(const float* __restrict__ Xa, int D, int n, const float* __restrict__ v,
                   const float* __restrict__ P, const float* __restrict__ Y,
                   float one_minus_gamma, float* __restrict__ S) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= n) return;
  const float* x = Xa + (int64_t)row * D;
  float u[C];
#pragma unroll
  for (int c = 0; c < C; ++c) u[c] = 0.f;
#pragma unroll 4
  for (int d = lane; d < D; d += kWarp) {
    const float xv = x[d];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = fmaf(xv, v[c * D + d], u[c]);
  }
  float base = 0.f;
  const int64_t o = (int64_t)row * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    u[c] = warp_sum(u[c]);
    const float y = Y[o + c];
    base += (y + one_minus_gamma * (P[o + c] - y)) * u[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane == c) S[o + c] = base - u[c];
}

}  // namespace chef

extern "C" int chef_infl_scores(const float* v, const float* Xa, const float* P, const float* Y,
                                int n, int d, int c, float one_minus_gamma, float* S,
                                void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + chef::kRowWarps - 1) / chef::kRowWarps);
  const dim3 block(chef::kRowWarps * chef::kWarp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define CHEF_CASE(K)                                                                          \
  case K:                                                                                     \
    chef::infl_scores_kernel<K><<<grid, block, 0, st>>>(Xa, d, n, v, P, Y, one_minus_gamma, S); \
    break;
    CHEF_CASE(1) CHEF_CASE(2) CHEF_CASE(3) CHEF_CASE(4) CHEF_CASE(5) CHEF_CASE(6)
    CHEF_CASE(7) CHEF_CASE(8) CHEF_CASE(9) CHEF_CASE(10) CHEF_CASE(11) CHEF_CASE(12)
    CHEF_CASE(13) CHEF_CASE(14) CHEF_CASE(15) CHEF_CASE(16)
#undef CHEF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
