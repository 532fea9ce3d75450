// Device code of the full-batch LR-head gradient, lr_grad, and what the
// many-row reductions (lr_gather.cuh) share with it. It computes
//
//     out[c, d] = (1/denom) * sum_i r[i, c] * Xa[i, d] + l2 * base[c, d]
//
// with r[i] = (softmax(x_i.w^T) - y_i) * g_i, the residual of row i over the
// C classes. The TPU kernel carries the [C, D] sum in VMEM across a
// sequential grid; H100 blocks run in parallel and in no order, so the sum
// is taken in three passes with no float atomics:
//
//   row_pass   one warp per row: logits z = x.w^T over D with lane-strided
//              scalar loads (lane k reads columns k, k+32, ...: coalesced for
//              any D, so an odd D = d+1 needs no padding), warp-shuffle sums,
//              softmax in registers, residual r [C] to scratch R [n_rows, C].
//   col_pass   a block owns kColThreads columns and one chunk of rows; each
//              thread walks the chunk's rows in order and writes its partial
//              sums to scratch [n_chunks, C, D]. The wrapper sizes the chunks
//              so that the grid holds about four blocks per SM.
//   chunk_sum  one thread per (c, d) sums the chunks in a fixed order,
//              divides by denom and adds l2 * base.
//
// The summation order depends only on the shapes and the SM count, so a
// result repeats bit for bit from run to run on one card.
//
// Bound: device-memory bytes. The row and column passes each read the rows
// once, so the kernel moves about twice the bytes of its bound (one read of
// the rows). lr_grad runs on the 579 validation rows (3 calls a round), so
// the three launches, not the bytes, set its time; lr_hvp, which ran here
// too, takes lr_gather.cuh's one-launch grid.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chef {

constexpr int kWarp = 32;
constexpr int kRowWarps = 8;      // rows (one warp each) per row-pass block
constexpr int kColThreads = 256;  // columns per column-pass block
constexpr int kMaxClasses = 16;   // kernels/common.py: MAX_CLASSES

// kGrad runs here; kGrad, kHvp and kCorr in the many-row kernels (lr_gather.cuh).
enum Residual { kGrad = 0, kHvp = 1, kCorr = 2 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// r = (p - y) * g, p = softmax(x.w^T).
template <int C>
__global__ void __launch_bounds__(kRowWarps * kWarp)
row_pass(const float* __restrict__ Xa, int D, int n_rows, const float* __restrict__ w,
         const float* __restrict__ Y, const float* __restrict__ gw, float* __restrict__ R) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const int64_t src = row;
  const float* x = Xa + src * D;
  float z[C];
#pragma unroll
  for (int c = 0; c < C; ++c) z[c] = 0.f;
#pragma unroll 4
  for (int d = lane; d < D; d += kWarp) {
    const float xv = x[d];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      z[c] = fmaf(xv, w[c * D + d], z[c]);
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    z[c] = warp_sum(z[c]);
    m = fmaxf(m, z[c]);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    z[c] = expf(z[c] - m);
    s += z[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) z[c] = z[c] / s;  // z now holds p
  const float g = gw[src];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (lane != c) continue;
    R[(int64_t)row * C + c] = (z[c] - Y[src * C + c]) * g;
  }
}

template <int C>
__global__ void __launch_bounds__(kColThreads)
col_pass(const float* __restrict__ Xa, int D, int n_rows, int chunk_rows,
         const float* __restrict__ R, float* __restrict__ partial) {
  const int chunk = blockIdx.y;
  const int row0 = chunk * chunk_rows;
  const int row1 = min(row0 + chunk_rows, n_rows);
  const int d = blockIdx.x * kColThreads + threadIdx.x;
  if (d >= D) return;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  // R is read at one address by the whole block (a broadcast from L1); the
  // Xa reads of a warp are 32 neighbouring columns of one row.
#pragma unroll 8
  for (int i = row0; i < row1; ++i) {
    const int64_t src = i;
    const float xv = Xa[src * D + d];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(R[(int64_t)i * C + c], xv, acc[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) partial[((int64_t)chunk * C + c) * D + d] = acc[c];
}

__global__ void chunk_sum(const float* __restrict__ partial, int n_chunks, int CD, float denom,
                          float l2, const float* __restrict__ base, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= CD) return;
  float s = 0.f;
  for (int k = 0; k < n_chunks; ++k) s += partial[(int64_t)k * CD + j];
  out[j] = base ? s / denom + l2 * base[j] : s / denom;
}

template <int C>
void launch_passes(const float* Xa, int D, int n_rows, int chunk_rows, const float* w,
                   const float* Y, const float* gw, float* R, float* partial, cudaStream_t st) {
  const dim3 rgrid((n_rows + kRowWarps - 1) / kRowWarps);
  const dim3 cgrid((D + kColThreads - 1) / kColThreads, (n_rows + chunk_rows - 1) / chunk_rows);
  row_pass<C><<<rgrid, kRowWarps * kWarp, 0, st>>>(Xa, D, n_rows, w, Y, gw, R);
  col_pass<C><<<cgrid, kColThreads, 0, st>>>(Xa, D, n_rows, chunk_rows, R, partial);
}

// All three passes on `st`. Scratch: R [n_rows, C], partial [n_chunks, C, D]
// with n_chunks = ceil(n_rows / chunk_rows); the wrapper picks chunk_rows
// from the shapes and the card's SM count (kernels/common.py: chunk_rows).
// base == nullptr drops the l2 term. Returns cudaGetLastError() after the
// last launch.
inline cudaError_t launch_rowcol(const float* Xa, int D, int n_rows, int C, int chunk_rows,
                                 const float* w, const float* Y, const float* gw, float denom,
                                 float l2, const float* base, float* R, float* partial,
                                 float* out, cudaStream_t st) {
  if (n_rows < 1 || D < 1 || chunk_rows < 1) return cudaErrorInvalidValue;
  const int n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  if (n_chunks > 65535) return cudaErrorInvalidValue;  // grid y limit
  switch (C) {
#define CHEF_CASE(K)                                                         \
  case K:                                                                    \
    launch_passes<K>(Xa, D, n_rows, chunk_rows, w, Y, gw, R, partial, st); \
    break;
    CHEF_CASE(1) CHEF_CASE(2) CHEF_CASE(3) CHEF_CASE(4) CHEF_CASE(5) CHEF_CASE(6)
    CHEF_CASE(7) CHEF_CASE(8) CHEF_CASE(9) CHEF_CASE(10) CHEF_CASE(11) CHEF_CASE(12)
    CHEF_CASE(13) CHEF_CASE(14) CHEF_CASE(15) CHEF_CASE(16)
#undef CHEF_CASE
    default:
      return cudaErrorInvalidValue;
  }
  chunk_sum<<<(C * D + 255) / 256, 256, 0, st>>>(partial, n_chunks, C * D, denom, l2, base, out);
  return cudaGetLastError();
}

}  // namespace chef

extern "C" const char* chef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
