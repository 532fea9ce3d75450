// GQA flash attention forward with causal, sliding-window and logit-softcap
// masks (replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas):
//
//     s = softcap * tanh((q.k^T * scale) / softcap)     (softcap > 0 only)
//     s = visible(qpos, kpos) ? s : -1e30
//     out = softmax(s) . v,   a row with no visible key -> 0
//
// The TPU kernel walks the KV blocks of one (b, h, q block) as the
// sequential innermost grid axis and carries the running max m, denominator
// l and accumulator in VMEM. H100 blocks run in parallel and in no order, so
// here one CTA owns one (q tile, q head, batch) cell and loops over the KV
// tiles itself, with (m, l, acc) in shared memory and registers:
//
//   * tiles of kBQ = 64 query rows and kBK = 64 keys, staged in shared memory
//     as float32 with a padded row stride (DMAX + 1 floats: the 16 x 16
//     thread grid reads 16 different rows of one column without bank
//     conflicts); bf16 inputs are widened while they are staged;
//   * each thread computes a 4 x 4 block of scores (rows ty + 16i, keys
//     tx + 16j), four threads per row take the row's max and sum with two
//     warp shuffles, and each thread keeps a 4 x DMAX/16 block of the
//     accumulator in registers;
//   * GQA reads kv head h / G; K and V are never repeated;
//   * tensors are read and written in the model layout [B, S, H, D] through
//     their strides (the last stride must be 1), so no transpose copy is made;
//   * masks come only from the qpos / kpos tensors; ragged last tiles (any Sq,
//     Skv) are masked by their bounds;
//   * a KV tile in which no (query, key) pair of the CTA can be visible is
//     skipped: such a tile leaves every row's (m, l, acc) exactly unchanged
//     (alpha = exp(0) = 1, p = 0), so skipping it changes no bit.
//
// Each row's arithmetic depends only on the row, the K/V values and the
// positions, never on the other rows of its tile, and nothing is summed with
// atomics: a result repeats bit for bit.
//
// Bound on the H100: for a prefill at S = 256 with D = 128 the scores and the
// value product are 4 * S^2 * D flops a head in float32 (no tensor cores in
// this first version) against 4 * S * D * 4 bytes of q, k, v and out, so it
// is bound by operations at the 67 TFLOP/s float32 rate.
#include <climits>

#include "attn_common.cuh"

namespace chef {

constexpr int kBQ = 64;          // query rows of a CTA
constexpr int kBK = 64;          // keys of a KV tile
constexpr int kFlashThreads = 256;  // 16 x 16: (ty, tx)

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* o;
  int Sq, Skv, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, inv_softcap, scale;
};

template <int DMAX>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (DMAX + 1) + kBQ * (kBK + 1) + 3 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <int DMAX, typename T>
__global__ void __launch_bounds__(kFlashThreads) flash_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = DMAX + 1;
  constexpr int LS = kBK + 1;
  constexpr int DJ = DMAX / 16;
  float* Qs = smem;                       // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;              // [kBK][LD]
  float* Vs = Ks + kBK * LD;              // [kBK][LD]
  float* Ss = Vs + kBK * LD;              // [kBQ][LS]: scores, then p
  float* row_m = Ss + kBQ * LS;           // [kBQ]
  float* row_l = row_m + kBQ;             // [kBQ]
  float* row_alpha = row_l + kBQ;         // [kBQ]
  int* qp_s = reinterpret_cast<int*>(row_alpha + kBQ);  // [kBQ]
  int* kp_s = qp_s + kBQ;                                // [kBK]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int D = a.D;
  const int nrows = min(kBQ, a.Sq - q0);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * DMAX; i += kFlashThreads) {
    const int r = i / DMAX, d = i % DMAX;
    Qs[r * LD + d] = (r < nrows && d < D) ? to_f32(q[(int64_t)(q0 + r) * a.q_ss + d]) : 0.f;
  }
  if (tid < kBQ) {
    qp_s[tid] = tid < nrows ? a.qpos[q0 + tid] : 0;
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;  // positions of the CTA's real rows
  for (int r = 0; r < nrows; ++r) {
    qmin = min(qmin, qp_s[r]);
    qmax = max(qmax, qp_s[r]);
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.Skv; k0 += kBK) {
    const int ncols = min(kBK, a.Skv - k0);
    if (tid < kBK) kp_s[tid] = tid < ncols ? a.kpos[k0 + tid] : 0;
    __syncthreads();
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int c = 0; c < ncols; ++c) {
      kmin = min(kmin, kp_s[c]);
      kmax = max(kmax, kp_s[c]);
    }
    // conservative: false only where no pair of the tile can be visible
    const bool live = (!a.causal || qmax >= kmin) &&
                      (a.window == 0 || (int64_t)qmin - kmax < a.window);
    if (live) {  // the same value in every thread of the CTA
      for (int i = tid; i < kBK * DMAX; i += kFlashThreads) {
        const int r = i / DMAX, d = i % DMAX;
        const bool in = r < ncols && d < D;
        Ks[r * LD + d] = in ? to_f32(k[(int64_t)(k0 + r) * a.k_ss + d]) : 0.f;
        Vs[r * LD + d] = in ? to_f32(v[(int64_t)(k0 + r) * a.v_ss + d]) : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float x = s[i][j] * a.scale;
          if (a.softcap != 0.f) x = a.softcap * tanhf(x * a.inv_softcap);
          const bool ok = c < ncols && visible(qp_s[r], kp_s[c], a.causal, a.window);
          Ss[r * LS + c] = ok ? x : kNegInf;
        }
      }
      __syncthreads();

      {  // online softmax: four threads (lanes 4r..4r+3 of a warp) per row
        const int r = tid >> 2, part = tid & 3;
        const int qp = qp_s[r];
        float* srow = Ss + r * LS;
        const float m_prev = row_m[r], l_prev = row_l[r];
        float mx = kNegInf;
        for (int c = part * 16; c < part * 16 + 16; ++c) mx = fmaxf(mx, srow[c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_prev, mx);
        const float alpha = expf(fminf(m_prev - m_new, 0.f));
        float sum = 0.f;
        for (int c = part * 16; c < part * 16 + 16; ++c) {
          const bool ok = c < ncols && visible(qp, kp_s[c], a.causal, a.window);
          const float p = ok ? expf(srow[c] - m_new) : 0.f;
          srow[c] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          row_m[r] = m_new;
          row_l[r] = l_prev * alpha + sum;
          row_alpha[r] = alpha;
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = row_alpha[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
      }
      for (int c = 0; c < ncols; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * LS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float vv = Vs[c * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites kp_s, Ks, Vs and Ss
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(o + (int64_t)(q0 + r) * a.o_ss + d, acc[i][j] / l);
    }
  }
}

template <int DMAX, typename T>
cudaError_t launch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<DMAX, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
  flash_kernel<DMAX, T><<<grid, kFlashThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch_flash<32, T>(a, B, stream);
  if (a.D <= 64) return launch_flash<64, T>(a, B, stream);
  if (a.D <= 128) return launch_flash<128, T>(a, B, stream);
  if (a.D <= 256) return launch_flash<256, T>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace chef

// q [B, Sq, Hq, D], k / v [B, Skv, Hkv, D], out [B, Sq, Hq, D], all of one
// type (float32, or bfloat16 when bf16 != 0) with a last stride of 1; the
// other strides are given in elements. qpos [Sq], kpos [Skv] int32.
// inv_softcap is 1 / softcap rounded once to float32 by the caller, as the
// JAX kernel's s * (1.0 / softcap) rounds it.
extern "C" int chef_flash_attention(const void* q, const void* k, const void* v,
                                    const int* qpos, const int* kpos, void* out, int B, int Sq,
                                    int Skv, int Hq, int Hkv, int D, long long q_sb,
                                    long long q_ss, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, long long o_sb,
                                    long long o_ss, long long o_sh, int causal, int window,
                                    float softcap, float inv_softcap, float scale, int bf16,
                                    void* stream) {
  chef::FlashArgs a{q,    k,    v,    qpos, kpos, out,  Sq,   Skv,    Hq,     Hkv,
                    D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss,   v_sh,
                    o_sb, o_ss, o_sh, causal, window, softcap, inv_softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? chef::dispatch_flash<__nv_bfloat16>(a, B, st)
                               : chef::dispatch_flash<float>(a, B, st));
}
