// What the attention kernels share: loads that widen float32 or bfloat16 to
// float32, the store back, the masked-score constant and the error text; and
// the flash tile program that the flash, banded (local and block-sparse) and
// chunked-prefill kernels run, so that the three compute the same bits for
// the same live tiles. All arithmetic is float32, whatever the type of the
// inputs.
#pragma once

#include <climits>
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

// ---------------------------------------------------------------------------
// The flash tile program.
//
// One CTA owns one (q tile, q head, batch) cell: kBQ = 64 query rows, staged
// in shared memory as float32 with a padded row stride (DMAX + 1 floats: the
// 16 x 16 thread grid reads 16 different rows of one column without bank
// conflicts), and walks KV tiles of kBK = 64 keys with the online-softmax
// carry (m, l in shared memory, acc in registers):
//
//   * each thread computes a 4 x 4 block of scores (rows ty + 16i, keys
//     tx + 16j), four threads per row take the row's max and sum with two
//     warp shuffles, and each thread keeps a 4 x DMAX/16 block of the
//     accumulator;
//   * GQA reads kv head h / G; K and V are never repeated;
//   * tensors are read and written in the model layout [B, S, H, D] through
//     their strides (the last stride must be 1);
//   * masks come from the qpos / kpos tensors only (and, for block-sparse
//     attention, the caller's block mask); ragged tiles are masked by bounds;
//   * a KV tile in which no (query, key) pair of the CTA can be visible is
//     skipped: such a tile leaves every row's (m, l, acc) exactly unchanged
//     (alpha = exp(0) = 1, p = 0), so skipping it changes no bit.
//
// Each row's arithmetic depends only on the row, the K/V values and the
// positions, never on the other rows of its tile, and nothing is summed with
// atomics: a result repeats bit for bit, and two kernels that run the same
// live tiles in the same order give the same bits.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;             // query rows of a CTA
constexpr int kBK = 64;             // keys of a KV tile
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
  // block-sparse attention only: the caller's block mask [.., mask_nk] int32,
  // element (i, j) enabled iff mask[i / mask_bq][j / mask_bk] != 0
  const int* mask;
  int mask_nk, mask_bq, mask_bk;
  // chunked prefill only: the carry, m and l [B, Hq, Sq], acc [B, Hq, Sq, D]
  // float32, read at the start and written at the end (in place)
  float* m;
  float* l;
  float* acc;
};

template <int DMAX>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (DMAX + 1) + kBQ * (kBK + 1) + 3 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

// The conservative band predicate of a (q tile, KV tile) cell from the
// tiles' position extremes (repro's `_band_live`): false only where no pair
// of the cell can be visible.
__device__ __forceinline__ bool band_live(const FlashArgs& a, int qmin, int qmax, int kmin,
                                          int kmax) {
  return (!a.causal || qmax >= kmin) && (a.window == 0 || (int64_t)qmin - kmax < a.window);
}

template <int DMAX, typename T>
struct FlashCta {
  static constexpr int LD = DMAX + 1;
  static constexpr int LS = kBK + 1;
  static constexpr int DJ = DMAX / 16;

  float* Qs;         // [kBQ][LD]
  float* Ks;         // [kBK][LD]
  float* Vs;         // [kBK][LD]
  float* Ss;         // [kBQ][LS]: scores, then p
  float* row_m;      // [kBQ]
  float* row_l;      // [kBQ]
  float* row_alpha;  // [kBQ]
  int* qp_s;         // [kBQ]
  int* kp_s;         // [kBK]
  int tid, ty, tx, q0, h, b, nrows;
  int qmin, qmax;  // positions of the CTA's real rows
  int64_t row0;    // carry row of query row q0 in [B, Hq, Sq]
  const T* k;
  const T* v;
  float acc[4][DJ];

  __device__ __forceinline__ FlashCta(const FlashArgs& a, float* smem) {
    Qs = smem;
    Ks = Qs + kBQ * LD;
    Vs = Ks + kBK * LD;
    Ss = Vs + kBK * LD;
    row_m = Ss + kBQ * LS;
    row_l = row_m + kBQ;
    row_alpha = row_l + kBQ;
    qp_s = reinterpret_cast<int*>(row_alpha + kBQ);
    kp_s = qp_s + kBQ;
    tid = threadIdx.x;
    ty = tid / 16;
    tx = tid % 16;
    q0 = blockIdx.x * kBQ;
    h = blockIdx.y;
    b = blockIdx.z;
    nrows = min(kBQ, a.Sq - q0);
    row0 = ((int64_t)b * a.Hq + h) * a.Sq + q0;
    const int hk = h / (a.Hq / a.Hkv);
    k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  }

  // Stage the q tile and its positions and set the carry: from a.m, a.l,
  // a.acc when `resume`, else the neutral (-1e30, 0, 0).
  __device__ __forceinline__ void begin(const FlashArgs& a, bool resume) {
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    for (int i = tid; i < kBQ * DMAX; i += kFlashThreads) {
      const int r = i / DMAX, d = i % DMAX;
      Qs[r * LD + d] = (r < nrows && d < a.D) ? to_f32(q[(int64_t)(q0 + r) * a.q_ss + d]) : 0.f;
    }
    if (tid < kBQ) {
      const bool in = tid < nrows;
      qp_s[tid] = in ? a.qpos[q0 + tid] : 0;
      row_m[tid] = (resume && in) ? a.m[row0 + tid] : kNegInf;
      row_l[tid] = (resume && in) ? a.l[row0 + tid] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        acc[i][j] = (resume && r < nrows && d < a.D) ? a.acc[(row0 + r) * a.D + d] : 0.f;
      }
    }
    __syncthreads();
    qmin = INT_MAX;
    qmax = INT_MIN;
    for (int r = 0; r < nrows; ++r) {
      qmin = min(qmin, qp_s[r]);
      qmax = max(qmax, qp_s[r]);
    }
  }

  // Whether the caller's block mask enables element (row r, key k0 + c).
  __device__ __forceinline__ bool cell_on(const FlashArgs& a, int r, int key) const {
    return a.mask[(int64_t)((q0 + r) / a.mask_bq) * a.mask_nk + key / a.mask_bk] != 0;
  }

  // Whether any mask cell the tile (rows q0.., keys k0..k0+ncols-1) covers is
  // enabled, over this thread's share of the cells.
  __device__ __forceinline__ bool any_cell_on(const FlashArgs& a, int k0, int ncols) const {
    const int r0 = q0 / a.mask_bq, r1 = (q0 + nrows - 1) / a.mask_bq;
    const int c0 = k0 / a.mask_bk, c1 = (k0 + ncols - 1) / a.mask_bk;
    const int nc = c1 - c0 + 1, n = (r1 - r0 + 1) * nc;
    bool any = false;
    for (int i = tid; i < n && !any; i += kFlashThreads)
      any = a.mask[(int64_t)(r0 + i / nc) * a.mask_nk + c0 + i % nc] != 0;
    return any;
  }

  // Key c of the tile at k0 (ncols keys) is visible to row r (position qp).
  template <bool kMask>
  __device__ __forceinline__ bool ok(const FlashArgs& a, int r, int qp, int k0, int c,
                                     int ncols) const {
    return c < ncols && visible(qp, kp_s[c], a.causal, a.window) &&
           (!kMask || (r < nrows && cell_on(a, r, k0 + c)));
  }

  // The KV tile of keys [k0, k0 + kBK): stage its positions, take the band
  // predicate (and, with kMask, whether any covered mask cell is on) and,
  // where live, fold the tile into (m, l, acc). Every thread of the CTA
  // calls it with the same k0.
  template <bool kMask>
  __device__ __forceinline__ void tile(const FlashArgs& a, int k0) {
    const int ncols = min(kBK, a.Skv - k0);
    if (tid < kBK) kp_s[tid] = tid < ncols ? a.kpos[k0 + tid] : 0;
    __syncthreads();
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int c = 0; c < ncols; ++c) {
      kmin = min(kmin, kp_s[c]);
      kmax = max(kmax, kp_s[c]);
    }
    bool live = band_live(a, qmin, qmax, kmin, kmax);
    if (kMask) live = __syncthreads_or(live && any_cell_on(a, k0, ncols));
    if (live) {  // the same value in every thread of the CTA
      for (int i = tid; i < kBK * DMAX; i += kFlashThreads) {
        const int r = i / DMAX, d = i % DMAX;
        const bool in = r < ncols && d < a.D;
        Ks[r * LD + d] = in ? to_f32(k[(int64_t)(k0 + r) * a.k_ss + d]) : 0.f;
        Vs[r * LD + d] = in ? to_f32(v[(int64_t)(k0 + r) * a.v_ss + d]) : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < a.D; ++d) {
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
          Ss[r * LS + c] = ok<kMask>(a, r, qp_s[r], k0, c, ncols) ? x : kNegInf;
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
          const float p = ok<kMask>(a, r, qp, k0, c, ncols) ? expf(srow[c] - m_new) : 0.f;
          srow[c] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          row_m[r] = m_new;
          row_l[r] = fmaf(l_prev, alpha, sum);
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

  // out = acc / max(l, 1e-30) in the output's type; a row with no visible
  // key gives 0.
  __device__ __forceinline__ void write_out(const FlashArgs& a) const {
    T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= nrows) continue;
      const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < a.D) store(o + (int64_t)(q0 + r) * a.o_ss + d, acc[i][j] / l);
      }
    }
  }

  // The carry (m, l, acc) back to a.m, a.l, a.acc, unnormalised.
  __device__ __forceinline__ void write_carry(const FlashArgs& a) const {
    if (tid < nrows) {
      a.m[row0 + tid] = row_m[tid];
      a.l[row0 + tid] = row_l[tid];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < a.D) a.acc[(row0 + r) * a.D + d] = acc[i][j];
      }
    }
  }
};

// Launch `kernel` on the (q tiles, Hq, B) grid with the tile program's
// dynamic shared memory.
template <int DMAX>
cudaError_t launch_flash_grid(void (*kernel)(FlashArgs), const FlashArgs& a, int B,
                              cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<DMAX>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
  kernel<<<grid, kFlashThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Pick the smallest DMAX instance that holds the head dim, and the input
// type: Launch<DMAX, T>::run(a, B, stream).
template <template <int, typename> class Launch>
cudaError_t dispatch_flash(const FlashArgs& a, int B, int bf16, cudaStream_t stream) {
  if (bf16) {
    if (a.D <= 32) return Launch<32, __nv_bfloat16>::run(a, B, stream);
    if (a.D <= 64) return Launch<64, __nv_bfloat16>::run(a, B, stream);
    if (a.D <= 128) return Launch<128, __nv_bfloat16>::run(a, B, stream);
    if (a.D <= 256) return Launch<256, __nv_bfloat16>::run(a, B, stream);
  } else {
    if (a.D <= 32) return Launch<32, float>::run(a, B, stream);
    if (a.D <= 64) return Launch<64, float>::run(a, B, stream);
    if (a.D <= 128) return Launch<128, float>::run(a, B, stream);
    if (a.D <= 256) return Launch<256, float>::run(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace chef

extern "C" const char* chef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
