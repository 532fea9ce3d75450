// What the attention kernels share: loads that widen float32 or bfloat16 to
// float32, the store back, the masked-score constant and the error text; and
// the flash tile program that the flash, banded (local and block-sparse) and
// chunked-prefill kernels run, so that the three compute the same bits for
// the same live tiles. All arithmetic is float32 (split-TF32 products on the
// tensor cores, float32 sums), whatever the type of the inputs.
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
// One CTA owns one (q tile, q head, batch) cell: kRows query rows, kSplit
// warps for each 16 rows, and walks the live KV tiles of kBK = 64 keys with
// the online-softmax carry (m, l, acc) in registers.
//
// Bound on the H100: at the serving shapes the work is 4 D flops a visible
// (query, key) pair. Float32 operands on the CUDA cores cap that at 67
// TFLOP/s. Here both products run on the tensor cores (mma.sync m16n8k8
// TF32) in split TF32: each float32 operand x is hi = rna(x) and lo = rna(x -
// hi), rna rounding to TF32 to nearest with ties away from zero (the bits of
// cvt.rna.tf32.f32, computed with two integer operations, which on the H100
// run faster than the conversion instruction), and a product is the float32
// sum lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (the fast-accurate float32 mode of
// CUTLASS), three TF32 products: 165 TFLOP/s a float32 product at the 495
// TFLOP/s TF32 peak. Single-pass TF32 (about 5e-4 relative) is never used,
// and raw float32 bits never reach the MMA (it would truncate them). A
// bfloat16 operand is exact in TF32: its lo is 0 and its product is skipped,
// so in bf16 Q.K^T takes one product and P.V two (P is float32). The tensor
// cores' adds do not round to nearest, so no long chain of them runs into a
// running sum: Q.K^T sums each 16-dim group from zero and adds it to the
// score in float32, and P.V sums each tile from zero and joins acc in one
// FMA (acc * alpha + tile), which roughly halves the error against the
// plain version at no cost in time.
//
//   * With kSplit = 2 the two warps of a pair split each 64-key step: for
//     its 16 rows, warp half 0 computes the scores of keys 0..31 and half 1
//     those of keys 32..63 (S = Q.K^T, four m16n8 accumulators), and each
//     computes P.V for its half of the head dims over all 64 keys. They
//     exchange their rows' maxima and sums and their 16 x 32 blocks of p
//     through shared memory, one float a lane and element. Halving each
//     warp's chain of products halves a q tile's walk where the grid gives
//     an SM one CTA (a 256-token prefill), and halves the registers that
//     hold acc (D 256). With kSplit = 1 a warp takes the whole step, with no
//     exchange. The arithmetic is the same: a row's max over both halves,
//     its sum as the sum of half 0's (a thread's values, two quad shuffles)
//     plus half 1's, so the two give the same bits. m and l live in
//     registers; the two warps of a pair sit on different SM sub-partitions.
//   * P reaches the A operand of P.V without shuffles: the TF32 accumulator
//     layout gives thread (g, t) keys 2t and 2t + 1 of each 8-key block, and
//     the A layout wants k-indices t and t + 4. A sum over keys can take them
//     in any order, so k-index t is key 2t and k-index t + 4 is key 2t + 1 of
//     the block, and V's B fragment is read from the same two key rows.
//     Likewise Q.K^T takes each 16-dim group of d so that a thread reads four
//     consecutive floats (one 16-byte shared load for two k-steps), and P.V
//     assigns the 8 columns of four n-tiles so that a thread reads four
//     consecutive dims of a V row and owns 8 consecutive output dims.
//     Consecutive MMAs go to different accumulators.
//   * K and V are staged asynchronously with 16-byte cp.async copies into a
//     ring of kStages stages, K and V of a stage in separate commit groups:
//     V(i) lands while S(i) is computed, K(i + kStages) while P.V(i) is. Two
//     stages where two CTAs an SM still fit in shared memory (D 64 in
//     float32, D <= 128 in bf16), one stage otherwise (float32 D 128, and D
//     256, where a 64-row CTA's float32 Q, K and V alone take 201 KB). Rows
//     are padded to keep 16-byte alignment and conflict-free fragment loads:
//     Q and K by 16 elements, V by 16 bytes.
//     Inputs whose pointers or strides are not 16-byte aligned (or D not a
//     multiple of 16 bytes) are staged element by element instead: the same
//     tiles, the same bits.
//   * Launch: grid (ceil(Sq / kRows), Hq, B). The flash kernel takes 32-row
//     CTAs of two pairs (128 threads): 128 CTAs at OLMo-1B's 256-token
//     prefill, where one q tile's walk over its KV tiles is the whole time.
//     The banded and chunked kernels take 64-row CTAs, which stage each K/V
//     tile once for twice the rows: four single warps (128 threads, two CTAs
//     an SM, no exchange) up to D 128, where they run faster than pairs on
//     the H100, and four pairs (256 threads) at D 256, where single warps
//     would hold 128 accumulator registers each and spill. The q tile's
//     size and kSplit change only which dead tiles are skipped, which
//     changes no bit.
//   * GQA reads kv head h / G; K and V are never repeated. Tensors are read and
//     written in the model layout [B, S, H, D] through their strides (the last
//     stride must be 1). Masks come from the qpos / kpos tensors only (and,
//     for block-sparse attention, the caller's block mask); ragged tiles are
//     masked by bounds and zero-filled.
//   * A KV tile in which no (query, key) pair of the CTA can be visible is
//     skipped: such a tile would leave every row's (m, l, acc) exactly
//     unchanged (alpha = exp(0) = 1, p = 0), so skipping it changes no bit.
//     Every warp finds the next live tile itself (the same answer in each),
//     so the loads of a tile are issued before the tile ahead is folded.
//
// Each row's arithmetic depends only on the row, the K/V values and the
// positions, never on the other rows of its tile, and nothing is summed with
// atomics: a result repeats bit for bit, and two kernels that run the same
// live tiles in the same order give the same bits.
// ---------------------------------------------------------------------------

constexpr int kBK = 64;                        // keys of a KV tile (one softmax step)
constexpr int kFlashRows = 32;                 // q rows of a flash CTA
constexpr int kBandRows = 64;                  // q rows of a banded or chunked CTA
constexpr size_t kTwoCtaSmem = 113 * 1024;     // half of an SM's 228 KB, less 1 KB a CTA
// a warp's exchange rows, one float a lane each: its 16 p values, then the
// row maxima and the row sums of its rows rA and rB
constexpr int kXRows = 16 + 4;

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
  // set by dispatch_flash: q, k and v stage with 16-byte copies
  int vec;
};

// The CTA of the DMAX instance for inputs of type T, kRows q rows and
// kSplit warps for each 16 rows (2: a pair splitting each 64-key step; 1: a
// warp taking it whole): its warps and its shared memory: the q tile, the
// pairs' exchange (each warp's p block, row maxima and row sums), then
// kStages stages of (K tile, V tile, the K tile's positions).
template <int DMAX, typename T, int kRows, int kSplit>
struct FlashLayout {
  static constexpr int kWarps = kRows / 16 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int LDK = DMAX + 16;                     // Q and K rows, elements
  static constexpr int LDV = DMAX + 16 / (int)sizeof(T);    // V rows, elements
  static constexpr size_t kQ = (size_t)kRows * LDK * sizeof(T);
  static constexpr size_t kX = kSplit == 2 ? (size_t)kWarps * kXRows * 32 * sizeof(float) : 0;
  static constexpr size_t kK = (size_t)kBK * LDK * sizeof(T);
  static constexpr size_t kV = (size_t)kBK * LDV * sizeof(T);
  static constexpr size_t kP = kBK * sizeof(int);
  static constexpr int kStages = kQ + kX + 2 * (kK + kV + kP) <= kTwoCtaSmem ? 2 : 1;
  static constexpr size_t kBytes = kQ + kX + kStages * (kK + kV + kP);
};

// The conservative band predicate of a (q tile, KV tile) cell from the
// tiles' position extremes (repro's `_band_live`): false only where no pair
// of the cell can be visible.
__device__ __forceinline__ bool band_live(const FlashArgs& a, int qmin, int qmax, int kmin,
                                          int kmax) {
  return (!a.causal || qmax >= kmin) && (a.window == 0 || (int64_t)qmin - kmax < a.window);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros where
// !full (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements of a shared-memory row as float32.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// The split of a float32 operand into TF32 parts: hi = rna(x), lo = rna(x -
// hi), rna = round to TF32 (10 mantissa bits) to nearest, ties away from
// zero: add half a TF32 ulp to the magnitude's bits and clear the 13 low
// bits, as cvt.rna.tf32.f32 rounds a finite x. kLo false (a bfloat16
// operand, exact in TF32): hi = x, and lo is unused.
template <bool kLo>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kLo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// d += a.b, one m16n8k8 TF32 tensor-core product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Wait for the two warps of pair `pair` (named barrier 1 + pair).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

template <int DMAX, typename T, int kRows, int kSplit>
struct FlashCta {
  using L = FlashLayout<DMAX, T, kRows, kSplit>;
  static constexpr int kRowsCta = kRows;
  static constexpr bool kF32 = sizeof(T) == 4;  // operands with a lo part
  static constexpr int kS = L::kStages;
  static constexpr int kE = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  static constexpr int NJ = 8 / kSplit;            // n-tiles (8 keys each) of a warp's scores
  static constexpr int DH = DMAX / kSplit;         // head dims of a warp's P.V
  static constexpr int NQ = DH / 32;               // its groups of four n-tiles
  static constexpr int QG = NQ < 2 ? NQ : 2;       // groups whose V fragments are held at once
  static_assert(DH % 32 == 0, "a warp's dims are whole groups of four n-tiles");

  T* Qs;       // [kRows][LDK]
  float* Xs;   // [kWarps][kXRows][32]
  T* Ks;       // [kS][kBK][LDK]
  T* Vs;       // [kS][kBK][LDV]
  int* kp_s;   // [kS][kBK]
  int warp, pair, half, g, t, rA, rB;  // rows rA = 16 pair + g, rB = rA + 8; half < kSplit
  int q0, h, b, nrows;
  int qmin, qmax;  // positions of the CTA's real rows
  int qpA, qpB;    // positions of rows rA, rB
  int64_t row0;    // carry row of query row q0 in [B, Hq, Sq]
  const T* k;
  const T* v;
  float mA, mB, lA, lB;  // the carry of rows rA, rB (the same in both warps of the pair)
  // acc: n-tile 4 j + e holds dims DH half + 32 j + 8 t + e (0, 2) and + 4
  // (1, 3) of rows rA (0, 1) and rB (2, 3)
  float o[DH / 8][4];

  __device__ __forceinline__ FlashCta(const FlashArgs& a, unsigned char* smem) {
    Qs = reinterpret_cast<T*>(smem);
    Xs = reinterpret_cast<float*>(smem + L::kQ);
    Ks = reinterpret_cast<T*>(smem + L::kQ + L::kX);
    Vs = reinterpret_cast<T*>(smem + L::kQ + L::kX + kS * L::kK);
    kp_s = reinterpret_cast<int*>(smem + L::kQ + L::kX + kS * (L::kK + L::kV));
    const int lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    pair = warp / kSplit;
    half = warp % kSplit;  // the pair's warps sit on different SM sub-partitions
    g = lane / 4;
    t = lane % 4;
    rA = 16 * pair + g;
    rB = rA + 8;
    q0 = blockIdx.x * kRows;
    h = blockIdx.y;
    b = blockIdx.z;
    nrows = min(kRows, a.Sq - q0);
    row0 = ((int64_t)b * a.Hq + h) * a.Sq + q0;
    const int hk = h / (a.Hq / a.Hkv);
    k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  }

  // Rows [0, n) of a tile of kTile rows (row r at src + r * stride) into
  // shared memory with row pitch ld; zeros past row n and past dim D.
  template <int kTile>
  __device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, long long stride,
                                             int n, const FlashArgs& a) const {
    if (a.vec) {
      constexpr int C = DMAX / kE;
      for (int i = threadIdx.x; i < kTile * C; i += L::kThreads) {
        const int r = i / C, c = (i % C) * kE;
        const bool in = r < n && c < a.D;
        cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, in);
      }
    } else {
      for (int i = threadIdx.x; i < kTile * DMAX; i += L::kThreads) {
        const int r = i / DMAX, c = i % DMAX;
        const bool in = r < n && c < a.D;
        if constexpr (kF32)
          cp_async4(dst + r * ld + c, in ? src + r * stride + c : src, in);
        else  // no 2-byte cp.async: a plain copy
          dst[r * ld + c] = in ? src[r * stride + c] : T{};
      }
    }
  }

  // Dim of acc element (n-tile 4 j + (i % 4), row half i / 4 of the pair of
  // columns) for i < 8: 8 consecutive dims a thread.
  __device__ __forceinline__ int dim(int j, int i) const { return DH * half + 32 * j + 8 * t + i; }
  __device__ __forceinline__ float& acc(int j, int i, int row) {
    return o[4 * j + (i & 3)][2 * row + (i >> 2)];
  }
  __device__ __forceinline__ float acc(int j, int i, int row) const {
    return o[4 * j + (i & 3)][2 * row + (i >> 2)];
  }

  // Stage the q tile (its own commit group, ahead of every K/V group), take
  // the rows' positions and set the carry: from a.m, a.l, a.acc when
  // `resume`, else the neutral (-1e30, 0, 0).
  __device__ __forceinline__ void begin(const FlashArgs& a, bool resume) {
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    stage_rows<kRows>(Qs, L::LDK, q + (int64_t)q0 * a.q_ss, a.q_ss, nrows, a);
    cp_async_commit();
    qpA = rA < nrows ? a.qpos[q0 + rA] : 0;
    qpB = rB < nrows ? a.qpos[q0 + rB] : 0;
    const int lane = threadIdx.x % 32;
    qmin = INT_MAX;
    qmax = INT_MIN;
    for (int r = lane; r < nrows; r += 32) {
      const int p = a.qpos[q0 + r];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, s));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, s));
    }
    const bool inA = resume && rA < nrows, inB = resume && rB < nrows;
    mA = inA ? a.m[row0 + rA] : kNegInf;
    lA = inA ? a.l[row0 + rA] : 0.f;
    mB = inB ? a.m[row0 + rB] : kNegInf;
    lB = inB ? a.l[row0 + rB] : 0.f;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          const bool in = (row ? inB : inA) && dim(j, i) < a.D;
          acc(j, i, row) = in ? a.acc[(row0 + (row ? rB : rA)) * a.D + dim(j, i)] : 0.f;
        }
  }

  // Whether the caller's block mask enables element (row r, key).
  __device__ __forceinline__ bool cell_on(const FlashArgs& a, int r, int key) const {
    return a.mask[(int64_t)((q0 + r) / a.mask_bq) * a.mask_nk + key / a.mask_bk] != 0;
  }

  // Whether KV tile `tile` can hold a visible pair for the CTA: the band
  // predicate and, with kMask, whether any mask cell the tile covers is on.
  // Each warp computes it whole (the same answer in every warp).
  template <bool kMask>
  __device__ __forceinline__ bool tile_live(const FlashArgs& a, int tile) const {
    const int lane = threadIdx.x % 32, k0 = tile * kBK, ncols = min(kBK, a.Skv - k0);
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int c = lane; c < ncols; c += 32) {
      const int p = a.kpos[k0 + c];
      kmin = min(kmin, p);
      kmax = max(kmax, p);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, s));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, s));
    }
    bool live = band_live(a, qmin, qmax, kmin, kmax);
    if (kMask && live) {
      const int r0 = q0 / a.mask_bq, r1 = (q0 + nrows - 1) / a.mask_bq;
      const int c0 = k0 / a.mask_bk, c1 = (k0 + ncols - 1) / a.mask_bk;
      const int nc = c1 - c0 + 1, n = (r1 - r0 + 1) * nc;
      bool any = false;
      for (int i = lane; i < n && !any; i += 32)
        any = a.mask[(int64_t)(r0 + i / nc) * a.mask_nk + c0 + i % nc] != 0;
      live = __any_sync(0xffffffffu, any);
    }
    return live;
  }

  // The first live tile in [tile, hi), or -1.
  template <bool kMask>
  __device__ __forceinline__ int next_live(const FlashArgs& a, int tile, int hi) const {
    for (; tile < hi; ++tile)
      if (tile_live<kMask>(a, tile)) return tile;
    return -1;
  }

  // Issue the copies of tile `tile`'s K rows and positions (or V rows) into
  // stage st; nothing for tile -1. The caller commits the group.
  __device__ __forceinline__ void stage_k(const FlashArgs& a, int tile, int st) const {
    if (tile < 0) return;
    const int k0 = tile * kBK, ncols = min(kBK, a.Skv - k0);
    stage_rows<kBK>(Ks + st * kBK * L::LDK, L::LDK, k + (int64_t)k0 * a.k_ss, a.k_ss, ncols, a);
    const int c = threadIdx.x;
    if (c < kBK) cp_async4(kp_s + st * kBK + c, a.kpos + k0 + min(c, ncols - 1), c < ncols);
  }
  __device__ __forceinline__ void stage_v(const FlashArgs& a, int tile, int st) const {
    if (tile < 0) return;
    const int k0 = tile * kBK, ncols = min(kBK, a.Skv - k0);
    stage_rows<kBK>(Vs + st * kBK * L::LDV, L::LDV, v + (int64_t)k0 * a.v_ss, a.v_ss, ncols, a);
  }

  // This warp's scores of the tile at k0 in stage st (keys kOff + 8 j + 2t,
  // + 1 in s[j]), masked, and the online-softmax step: s becomes p, m and
  // alpha are taken, and l is updated by the row sums of the tile's two
  // 32-key halves (half 0's first). A pair exchanges its row maxima, and
  // hands its p block and row sums to pv() through its exchange rows.
  template <bool kMask>
  __device__ __forceinline__ void scores(const FlashArgs& a, int k0, int st,
                                         float (&s)[NJ][4], float& alA, float& alB) {
    const int kOff = (kBK / kSplit) * half;
    const T* Kst = Ks + st * kBK * L::LDK + kOff * L::LDK;
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int dg = 0; dg < DMAX / 16; ++dg) {  // 16 dims: two k-steps
      const float4 qa = lds4(Qs + rA * L::LDK + 16 * dg + 4 * t);
      const float4 qb = lds4(Qs + rB * L::LDK + 16 * dg + 4 * t);
      uint32_t ah[2][4], al[2][4];
      split<kF32>(qa.x, ah[0][0], al[0][0]);  // k-step 0: k-index t is dim 4t, t + 4 is 4t + 1
      split<kF32>(qb.x, ah[0][1], al[0][1]);
      split<kF32>(qa.y, ah[0][2], al[0][2]);
      split<kF32>(qb.y, ah[0][3], al[0][3]);
      split<kF32>(qa.z, ah[1][0], al[1][0]);  // k-step 1: dims 4t + 2 and 4t + 3
      split<kF32>(qb.z, ah[1][1], al[1][1]);
      split<kF32>(qa.w, ah[1][2], al[1][2]);
      split<kF32>(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += 4) {  // four n-tiles at a time
        uint32_t kh[4][4], kl[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // n-tile j0 + j: keys kOff + 8 (j0 + j) .. + 7
          const float4 kv = lds4(Kst + (8 * (j0 + j) + g) * L::LDK + 16 * dg + 4 * t);
          split<kF32>(kv.x, kh[j][0], kl[j][0]);
          split<kF32>(kv.y, kh[j][1], kl[j][1]);
          split<kF32>(kv.z, kh[j][2], kl[j][2]);
          split<kF32>(kv.w, kh[j][3], kl[j][3]);
        }
        // the group's six products sum on the tensor cores from zero and
        // join s in float32 adds (see pv())
        float sa[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {  // per accumulator and k-step: lo.hi, hi.lo, hi.hi
          if (kF32) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t bh[2] = {kh[j][2 * ks], kh[j][2 * ks + 1]};
              mma_tf32(sa[j], al[ks], bh);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t bl[2] = {kl[j][2 * ks], kl[j][2 * ks + 1]};
              mma_tf32(sa[j], ah[ks], bl);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t bh[2] = {kh[j][2 * ks], kh[j][2 * ks + 1]};
            mma_tf32(sa[j], ah[ks], bh);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j0 + j][i] += sa[j][i];
      }
    }

    // s[j]: row rA keys kOff + 8j + 2t, + 1 (0, 1), row rB the same (2, 3)
    const int ncols = min(kBK, a.Skv - k0);
    const int* kp = kp_s + st * kBK + kOff;
    uint32_t ok = 0;  // bit 4j + i: element s[j][i] is visible
    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int2 kk = *reinterpret_cast<const int2*>(kp + 8 * j + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = kOff + 8 * j + 2 * t + (i & 1), r = i < 2 ? rA : rB;
        float x = s[j][i] * a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x * a.inv_softcap);
        const bool vis = c < ncols && visible(i < 2 ? qpA : qpB, (i & 1) ? kk.y : kk.x,
                                              a.causal, a.window) &&
                         (!kMask || (r < nrows && cell_on(a, r, k0 + c)));
        ok |= (uint32_t)vis << (4 * j + i);
        s[j][i] = vis ? x : kNegInf;
      }
      mxA = fmaxf(mxA, fmaxf(s[j][0], s[j][1]));
      mxB = fmaxf(mxB, fmaxf(s[j][2], s[j][3]));
    }
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
    const int lane = threadIdx.x % 32;
    float* mine = Xs + warp * kXRows * 32 + lane;
    if constexpr (kSplit == 2) {
      const float* theirs = Xs + (warp ^ 1) * kXRows * 32 + lane;
      mine[16 * 32] = mxA;
      mine[17 * 32] = mxB;
      pair_sync(pair);
      // the row max over both halves, taken in one order in both warps
      const float oA = theirs[16 * 32], oB = theirs[17 * 32];
      mxA = half ? fmaxf(oA, mxA) : fmaxf(mxA, oA);
      mxB = half ? fmaxf(oB, mxB) : fmaxf(mxB, oB);
    }
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    alA = expf(fminf(mA - mnA, 0.f));
    alB = expf(fminf(mB - mnB, 0.f));
    mA = mnA;
    mB = mnB;
    float sumA[2] = {0.f, 0.f}, sumB[2] = {0.f, 0.f};  // by 32-key half of the warp's keys
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (ok >> (4 * j + i)) & 1u ? expf(s[j][i] - (i < 2 ? mnA : mnB)) : 0.f;
        s[j][i] = p;
        if constexpr (kSplit == 2) mine[(4 * j + i) * 32] = p;
        if (i < 2)
          sumA[j / 4] += p;
        else
          sumB[j / 4] += p;
      }
    }
#pragma unroll
    for (int hk = 0; hk < 2 / kSplit; ++hk) {
      sumA[hk] += __shfl_xor_sync(0xffffffffu, sumA[hk], 1);
      sumA[hk] += __shfl_xor_sync(0xffffffffu, sumA[hk], 2);
      sumB[hk] += __shfl_xor_sync(0xffffffffu, sumB[hk], 1);
      sumB[hk] += __shfl_xor_sync(0xffffffffu, sumB[hk], 2);
    }
    if constexpr (kSplit == 2) {
      mine[18 * 32] = sumA[0];
      mine[19 * 32] = sumB[0];
    } else {
      lA = fmaf(lA, alA, sumA[0] + sumA[1]);
      lB = fmaf(lB, alB, sumB[0] + sumB[1]);
    }
  }

  // After a CTA barrier: acc = acc * alpha + P.V over the V tile in stage st
  // for this warp's dims (and, in a pair, l += both halves' sums, half 0's
  // first), p of the warp's own keys from s and of the partner's from its
  // exchange rows.
  // The tile's P.V sums on the tensor cores from zero, a group of n-tiles at
  // a time, and joins acc in one float32 FMA (the tensor cores' adds do not
  // round to nearest: a long chain of them into acc drifts).
  __device__ __forceinline__ void pv(int st, const float (&s)[NJ][4], float alA, float alB) {
    const int lane = threadIdx.x % 32;
    const float* mine = Xs + warp * kXRows * 32 + lane;
    const float* theirs = Xs + (warp ^ 1) * kXRows * 32 + lane;
    if constexpr (kSplit == 2) {
      const float s0A = half ? theirs[18 * 32] : mine[18 * 32];
      const float s1A = half ? mine[18 * 32] : theirs[18 * 32];
      const float s0B = half ? theirs[19 * 32] : mine[19 * 32];
      const float s1B = half ? mine[19 * 32] : theirs[19 * 32];
      lA = fmaf(lA, alA, s0A + s1A);
      lB = fmaf(lB, alB, s0B + s1B);
    }
    const T* Vst = Vs + st * kBK * L::LDV + DH * half;
#pragma unroll
    for (int j0 = 0; j0 < NQ; j0 += QG) {  // n-tiles 4j .. 4j + 3: dims DH half + 32 j + 4 g + e
      float pt[4 * QG][4] = {};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // keys 8 kk ..: k-index t is key 2t, t + 4 is 2t + 1
        float p[4];
        if (kSplit == 1 || (kk >> 2) == half) {
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = s[kk % NJ][i];
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = theirs[(4 * (kk & 3) + i) * 32];
        }
        uint32_t ah[4], al[4];
        split<true>(p[0], ah[0], al[0]);
        split<true>(p[2], ah[1], al[1]);
        split<true>(p[1], ah[2], al[2]);
        split<true>(p[3], ah[3], al[3]);
        const T* v0 = Vst + (8 * kk + 2 * t) * L::LDV + 4 * g;
        uint32_t bh[4 * QG][2], bl[4 * QG][2];
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          const float4 x0 = lds4(v0 + 32 * (j0 + j)), x1 = lds4(v0 + L::LDV + 32 * (j0 + j));
          const float e0[4] = {x0.x, x0.y, x0.z, x0.w}, e1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split<kF32>(e0[e], bh[4 * j + e][0], bl[4 * j + e][0]);
            split<kF32>(e1[e], bh[4 * j + e][1], bl[4 * j + e][1]);
          }
        }
        // per accumulator and k-step: lo.hi, hi.lo, hi.hi
#pragma unroll
        for (int n = 0; n < 4 * QG; ++n) mma_tf32(pt[n], al, bh[n]);
        if (kF32) {
#pragma unroll
          for (int n = 0; n < 4 * QG; ++n) mma_tf32(pt[n], ah, bl[n]);
        }
#pragma unroll
        for (int n = 0; n < 4 * QG; ++n) mma_tf32(pt[n], ah, bh[n]);
      }
#pragma unroll
      for (int n = 0; n < 4 * QG; ++n) {
        float(&acc)[4] = o[4 * j0 + n];
        acc[0] = fmaf(acc[0], alA, pt[n][0]);
        acc[1] = fmaf(acc[1], alA, pt[n][1]);
        acc[2] = fmaf(acc[2], alB, pt[n][2]);
        acc[3] = fmaf(acc[3], alB, pt[n][3]);
      }
    }
  }

  // Fold the live tiles of [lo, hi) in order: K and V of tile i + kS are in
  // flight while tile i is folded (commit groups K(i), V(i), K(i + 1), ...).
  template <bool kMask>
  __device__ __forceinline__ void run(const FlashArgs& a, int lo, int hi) {
    int load = next_live<kMask>(a, lo, hi);
    int in0 = -1, in1 = -1;  // the tile staged in stage 0, 1
#pragma unroll
    for (int st = 0; st < kS; ++st) {
      stage_k(a, load, st);
      cp_async_commit();
      stage_v(a, load, st);
      cp_async_commit();
      (st == 0 ? in0 : in1) = load;
      if (load >= 0) load = next_live<kMask>(a, load + 1, hi);
    }
    float s[NJ][4], alA, alB;
    for (int st = 0;; st = st + 1 == kS ? 0 : st + 1) {
      const int tile = st == 0 ? in0 : in1;
      if (tile < 0) break;
      cp_async_wait<2 * kS - 1>();  // K(tile) (and the q tile) landed
      __syncthreads();              // (and the partner read the last exchange)
      scores<kMask>(a, tile * kBK, st, s, alA, alB);
      cp_async_wait<2 * kS - 2>();  // V(tile) landed
      __syncthreads();              // every warp is done with this stage's K; p exchanged
      stage_k(a, load, st);
      cp_async_commit();
      pv(st, s, alA, alB);
      __syncthreads();  // every warp is done with this stage's V
      stage_v(a, load, st);
      cp_async_commit();
      (st == 0 ? in0 : in1) = load;
      if (load >= 0) load = next_live<kMask>(a, load + 1, hi);
    }
    cp_async_wait<0>();
  }

  // out = acc / max(l, 1e-30) in the output's type; a row with no visible
  // key gives 0.
  __device__ __forceinline__ void write_out(const FlashArgs& a) const {
    T* out = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int r = row ? rB : rA;
      if (r >= nrows) continue;
      const float l = fmaxf(row ? lB : lA, 1e-30f);
      T* dst = out + (int64_t)(q0 + r) * a.o_ss;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (dim(j, i) < a.D) store(dst + dim(j, i), acc(j, i, row) / l);
    }
  }

  // The carry (m, l, acc) back to a.m, a.l, a.acc, unnormalised.
  __device__ __forceinline__ void write_carry(const FlashArgs& a) const {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int r = row ? rB : rA;
      if (r >= nrows) continue;
      if (half == 0 && t == 0) {
        a.m[row0 + r] = row ? mB : mA;
        a.l[row0 + r] = row ? lB : lA;
      }
      float* dst = a.acc + (row0 + r) * a.D;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (dim(j, i) < a.D) dst[dim(j, i)] = acc(j, i, row);
    }
  }
};

// The flash kernel's tile program, and the banded and chunked kernels'.
template <int DMAX, typename T>
using FlashTile = FlashCta<DMAX, T, kFlashRows, 2>;
template <int DMAX, typename T>
using BandTile = FlashCta<DMAX, T, kBandRows, DMAX >= 256 ? 2 : 1>;

// Launch `kernel` on the (q tiles, Hq, B) grid with tile program Cta's
// threads and dynamic shared memory.
template <class Cta>
cudaError_t launch_flash_grid(void (*kernel)(FlashArgs), const FlashArgs& a, int B,
                              cudaStream_t stream) {
  using L = typename Cta::L;
  constexpr int kRows = Cta::kRowsCta;
  const int smem = (int)L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.Hq, B);
  kernel<<<grid, L::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Whether q, k and v can stage with 16-byte copies: every pointer and stride
// (and D) a whole number of 16 bytes.
template <typename T>
bool flash_vec(const FlashArgs& a) {
  const long long e = 16 / sizeof(T);
  auto ok = [e](const void* p, long long sb, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % e == 0 && ss % e == 0 && sh % e == 0;
  };
  return a.D % e == 0 && ok(a.q, a.q_sb, a.q_ss, a.q_sh) && ok(a.k, a.k_sb, a.k_ss, a.k_sh) &&
         ok(a.v, a.v_sb, a.v_ss, a.v_sh);
}

// Pick the smallest DMAX instance that holds the head dim, for input type T:
// Launch<DMAX, T>::run(a, B, stream).
template <template <int, typename> class Launch, typename T>
cudaError_t dispatch_typed(FlashArgs a, int B, cudaStream_t stream) {
  a.vec = flash_vec<T>(a);
  if (a.D <= 64) return Launch<64, T>::run(a, B, stream);
  if (a.D <= 128) return Launch<128, T>::run(a, B, stream);
  if (a.D <= 256) return Launch<256, T>::run(a, B, stream);
  return cudaErrorInvalidValue;
}

template <template <int, typename> class Launch>
cudaError_t dispatch_flash(const FlashArgs& a, int B, int bf16, cudaStream_t stream) {
  return bf16 ? dispatch_typed<Launch, __nv_bfloat16>(a, B, stream)
              : dispatch_typed<Launch, float>(a, B, stream);
}

}  // namespace chef

extern "C" const char* chef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
