// Device code of the LR-head reductions over many rows: minibatch_grad and
// replay_correction over gathered rows x_i = Xa[idx[i]], and lr_grad and
// lr_hvp over every row of Xa (x_i = Xa[i]: no ids, idx is null). Each
// computes
//
//     out[c, d] = (1/denom) * sum_i r[i, c] * x_i[d]  (+ l2 * base[c, d])
//
// with r[i] the residual of row i over the C classes, from one softmax
// p = softmax(x_i.w^T):
//   kGrad  r = (p - Y[src]) * g[src]                   (minibatch_grad; lr_grad, idx null)
//   kCorr  r = (p - Y_new[src]) * (g_new[src] * m[i]) - (p - Y[src]) * (g[src] * m[i])
//                                                                   (replay_correction)
//   kHvp   r = (p*u - p*(p.u)) * g[i], u = x_i.v^T                  (lr_hvp; base = v)
//
// What bounds it on the H100. With C <= 16 the work is C flops per byte of
// row (kHvp: 3C), under the float32 CUDA cores' ridge (about 20 flops a
// byte), so no tensor cores: a call is bound by device-memory bytes (one
// read of the rows) where it has many rows, and by latency (the launch, the
// id load, one row load) where it has few. The three-pass code these kernels
// ran before launched three kernels a call, read each row twice, passed a
// partial sum through device memory and walked each row in a warp's serial
// chain of loads. Here a call is one launch, and each row is read once from
// device memory:
//
// many_rows  a cooperative launch of G CTAs, G from the shapes and the SM
//            count (kernels/common.py: gather_plan), at most kCtasPerSm on an
//            SM. CTA b owns the contiguous slots [b n / G, (b + 1) n / G) and
//            every column. Its rows stream through a ring of kStages groups
//            of R rows in shared memory (R = kRowGroup; kHvp: many_group),
//            copied with cp.async, so that kStages - 1 groups are in flight
//            while one computes; the copies go out as
//            soon as the ids are in, which are loaded a group ahead. Thread t
//            takes columns t + k kThreads (k < many_blocks(C, MODE)) of each
//            row, and holds those of w (kHvp: and of v) and of its [C, k]
//            accumulators in registers: partial logits per thread (kHvp: and
//            partial u), warp sums (kHvp: one transpose reduction), every
//            warp adds the warps' sums in warp order and forms softmax and
//            residual, then acc += r x. The CTA's [C, D]
//            partial goes to scratch; after a grid barrier (cooperative
//            groups) each CTA sums a slice of columns over the G partials in
//            CTA order, divides by denom and adds l2 base. No float atomics,
//            no counters to reset. Where D needs more than many_blocks(C,
//            MODE) column blocks (at D 2049: kHvp at C >= 3, kGrad and kCorr
//            at C >= 4), a CTA takes rows_wide: up to kWideRows rows at once
//            in shared memory, w (kHvp: and v) read once for them from L2
//            and the partial in scratch read and written once for them; past
//            kWideFloats, one row at a time (rows_streamed): the logits
//            stream the row and w through L1, and r x is added into the
//            partial in scratch, reading the row a second time (from L1 or
//            L2).
// few_rows   kGrad and kCorr with n_rows <= few_slots(C) and (n_rows + C) D
//            <= kFewMaxFloats: one CTA per block of kThreads columns, no
//            scratch, no barrier. Each CTA copies every slot's row and w into
//            shared memory, every copy issued at once (one memory round trip
//            after the ids; the other CTAs find the rows in L2), computes the
//            logits with all its threads and writes out[c, d] for its own
//            columns, summing the slots in order. lr_hvp always takes
//            many_rows: its N rows are the whole training set.
//
// Every sum runs in an order fixed by the shapes and the SM count, so
// sgd_train, deltagrad_replay, the CG solve and a restored session repeat
// bit for bit. Odd D: at D = 2049 a row after the first starts 4-byte
// aligned only, so neither 16-byte copies nor TMA bulk copies (16-byte
// addresses and sizes) take a whole row; copy_row shifts each row in shared
// memory so that both sides of its 16-byte cp.async copies are aligned.
#pragma once

#include <cooperative_groups.h>

#include "lr_common.cuh"

namespace chef {
namespace gather {

constexpr int kThreads = 256;    // threads of a CTA, in both kernels (kernels/common.py)
constexpr int kWarps = kThreads / kWarp;
constexpr int kCtasPerSm = 2;    // many_rows: CTAs an SM holds at once (kernels/common.py)
constexpr int kRowGroup = 2;     // many_rows, kGrad and kCorr: rows a CTA takes at once
constexpr int kHvpRowGroup = 4;  // many_rows, kHvp: rows a CTA takes at once, at most
constexpr int kStages = 2;       // many_rows: groups of rows in shared memory at once
constexpr int kMaxBlocks = 9;    // column blocks a thread holds in registers: D <= 2304
constexpr int kTerms = 5;        // a row's RowTerms
constexpr int kFewMaxFloats = 40960;  // few_rows: its shared memory at most (kernels/common.py)
constexpr int kFewMaxRows = 6;   // few_rows: slots at most, where many_rows overtakes it
constexpr int kSumLoads = 32;    // many_rows: partials a thread of the final sum loads at most
constexpr int kWideRows = 8;     // rows_wide: rows a CTA takes at once, at most
constexpr int kWideFloats = 20480;  // rows_wide: floats of its rows in shared memory at most
constexpr int kWideClasses = 4;  // rows_wide: classes a thread sums logits of at once

// Slots the few-rows kernel takes: a warp holds one lane per slot and class,
// and past kFewMaxRows slots the many-rows grid is faster (at C 2 on the
// H100: chip_smoke.py's regime comparison) (kernels/common.py: few_slots).
__host__ __device__ constexpr int few_slots(int C) {
  return 32 / C < kFewMaxRows ? 32 / C : kFewMaxRows;
}
// Column blocks a many-rows thread holds in registers: w and the accumulators
// take 2 C k of them (kHvp: w, v and the accumulators 3 C k, the row re-read
// from shared memory rather than held), within the 128 registers a thread has
// at kCtasPerSm CTAs an SM (kernels/common.py: many_blocks).
__host__ __device__ constexpr int many_blocks(int C, int mode) {
  return mode == kHvp ? (18 / C < kMaxBlocks ? 18 / C : kMaxBlocks)
                      : (32 / C < kMaxBlocks ? 32 / C : kMaxBlocks);
}
// Rows of a group: a lane forms each (row, class) residual, so at most 32 / C.
__host__ __device__ constexpr int many_group(int C, int mode) {
  return mode == kHvp ? (32 / C < kHvpRowGroup ? 32 / C : kHvpRowGroup) : kRowGroup;
}
// Floats of a row of n floats in shared memory: rounded up to 16 bytes, and
// 16 bytes more for copy_row's shift.
__host__ __device__ constexpr int row_pitch(int n) { return (n + 3) / 4 * 4 + 4; }
// Floats of rows_staged's ring in shared memory: kStages groups of
// many_group(C, mode) rows of many_blocks(C, mode) kThreads columns, their
// terms and their shifts.
__host__ __device__ constexpr int ring_floats(int C, int mode) {
  return kStages * (many_group(C, mode) * row_pitch(many_blocks(C, mode) * kThreads) +
                    kTerms * kWarp + many_group(C, mode));
}
// rows_wide: rows of D floats a CTA takes at once (0: D too wide), and the
// floats of shared memory it takes: the rows, the warps' sums of z and u
// (kHvp) for each (row, class), and the residuals.
__host__ __device__ constexpr int wide_rows(int D) {
  return kWideFloats / row_pitch(D) < kWideRows ? kWideFloats / row_pitch(D) : kWideRows;
}
__host__ __device__ constexpr int wide_floats(int C, int D) {
  return wide_rows(D) * row_pitch(D) + (2 * kWarps + 1) * kWideRows * C;
}
// The most dynamic shared memory a many-rows kernel takes, in floats.
__host__ __device__ constexpr int many_smem_floats(int C, int mode) {
  return kWideFloats + (2 * kWarps + 1) * kWideRows * C > ring_floats(C, mode)
             ? kWideFloats + (2 * kWarps + 1) * kWideRows * C
             : ring_floats(C, mode);
}
// The many-rows path a call takes: rows_staged where a thread's registers
// hold its columns, else rows_wide where its rows fit shared memory, else
// rows_streamed.
enum Path { kStaged = 0, kWide = 1, kStreamed = 2 };
__host__ __device__ constexpr int many_path(int C, int mode, int D) {
  return D <= many_blocks(C, mode) * kThreads ? kStaged
         : wide_rows(D) >= 1                  ? kWide
                                              : kStreamed;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// One float from device memory to shared memory, asynchronously (zero where
// !full: src is then only a valid address).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0));
}
// 16 bytes from device memory to shared memory, asynchronously, past L1
// (zero past the first `bytes`); both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
// A row of n floats at src into shared memory at dst (16-byte aligned,
// row_pitch(n) floats) in 16-byte copies, chunk q by thread q % kThreads:
// element i lands at dst[i + shift], shift = src's offset from 16-byte
// alignment in floats (returned), so that both sides of every copy are
// aligned; zero past n. The first chunk may read up to 12 bytes before src,
// inside the same tensor (its storage is 16-byte aligned).
__device__ __forceinline__ int copy_row(float* dst, const float* src, int n, int t) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2 & 3);
  const float* base = src - shift;
  const int chunks = (n + shift + 3) / 4;
  for (int q = t; q < chunks; q += kThreads) {
    copy16(dst + 4 * q, base + 4 * q, 4 * min(4, n + shift - 4 * q));
  }
  return shift;
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float* Xa;      // [N, D]
  const int64_t* idx;   // [n_rows] row ids in [0, N); null (kHvp, lr_grad): row i is slot i
  const float* w;       // [C, D], the weights of the logits
  const float* v;       // kHvp: [C, D], the vector H(w) multiplies
  const float* Y;       // [N, C] labels (kCorr: before cleaning)
  const float* g;       // [N] sample weights (kCorr: before cleaning)
  const float* Y_new;   // kCorr: [N, C] labels after cleaning
  const float* g_new;   // kCorr: [N] weights after cleaning
  const float* mask;    // kCorr: [n_rows], 0 on a padded slot
  const float* base;    // [C, D], or nullptr for no l2 term (kHvp: v)
  float* partial;       // many_rows: [G, C, D] scratch
  float* out;           // [C, D]
  int D, n_rows;
  float denom, l2;
};

// What the residual of one row and class needs besides its softmax, held by
// the lane that forms it.
struct RowTerms {
  float y, g, y_new, g_new, m;
};

// The row of slot i: idx[i], or i itself where there are no ids (kHvp, lr_grad).
template <int MODE>
__device__ __forceinline__ int64_t row_id(const Args& a, int i) {
  return MODE == kHvp || a.idx == nullptr ? (int64_t)i : a.idx[i];
}

template <int C, int MODE>
__device__ __forceinline__ RowTerms row_terms(const Args& a, int64_t src, int slot, int c) {
  RowTerms s;
  s.y = MODE == kHvp ? 0.f : __ldg(a.Y + src * C + c);
  s.g = __ldg(a.g + src);
  if (MODE == kCorr) {
    s.y_new = __ldg(a.Y_new + src * C + c);
    s.g_new = __ldg(a.g_new + src);
    s.m = __ldg(a.mask + slot);
  } else {
    s.y_new = s.g_new = s.m = 0.f;
  }
  return s;
}

// Each warp's sums of the per-thread partial logits z[j][c] to red[warp][j C + c].
template <int C, int R>
__device__ __forceinline__ void warp_logits(float (&z)[R][C], float (*red)[kWarp], int warp,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v = warp_sum(z[j][c]);
      if (lane == 0) red[warp][j * C + c] = v;
    }
  }
}

// The sums over a warp of the V values a[] each lane holds (V a power of two
// up to 32), by a transpose reduction (V - 1 + (5 - log2 V) shuffles in all,
// not 5 V): at each of the first log2 V steps a lane keeps the half of its
// values that its lane bit picks and adds its partner's copy of that half; a
// butterfly over the remaining lane bits ends it. Returns the sum of value q,
// which the lane ends with (every 32 / V consecutive lanes hold the same).
template <int V>
__device__ __forceinline__ float transpose_sum(float (&a)[V], int lane, int& q) {
  q = 0;
#pragma unroll
  for (int o = kWarp / 2, h = V / 2; o > 0; o >>= 1, h >>= 1) {
    if (h >= 1) {
      const bool hi = lane & o;
      q += hi ? h : 0;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < h) {
          a[i] = (hi ? a[i + h] : a[i]) + __shfl_xor_sync(0xffffffffu, hi ? a[i] : a[i + h], o);
        }
      }
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], o);
    }
  }
  return a[0];
}

// kHvp where 2 R C is a power of two up to 32: each warp's sums of the
// per-thread partial logits z[j][c] and products u[j][c] by one transpose
// reduction. The lane left with value q = 2 (j C + c) + b writes z (b = 0)
// to red[warp][j C + c], or u (b = 1) to redu.
template <int C, int R>
__device__ __forceinline__ void warp_logits_hvp(const float (&z)[R][C], const float (&u)[R][C],
                                                float (*red)[kWarp], float (*redu)[kWarp],
                                                int warp, int lane) {
  constexpr int V = 2 * R * C;
  float a[V];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a[2 * (j * C + c)] = z[j][c];
      a[2 * (j * C + c) + 1] = u[j][c];
    }
  }
  int q;
  const float sum = transpose_sum<V>(a, lane, q);
  if ((lane & (kWarp / V - 1)) == 0) ((q & 1) ? redu : red)[warp][q >> 1] = sum;
}

// The residual of lane l's (row l / C, class l % C) from its logit z (kHvp:
// and its product u): the row's softmax over its C lanes (the float program
// of the three-pass row pass), then r; `s` holds the lane's RowTerms.
template <int C, int MODE>
__device__ __forceinline__ float softmax_residual(float z, float u, int lane, const RowTerms& s) {
  const int first = lane / C * C;  // the row's first lane
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) m = fmaxf(m, __shfl_sync(0xffffffffu, z, first + c));
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) sum += expf(__shfl_sync(0xffffffffu, z, first + c) - m);
  const float p = expf(z - m) / sum;
  if (MODE == kHvp) {
    float pu = 0.f;  // p.u over the row's classes, in class order
#pragma unroll
    for (int c = 0; c < C; ++c) {
      pu += __shfl_sync(0xffffffffu, p, first + c) * __shfl_sync(0xffffffffu, u, first + c);
    }
    return (p * u - p * pu) * s.g;
  }
  return MODE == kGrad ? (p - s.y) * s.g
                       : (p - s.y_new) * (s.g_new * s.m) - (p - s.y) * (s.g * s.m);
}

// After the warps' sums are in red (kHvp: and those of u in redu), every warp
// forms the same residuals: lane l < rows C adds the sums in warp order into
// the logit of row l / C, class l % C (kHvp: and into u), and returns
// softmax_residual. Lanes past rows C return garbage that no one reads.
template <int C, int MODE>
__device__ __forceinline__ float lane_residual(float (*red)[kWarp], float (*redu)[kWarp],
                                               int lane, const RowTerms& s) {
  float z = red[0][lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) z += red[w][lane];
  float u = 0.f;
  if (MODE == kHvp) {
    u = redu[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) u += redu[w][lane];
  }
  return softmax_residual<C, MODE>(z, u, lane, s);
}

// many_rows, D <= many_blocks(C, MODE) column blocks. The CTA's rows pass
// through a ring of kStages slots of many_group(C, MODE) rows in shared
// memory, filled by copy_row (16-byte cp.async; the row's terms by 4-byte
// ones): kStages - 1 groups are in flight while one computes. Each thread takes its columns d = t + k
// kThreads of a group's rows, sums its partial logits with w (kHvp: and u
// with v; registers), and after the residuals (every warp forms them, so one
// barrier a group suffices besides the ring's) adds r x into its
// accumulators (registers); the CTA's partial [C, D] goes to `part`. kGrad
// and kCorr hold the group's columns in registers between the two; kHvp,
// whose w and v take those registers, reads them again from the ring.
template <int C, int MODE>
__device__ __forceinline__ void rows_staged(const Args& a, int i0, int i1, float* part,
                                            float* ring, float (*red)[kWarp],
                                            float (*redu)[kWarp]) {
  constexpr int K = many_blocks(C, MODE), RB = many_group(C, MODE), S = kStages;
  constexpr int P = row_pitch(K * kThreads);
  constexpr bool kHvpMode = MODE == kHvp;
  constexpr int KV = kHvpMode ? K : 1;  // blocks of v held
  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp, D = a.D;
  float* terms = ring + S * RB * P;  // [S][kTerms][kWarp]
  int* shifts = reinterpret_cast<int*>(terms + S * kTerms * kWarp);  // [S][RB], copy_row's
  float wr[C][K], vr[C][KV], acc[C][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = k * kThreads + t;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      wr[c][k] = d < D ? __ldg(a.w + (int64_t)c * D + d) : 0.f;
      if (kHvpMode) vr[c][k % KV] = d < D ? __ldg(a.v + (int64_t)c * D + d) : 0.f;
      acc[c][k] = 0.f;
    }
  }
  const auto ids = [&](int64_t (&src)[RB], int i) {
#pragma unroll
    for (int j = 0; j < RB; ++j) src[j] = i + j < i1 ? row_id<MODE>(a, i + j) : 0;
  };
  // group starting at row i into slot `slot`: the rows (with their shifts),
  // and the terms of warp 0's lane l = j C + c; one commit group, empty past
  // i1
  const auto issue = [&](int slot, const int64_t (&src)[RB], int i) {
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      if (i + j >= i1) break;  // a row past the CTA's is never read
      const int shift = copy_row(ring + (slot * RB + j) * P, a.Xa + src[j] * D, D, t);
      if (t == 0) shifts[slot * RB + j] = shift;
    }
    if (warp == 0 && lane < RB * C) {
      const int j = lane / C, c = lane % C;
      int64_t sj = 0;
#pragma unroll
      for (int u = 0; u < RB; ++u) sj = u == j ? src[u] : sj;  // registers, not a local array
      float* tm = terms + slot * kTerms * kWarp + lane;
      if (i + j < i1) {
        if (!kHvpMode) copy4(tm, a.Y + sj * C + c, true);
        copy4(tm + kWarp, a.g + sj, true);
        if (MODE == kCorr) {
          copy4(tm + 2 * kWarp, a.Y_new + sj * C + c, true);
          copy4(tm + 3 * kWarp, a.g_new + sj, true);
          copy4(tm + 4 * kWarp, a.mask + i + j, true);
        }
      }
    }
    copy_commit();
  };
  const int ng = (i1 - i0 + RB - 1) / RB;
  {
    int64_t pro[S - 1][RB];  // the first groups' ids, loaded together
#pragma unroll
    for (int s = 0; s < S - 1; ++s) ids(pro[s], i0 + s * RB);
#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s, pro[s], i0 + s * RB);
  }
  int64_t next[RB];
  ids(next, i0 + (S - 1) * RB);
  for (int g = 0, slot = 0; g < ng; ++g, slot = slot == S - 1 ? 0 : slot + 1) {
    copy_wait<S - 2>();  // this thread's copies of group g landed
    __syncthreads();     // everyone's; and slot g - 1 is free again
    const int i = i0 + g * RB;
    issue(slot == 0 ? S - 1 : slot - 1, next, i + (S - 1) * RB);
    ids(next, i + S * RB);
    const int rows = min(RB, i1 - i);
    const float* xs[RB];
    float x[RB][K], z[RB][C], u[RB][C];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      xs[j] = ring + (slot * RB + j) * P + (j < rows ? shifts[slot * RB + j] : 0);
#pragma unroll
      for (int c = 0; c < C; ++c) z[j][c] = u[j][c] = 0.f;
    }
    if constexpr (kHvpMode) {  // a column block at a time: one block of the rows in registers
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = k * kThreads + t;
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float xv = j < rows && d < D ? xs[j][d] : 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            z[j][c] = fmaf(xv, wr[c][k], z[j][c]);
            u[j][c] = fmaf(xv, vr[c][k % KV], u[j][c]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < RB; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int d = k * kThreads + t;
          x[j][k] = j < rows && d < D ? xs[j][d] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int k = 0; k < K; ++k) z[j][c] = fmaf(x[j][k], wr[c][k], z[j][c]);
        }
      }
    }
    if constexpr (kHvpMode && (2 * RB * C) <= kWarp && ((2 * RB * C) & (2 * RB * C - 1)) == 0) {
      warp_logits_hvp<C, RB>(z, u, red, redu, warp, lane);
    } else {
      warp_logits<C, RB>(z, red, warp, lane);
      if (kHvpMode) warp_logits<C, RB>(u, redu, warp, lane);
    }
    __syncthreads();  // every warp reads red before the next group's top barrier
    const float* tm = terms + slot * kTerms * kWarp + lane;
    const float rl = lane_residual<C, MODE>(
        red, redu, lane,
        RowTerms{tm[0], tm[kWarp], tm[2 * kWarp], tm[3 * kWarp], tm[4 * kWarp]});
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      if (j >= rows) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float r = __shfl_sync(0xffffffffu, rl, j * C + c);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int d = k * kThreads + t;
          const float xv = kHvpMode ? (d < D ? xs[j][d] : 0.f) : x[j][k];
          acc[c][k] = fmaf(r, xv, acc[c][k]);
        }
      }
    }
  }
  copy_wait<0>();  // no copy outlives the CTA
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = k * kThreads + t;
    if (d >= D) break;
#pragma unroll
    for (int c = 0; c < C; ++c) part[(int64_t)c * D + d] = acc[c][k];
  }
}

// many_rows, D wider than a thread's registers hold its columns of w (kHvp:
// of w, v) and the accumulators: the CTA takes rows = wide_rows(D) rows at
// once (8 at D 2049), copied into shared memory by copy_row, every copy
// issued at once (the SM's other CTA computes meanwhile). Thread t takes
// columns d = t + k kThreads. For each block of kWideClasses classes it sums
// its partial z (kHvp: and u) of the rows from shared memory, with w (and v)
// read once for the rows (through L1, from L2); transpose reductions (one a
// block; kHvp: two) take the warps' sums to shared memory. One lane a (row,
// class) adds them in warp order and forms the residual; then each thread
// adds r x into its columns of the CTA's partial in scratch, read (every
// class's at once) and written once for the rows. Each element of the
// partial is summed by one thread, in row order. Latency-bound: on the H100
// at N 78,487, D 2049 kHvp takes 2.4 ms at C 16, slower than three float32
// matrix products (1.4 ms), though faster than the three-pass code it
// replaced (3.0 ms).
template <int C, int MODE>
__device__ __forceinline__ void rows_wide(const Args& a, int i0, int i1, float* part,
                                          float* dyn) {
  constexpr int R = kWideRows, CB = kWideClasses, RPW = kWarp / C;  // RPW: rows a warp forms
  constexpr bool kHvpMode = MODE == kHvp;
  // U: columns whose w and v loads go out at once (on the H100 two took C 16
  // from 3.98 to 2.43 ms at D 2049, but C 3 from 0.54 to 0.67)
  constexpr int U = C >= 8 ? 2 : 1;
  static_assert(R % 4 == 0 && 2 * 4 * CB == kWarp && R * CB == kWarp,
                "a transpose reduction takes 4 rows of z and u, or 8 rows of z");
  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp, D = a.D;
  const int P = row_pitch(D), rmax = wide_rows(D);
  float* wz = dyn + rmax * P;       // [kWarps][R][C] the warps' sums of z
  float* wu = wz + kWarps * R * C;  // [kWarps][R][C] and of u (kHvp)
  float* rs = wu + kWarps * R * C;  // [C][R] the residuals
  for (int i = i0; i < i1; i += rmax) {
    const int rows = min(rmax, i1 - i);
    int off[R];  // row j at dyn + off[j]
#pragma unroll
    for (int j = 0; j < R; ++j) {
      off[j] = 0;
      if (j < rows) {
        off[j] = j * P + copy_row(dyn + j * P, a.Xa + row_id<MODE>(a, i + j) * D, D, t);
      }
    }
    copy_commit();
    copy_wait<0>();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += CB) {
      float z[R][CB], u[R][CB];
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int c = 0; c < CB; ++c) z[j][c] = u[j][c] = 0.f;
      }
      for (int d0 = t; d0 < D; d0 += U * kThreads) {  // U columns: their loads at once
        float wv[U][CB], vv[U][CB];
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const int d = d0 + e * kThreads;
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            const bool in = c0 + c < C && d < D;
            wv[e][c] = in ? __ldg(a.w + (int64_t)(c0 + c) * D + d) : 0.f;
            vv[e][c] = kHvpMode && in ? __ldg(a.v + (int64_t)(c0 + c) * D + d) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const int d = d0 + e * kThreads;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float x = j < rows && d < D ? dyn[off[j] + d] : 0.f;
#pragma unroll
            for (int c = 0; c < CB; ++c) {
              z[j][c] = fmaf(x, wv[e][c], z[j][c]);
              if (kHvpMode) u[j][c] = fmaf(x, vv[e][c], u[j][c]);
            }
          }
        }
      }
      if constexpr (kHvpMode) {
#pragma unroll
        for (int h = 0; h < R / 4; ++h) {  // rows 4h .. 4h + 3
          float v[kWarp];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int c = 0; c < CB; ++c) {
              v[2 * (j * CB + c)] = z[4 * h + j][c];
              v[2 * (j * CB + c) + 1] = u[4 * h + j][c];
            }
          }
          int q;
          const float sum = transpose_sum<kWarp>(v, lane, q);
          const int j = 4 * h + (q >> 1) / CB, c = c0 + (q >> 1) % CB;
          if (c < C) ((q & 1) ? wu : wz)[(warp * R + j) * C + c] = sum;
        }
      } else {
        float v[kWarp];
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int c = 0; c < CB; ++c) v[j * CB + c] = z[j][c];
        }
        int q;
        const float sum = transpose_sum<kWarp>(v, lane, q);
        const int j = q / CB, c = c0 + q % CB;
        if (c < C) wz[(warp * R + j) * C + c] = sum;
      }
    }
    __syncthreads();
    if (warp * RPW < rows) {  // lane l of warp w: row w RPW + l / C, class l % C
      const int j = warp * RPW + lane / C, c = lane % C;
      const bool mine = lane < RPW * C && j < rows;
      float z = 0.f, u = 0.f;
      RowTerms s{};
      if (mine) {
        z = wz[j * C + c];
        if (kHvpMode) u = wu[j * C + c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          z += wz[(w * R + j) * C + c];
          if (kHvpMode) u += wu[(w * R + j) * C + c];
        }
        s = row_terms<C, MODE>(a, row_id<MODE>(a, i + j), i + j, c);
      }
      const float r = softmax_residual<C, MODE>(z, u, lane, s);
      if (mine) rs[c * R + j] = r;
    }
    __syncthreads();
    for (int d = t; d < D; d += kThreads) {
      float acc[C];  // the column's partial, every class's load at once (none at the first rows)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = i == i0 ? 0.f : __ldcg(part + (int64_t)c * D + d);
      float x[R];
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = j < rows ? dyn[off[j] + d] : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j4 = 0; j4 < R; j4 += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(rs + c * R + j4);
          const float r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j4 + e < rows) acc[c] = fmaf(r[e], x[j4 + e], acc[c]);
          }
        }
        __stcg(part + (int64_t)c * D + d, acc[c]);
      }
    }
    __syncthreads();  // the rows and rs are free for the next rows
  }
}

// many_rows, D wider than the registers hold: one row at a time, the CTA's
// partial [C, D] accumulated in `part` itself (each element by one thread, in
// row order, the same float program as rows_staged).
template <int C, int MODE>
__device__ __forceinline__ void rows_streamed(const Args& a, int i0, int i1, float* part,
                                              float (*red)[kWarp], float (*redu)[kWarp]) {
  constexpr bool kHvpMode = MODE == kHvp;
  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp, D = a.D;
  for (int d = t; d < D; d += kThreads) {
#pragma unroll
    for (int c = 0; c < C; ++c) part[(int64_t)c * D + d] = 0.f;
  }
  for (int i = i0; i < i1; ++i) {
    const int64_t src = row_id<MODE>(a, i);
    RowTerms terms{};
    if (lane < C) terms = row_terms<C, MODE>(a, src, i, lane);
    const float* row = a.Xa + src * D;
    float z[1][C], u[1][C];
#pragma unroll
    for (int c = 0; c < C; ++c) z[0][c] = u[0][c] = 0.f;
#pragma unroll 4
    for (int d = t; d < D; d += kThreads) {
      const float xv = row[d];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        z[0][c] = fmaf(xv, __ldg(a.w + (int64_t)c * D + d), z[0][c]);
        if (kHvpMode) u[0][c] = fmaf(xv, __ldg(a.v + (int64_t)c * D + d), u[0][c]);
      }
    }
    warp_logits<C, 1>(z, red, warp, lane);
    if (kHvpMode) warp_logits<C, 1>(u, redu, warp, lane);
    __syncthreads();
    const float rl = lane_residual<C, MODE>(red, redu, lane, terms);
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = __shfl_sync(0xffffffffu, rl, c);
    __syncthreads();  // red is read before the next row's sums overwrite it
#pragma unroll 4
    for (int d = t; d < D; d += kThreads) {
      const float xv = row[d];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float* p = part + (int64_t)c * D + d;
        *p = fmaf(r[c], xv, *p);
      }
    }
  }
}

template <int C, int MODE>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) many_rows(const Args a) {
  extern __shared__ float dyn[];  // ring_floats(C, MODE) or wide_floats(C, D)
  __shared__ float red[kWarps][kWarp];
  __shared__ float redu[MODE == kHvp ? kWarps : 1][kWarp];  // kHvp: the warps' sums of u
  __shared__ float sums[kThreads];
  const int G = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const int64_t O = (int64_t)C * a.D;
  const int i0 = (int)((int64_t)b * a.n_rows / G);
  const int i1 = (int)((int64_t)(b + 1) * a.n_rows / G);
  float* part = a.partial + b * O;
  const int path = many_path(C, MODE, a.D);
  if (path == kStaged) {
    rows_staged<C, MODE>(a, i0, i1, part, dyn, red, redu);
  } else if (path == kWide) {
    rows_wide<C, MODE>(a, i0, i1, part, dyn);
  } else {
    rows_streamed<C, MODE>(a, i0, i1, part, red, redu);
  }
  cooperative_groups::this_grid().sync();
  // The final sum. Each column's G partials are cut into `splits` ranges of
  // CTAs (split s takes CTAs s, s + splits, ... in order), the fewest that
  // leave a thread at most kSumLoads loads, all issued at once; a step takes
  // kThreads / splits columns, and adds the ranges in order. The partials
  // were written in this launch, so they are read past L1 (__ldcg).
  int splits = 1;
  while (splits * kSumLoads < G) splits *= 2;
  const int width = kThreads / splits, col = t % width, split = t / width;
  const int64_t steps = (O + width - 1) / width;
  for (int64_t q = b; q < steps; q += G) {
    const int64_t o = q * width + col;
    const float l2w = t < width && o < O && a.base ? a.l2 * a.base[o] : 0.f;  // loaded early
    float v[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      const int cta = split + u * splits;
      v[u] = o < O && cta < G ? __ldcg(a.partial + cta * O + o) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) s += v[u];
    sums[t] = s;
    __syncthreads();
    if (t < width && o < O) {
      float tot = sums[t];
      for (int k = 1; k < splits; ++k) tot += sums[k * width + t];
      a.out[o] = a.base ? tot / a.denom + l2w : tot / a.denom;
    }
    __syncthreads();
  }
}

template <int C, int MODE>
__global__ void __launch_bounds__(kThreads) few_rows(const Args a) {
  constexpr int S = few_slots(C);
  extern __shared__ float dyn[];
  __shared__ float red[kWarps][kWarp];
  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp, D = a.D, r = a.n_rows;
  const int P = row_pitch(D);
  int64_t src[S];
#pragma unroll
  for (int j = 0; j < S; ++j) src[j] = j < r ? row_id<MODE>(a, j) : 0;
  // every copy of the slots' rows and of w's rows issued at once: one memory
  // round trip; row j at xs[j], row c of w at ws[c]
  const float* xs[S];
  const float* ws[C];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    xs[j] = dyn;
    if (j < r) xs[j] = dyn + j * P + copy_row(dyn + j * P, a.Xa + src[j] * D, D, t);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float* dst = dyn + (r + c) * P;
    ws[c] = dst + copy_row(dst, a.w + (int64_t)c * D, D, t);
  }
  copy_commit();
  RowTerms terms{};
  if (lane < r * C) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j == lane / C) terms = row_terms<C, MODE>(a, src[j], j, lane % C);
    }
  }
  copy_wait<0>();
  __syncthreads();
  float z[S][C];
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) z[j][c] = 0.f;
  }
  for (int d = t; d < D; d += kThreads) {  // in the order rows_staged takes a thread's columns
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j >= r) break;
      const float x = xs[j][d];
#pragma unroll
      for (int c = 0; c < C; ++c) z[j][c] = fmaf(x, ws[c][d], z[j][c]);
    }
  }
  warp_logits<C, S>(z, red, warp, lane);
  __syncthreads();
  const float rl = lane_residual<C, MODE>(red, red, lane, terms);  // no kHvp here: no u
  const int d = blockIdx.x * kThreads + t;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j >= r) break;
      const float rjc = __shfl_sync(0xffffffffu, rl, j * C + c);
      if (d < D) s = fmaf(rjc, xs[j][d], s);
    }
    if (d >= D) continue;
    const int64_t o = (int64_t)c * D + d;
    a.out[o] = a.base ? s / a.denom + a.l2 * a.base[o] : s / a.denom;
  }
}

// Whether a kernel of this library may use its dynamic shared memory on a
// device, a bit for each device, by [MODE][few][C]. Internal to the library:
// a function-local static of a template would be one object for every
// library in the process that holds the same instance.
static unsigned smem_ready[3][2][kMaxClasses + 1];

// Allow `kernel` `bytes` of dynamic shared memory on the current device, once
// a device (`done` holds a bit for each device already set).
inline cudaError_t allow_smem(const void* kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <int C, int MODE>
cudaError_t launch_c(const Args& a, int grid, bool few, cudaStream_t st) {
  cudaError_t err;
  if (few) {
    if constexpr (MODE == kHvp) {
      return cudaErrorInvalidValue;  // few_rows has no kHvp mode
    } else {
      const void* kernel = reinterpret_cast<const void*>(&few_rows<C, MODE>);
      err = allow_smem(kernel, kFewMaxFloats * sizeof(float), smem_ready[MODE][1][C]);
      if (err == cudaSuccess) {
        const size_t bytes = (a.n_rows + C) * row_pitch(a.D) * sizeof(float);
        few_rows<C, MODE><<<grid, kThreads, bytes, st>>>(a);
      }
    }
  } else {
    const void* kernel = reinterpret_cast<const void*>(&many_rows<C, MODE>);
    const int path = many_path(C, MODE, a.D);
    const int floats = path == kStaged ? ring_floats(C, MODE)
                       : path == kWide ? wide_floats(C, a.D)
                                       : 0;
    err = allow_smem(kernel, many_smem_floats(C, MODE) * sizeof(float), smem_ready[MODE][0][C]);
    Args copy = a;
    void* args[] = {&copy};
    if (err == cudaSuccess) {
      err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                        floats * sizeof(float), st);
    }
  }
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

// One launch on `st`: few_rows on `grid` column blocks where `few`, else
// many_rows on `grid` CTAs with a.partial of [grid, C, D] floats; the wrapper
// takes both from the shapes and the SM count (kernels/common.py:
// gather_plan; kHvp: its many-rows grid). a.idx is null for kHvp always,
// for kGrad over contiguous rows (lr_grad), and never for kCorr. Returns the
// launch's error.
template <int MODE>
cudaError_t launch(const Args& a, int C, int grid, int few, cudaStream_t st) {
  const int nb = (a.D + kThreads - 1) / kThreads;
  if (a.n_rows < 1 || a.D < 1 || C < 1 || C > kMaxClasses || grid < 1 ||
      (MODE == kHvp && (a.idx != nullptr || a.v == nullptr)) ||
      (MODE == kCorr && a.idx == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const bool ok = few ? a.n_rows <= few_slots(C) && grid == nb &&
                            (a.n_rows + C) * (int64_t)row_pitch(a.D) <= kFewMaxFloats
                      : a.partial != nullptr && grid <= a.n_rows && grid <= kThreads * kSumLoads;
  if (!ok) return cudaErrorInvalidValue;
  switch (C) {
#define CHEF_CASE(K) \
  case K:            \
    return launch_c<K, MODE>(a, grid, few != 0, st);
    CHEF_CASE(1) CHEF_CASE(2) CHEF_CASE(3) CHEF_CASE(4) CHEF_CASE(5) CHEF_CASE(6)
    CHEF_CASE(7) CHEF_CASE(8) CHEF_CASE(9) CHEF_CASE(10) CHEF_CASE(11) CHEF_CASE(12)
    CHEF_CASE(13) CHEF_CASE(14) CHEF_CASE(15) CHEF_CASE(16)
#undef CHEF_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace gather
}  // namespace chef
