// Single-token GQA decode attention over the ring KV cache (replaces the TPU
// kernel repro/kernels/decode_attention.py::decode_attention_pallas). For
// sequence b and kv head h, with the G query rows q[b, h] and the ring's W
// slots:
//
//     s[g, t] = q[g].k[t] * scale, then softcap * tanh(s / softcap)  (softcap > 0)
//     s = valid[t] ? s : -1e30;  m = max_t s;  p = valid[t] ? exp(s - m) : 0
//     o[g] = sum_t p[g, t] v[t] / max(sum_t p[g, t], 1e-30)
//
// The TPU kernel's grid is (B, Hkv), one cell holding a head's whole ring:
// at RecurrentGemma-9B's decode shape (B 2, one kv head, W 2048) that would be
// 2 CTAs on 132 SMs. Here the ring of each (sequence, kv head) cell is cut
// into n_split chunks of `chunk` slots, chunk from the shapes and the SM
// count (`plan`, which chef_decode_plan gives the wrapper), so that the
// cells' chunks fill the card; and the chunks are merged in the same launch.
// One cooperative launch of `grid` CTAs of 256 threads (at most as many as
// the card holds at once, by the occupancy calculator), in two phases split
// by a grid barrier:
//
//   partials  a CTA takes work items (cell, chunk) in a grid-stride loop. It
//             copies q [G, D] and the chunk's K and V rows into shared memory
//             in their own type, every copy issued at once (16-byte cp.async
//             where a row starts 16-byte aligned, else plain loads: the ring
//             is read through its strides in the model layout [B, W, Hkv, D],
//             never transposed; the scores start once q and K are in, while V
//             lands); then with every thread busy:
//               scores   a warp a set of kGT query rows and every few
//                        slots, two at a time: lane l holds its 4-column
//                        slices d = 4 l + 128 j of the kGT rows of q in
//                        registers, reads each slot's K row once, and the
//                        2 kGT partial dot products are summed over the warp
//                        by a transpose reduction (9 shuffles for 8 scores);
//               softmax  a warp a query row: max and sum over the chunk's
//                        slots by shuffles, p stored slot-major;
//               p.v      a thread a tile of 4 query rows x 4 columns: a
//                        16-byte read of V and a broadcast 16-byte read of p
//                        a slot for 16 FMAs; where the tiles leave threads
//                        idle (small G or D), threads split the slots.
//             It writes the chunk's partial softmax (m, l, acc); a chunk with
//             no valid slot gives the neutral partial (-1e30, 0, 0).
//   merge     work units (cell, query row, block of columns) in a
//             grid-stride loop: the chunks' m and l loaded in parallel (and
//             beside them a first batch of acc), M = max m, weights
//             exp(m - M), l summed by a fixed tree; each column of acc summed
//             over the chunks by kThreads / width threads a unit, each
//             loading up to kMergeLoads partials at once, the threads' sums
//             added in order; out = acc / max(l, 1e-30) in q's type.
//
// No atomics, and every sum's order depends on the shapes and the SM count
// only: the result repeats bit for bit.
//
// Bound on the H100: device-memory bytes, one read of the ring's K and V of
// each (sequence, kv head) (2 W D 4 bytes in float32: 8.4 MB at
// RecurrentGemma-9B's decode shape, 2.5 us); the 4 G W D flops (67 MFLOP
// there, 1 us at the float32 CUDA cores' peak) run on FMAs, not tensor
// cores, so the error stays near float32 rounding.
#include <cooperative_groups.h>

#include "attn_common.cuh"

namespace chef {
namespace decode {

constexpr int kThreads = 256;    // threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;    // CTAs an SM holds at most (the launch bounds)
constexpr int kGT = 4;           // query rows of a scores warp, in registers
constexpr int kMaxD = 512;       // the widest head: 4 slices of 128 columns a scores lane
constexpr int kChunkAlign = 8;   // a chunk is a multiple of this many slots
constexpr int kMinChunk = 32;    // fewer slots leave softmax lanes idle and add partials to merge
constexpr int kMaxChunk = 128;   // slots of a work item at most
constexpr int kFill = 2;         // work items the plan aims at for each SM
constexpr int kMergeLoads = 16;  // partials a merge thread loads at once
// dynamic shared memory a CTA may take: the H100's opt-in 227 KB (232,448
// bytes, static and dynamic together) less 2 KB for the static arrays
constexpr int kMaxSmem = 230400;

struct Args {
  const void* q;               // [B, Hkv, G, D] contiguous
  const void* k;               // [B, W, Hkv, D] through strides
  const void* v;
  const unsigned char* valid;  // [W] bool
  void* out;                   // [B, Hkv, G, D] in q's type
  int B, Hkv, G, D, W, chunk, n_split;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float softcap, inv_softcap, scale;
  float* m;                    // [B Hkv, n_split, G] scratch
  float* l;
  float* acc;                  // [B Hkv, n_split, G, D] scratch
};

// Elements of a row in shared memory: D rounded up to 16 bytes in both types.
__host__ __device__ constexpr int row_pitch(int D) { return (D + 7) / 8 * 8; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Bytes of a CTA's dynamic shared memory:
// q, K and V tiles in their own type, then the scores [G, chunk], p
// [chunk, round4(G)] and the chunk's valid flags in 4 bytes each; the merge
// reuses the front for 2 n_split floats.
__host__ __device__ constexpr int smem_bytes(int elem, int G, int D, int chunk, int n_split) {
  return imax(elem * row_pitch(D) * (G + 2 * chunk) + 4 * (G * chunk + chunk * round4(G) + chunk),
              8 * n_split);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Rows [0, n) of `src` (row r at src + r * stride elements, D elements each)
// into shared memory at dst, row_pitch(D) elements a row: every copy issued
// by the CTA at once. A row that starts 16-byte aligned goes in 16-byte
// cp.async copies (zero-filled past D); another in plain loads, zero past D
// up to the next 16 bytes.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride, int n, int D,
                                           int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte copy
  const int nq = (D + kPer - 1) / kPer, P = row_pitch(D);
  for (int i = tid; i < n * nq; i += kThreads) {
    const int r = i / nq, q = i - r * nq;
    const T* s = src + r * stride + q * kPer;
    T* d = dst + r * P + q * kPer;
    const int left = D - q * kPer;  // elements of this row from s on
    if ((reinterpret_cast<uintptr_t>(src + r * stride) & 15) == 0) {
      const int bytes = (left < kPer ? left : kPer) * (int)sizeof(T);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(d)),
                   "l"(s), "r"(bytes));
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) d[e] = e < left ? s[e] : T(0.f);
    }
  }
}

// Four consecutive elements (16 or 8 bytes, aligned) as float32.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_add(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The partials of work item (cell, c): the chunk's slots [c chunk, ...).
// J: 128-column slices a scores lane holds (D <= 128 J).
template <typename T, int J>
__device__ __forceinline__ void chunk_partials(const Args& a, int cell, int c, char* smem) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G, D = a.D, P = row_pitch(D), GP = round4(G), chunk = a.chunk;
  const int b = cell / a.Hkv, h = cell % a.Hkv;
  const int t0 = c * chunk, n = min(chunk, a.W - t0);  // slots of this chunk
  T* Qs = reinterpret_cast<T*>(smem);                   // [G][P]
  T* Ks = Qs + G * P;                                   // [chunk][P]
  T* Vs = Ks + chunk * P;                               // [chunk][P]
  float* Ss = reinterpret_cast<float*>(Vs + chunk * P);  // [G][chunk] scores
  float* Pt = Ss + G * chunk;                           // [chunk][GP] p, slot-major
  int* ok = reinterpret_cast<int*>(Pt + chunk * GP);    // [chunk]
  // q and K in one commit group, V in a second: the scores start while V lands
  stage_rows(Qs, static_cast<const T*>(a.q) + (int64_t)cell * G * D, D, G, D, tid);
  stage_rows(Ks, static_cast<const T*>(a.k) + b * a.k_sb + (int64_t)t0 * a.k_ss + h * a.k_sh,
             a.k_ss, n, D, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_rows(Vs, static_cast<const T*>(a.v) + b * a.v_sb + (int64_t)t0 * a.v_ss + h * a.v_sh,
             a.v_ss, n, D, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int t = tid; t < n; t += kThreads) ok[t] = a.valid[t0 + t] != 0;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // scores: task (query-row set gs, slot group grp) takes slots t = grp,
  // grp + groups, ... two at a time: 8 partial dot products a lane (2 slots x
  // kGT rows), summed over the warp by a transpose reduction: lanes with bit
  // 4 clear keep the first slot's, the others the second's; bit 3 then picks
  // rows 0-1 or 2-3, bit 2 one of those; a butterfly over bits 1 and 0 ends it
  // (9 shuffles for 8 scores)
  const int gsets = (G + kGT - 1) / kGT;
  const int groups = gsets < kWarps ? kWarps / gsets : 1;
  for (int task = warp; task < gsets * groups; task += kWarps) {
    const int gs = task % gsets, grp = task / gsets;
    float qr[kGT][J][4];
#pragma unroll
    for (int i = 0; i < kGT; ++i) {
      const int g = gs * kGT + i;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int d0 = 4 * lane + 128 * j;
        if (g < G && d0 < D) {
          load4(Qs + g * P + d0, qr[i][j]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qr[i][j][e] = 0.f;
        }
      }
    }
    const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
    const int g_out = gs * kGT + 2 * hi8 + hi4;  // the score this lane ends with
    for (int t = grp; t < n; t += 2 * groups) {
      float z[2][kGT];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tu = t + u * groups;
        float kr[J][4];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int d0 = 4 * lane + 128 * j;
          if (tu < n && d0 < D) {
            load4(Ks + tu * P + d0, kr[j]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) kr[j][e] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kGT; ++i) {
          z[u][i] = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) z[u][i] = fmaf(qr[i][j][e], kr[j][e], z[u][i]);
          }
        }
      }
      float k4[kGT];
#pragma unroll
      for (int i = 0; i < kGT; ++i) {
        k4[i] = (hi16 ? z[1][i] : z[0][i]) +
                __shfl_xor_sync(0xffffffffu, hi16 ? z[0][i] : z[1][i], 16);
      }
      float k2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        k2[i] = (hi8 ? k4[2 + i] : k4[i]) +
                __shfl_xor_sync(0xffffffffu, hi8 ? k4[i] : k4[2 + i], 8);
      }
      float x = (hi4 ? k2[1] : k2[0]) + __shfl_xor_sync(0xffffffffu, hi4 ? k2[0] : k2[1], 4);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      const int ts = t + (hi16 ? groups : 0);
      if ((lane & 3) == 0 && g_out < G && ts < n) {
        x *= a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x * a.inv_softcap);
        Ss[g_out * chunk + ts] = ok[ts] ? x : kNegInf;
      }
    }
  }
  __syncthreads();

  // softmax: a warp a query row, over the chunk's slots
  float* m_out = a.m + ((int64_t)cell * a.n_split + c) * G;
  float* l_out = a.l + ((int64_t)cell * a.n_split + c) * G;
  for (int g = warp; g < G; g += kWarps) {
    float s[kMaxChunk / 32];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kMaxChunk / 32; ++i) {
      const int t = lane + 32 * i;
      s[i] = t < n ? Ss[g * chunk + t] : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunk / 32; ++i) {
      const int t = lane + 32 * i;
      if (t < n) {
        const float p = ok[t] ? expf(s[i] - mx) : 0.f;
        Pt[t * GP + g] = p;
        sum += p;
      }
    }
    sum = warp_add(sum);
    if (lane == 0) {
      m_out[g] = mx;
      l_out[g] = sum;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // p.v: a thread a tile of 4 query rows x 4 columns (two 16-byte reads of
  // shared memory a slot for 16 FMAs). Where the tiles leave threads idle,
  // `parts` threads share a tile, each taking every parts-th slot, and their
  // sums are added in order through shared memory (the K tile's, free now).
  float* acc_out = a.acc + ((int64_t)cell * a.n_split + c) * G * D;
  const int ng = (G + 3) / 4, nd = (D + 3) / 4, tiles = ng * nd;
  int parts = tiles <= kThreads / 2 ? kThreads / tiles : 1;
  while (parts > 1 && parts * G * D * 4 > chunk * P * (int)sizeof(T)) parts /= 2;
  float* red = reinterpret_cast<float*>(Ks);  // [parts][G][D]
  const int part = tid / tiles;               // < parts where the tiles fill the CTA once
  for (int tile = parts > 1 ? tid % tiles : tid; tile < tiles && part < parts;
       tile += kThreads) {
    const int g0 = 4 * (tile / nd), d0 = 4 * (tile % nd);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
#pragma unroll 2
    for (int t = part; t < n; t += parts) {
      float vv[4];
      load4(Vs + t * P + d0, vv);  // zero past D
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + t * GP + g0);
      const float pg[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pg[i], vv[e], acc[i][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (g0 + i >= G) break;
      float* dst = parts > 1 ? red + (part * G + g0 + i) * D : acc_out + (int64_t)(g0 + i) * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d0 + e < D) dst[d0 + e] = acc[i][e];
      }
    }
  }
  if (parts > 1) {
    __syncthreads();
    for (int o = tid; o < G * D; o += kThreads) {
      float tot = red[o];
      for (int q = 1; q < parts; ++q) tot += red[q * G * D + o];
      acc_out[o] = tot;
    }
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) decode_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[2][kWarps];
  __shared__ float sums[kThreads];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cells = a.B * a.Hkv, items = cells * a.n_split;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    __syncthreads();  // the previous item's reads of shared memory are done
    chunk_partials<T, J>(a, item / a.n_split, item % a.n_split, smem);
  }
  cooperative_groups::this_grid().sync();

  // merge: unit (row, block of `width` columns); `splits` threads a column,
  // split s taking chunks s, s + splits, ... in order. The partials were
  // written in this launch, so they are read past L1 (__ldcg).
  const int G = a.G, D = a.D, ns = a.n_split;
  int splits = 1;
  while (splits * kMergeLoads < ns && splits < kThreads / 32) splits *= 2;
  const int width = kThreads / splits, col = tid % width, split = tid / width;
  const int blocks = (D + width - 1) / width, units = cells * G * blocks;
  float* wm = reinterpret_cast<float*>(smem);  // [ns] m, then the weights exp(m - M)
  float* wl = wm + ns;                         // [ns] l
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int row = unit / blocks, blk = unit % blocks;  // row = cell G + g
    const int cell = row / G, g = row % G;
    const int64_t base = (int64_t)cell * ns;  // chunk 0 of the cell
    const int d = blk * width + col;
    const float* acc = a.acc + (base * G + g) * D + d;
    const int64_t cstride = (int64_t)G * D;  // from chunk c to chunk c + 1
    float vals[kMergeLoads];  // the first batch of partials, in flight beside m and l
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      const int c = split + u * splits;
      vals[u] = d < D && c < ns ? __ldcg(acc + c * cstride) : 0.f;
    }
    float mx = kNegInf;
    for (int c = tid; c < ns; c += kThreads) {
      wm[c] = __ldcg(a.m + (base + c) * G + g);
      wl[c] = __ldcg(a.l + (base + c) * G + g);
      mx = fmaxf(mx, wm[c]);
    }
    mx = warp_max(mx);
    if (lane == 0) red[0][warp] = mx;
    __syncthreads();
    float M = red[0][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red[0][w]);
    float lp = 0.f;
    for (int c = tid; c < ns; c += kThreads) {
      const float wc = expf(wm[c] - M);
      wm[c] = wc;
      lp = fmaf(wl[c], wc, lp);
    }
    lp = warp_add(lp);
    if (lane == 0) red[1][warp] = lp;
    __syncthreads();  // the weights and the warps' sums of l are in
    float L = red[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) L += red[1][w];
    float x = 0.f;
    if (d < D) {
      for (int c0 = split; c0 < ns; c0 += splits * kMergeLoads) {
        if (c0 != split) {
#pragma unroll
          for (int u = 0; u < kMergeLoads; ++u) {
            const int c = c0 + u * splits;
            vals[u] = c < ns ? __ldcg(acc + c * cstride) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          const int c = c0 + u * splits;
          if (c < ns) x = fmaf(vals[u], wm[c], x);
        }
      }
    }
    sums[tid] = x;
    __syncthreads();
    if (split == 0 && d < D) {
      float tot = sums[col];
      for (int s = 1; s < splits; ++s) tot += sums[s * width + col];
      store(static_cast<T*>(a.out) + (int64_t)row * D + d, tot / fmaxf(L, 1e-30f));
    }
    __syncthreads();  // wm, wl, red and sums are free for the next unit
  }
}

// The instance that takes heads of D columns: J slices of 128 a scores lane.
template <typename T>
const void* instance(int D) {
  if (D <= 128) return reinterpret_cast<const void*>(&decode_kernel<T, 1>);
  if (D <= 256) return reinterpret_cast<const void*>(&decode_kernel<T, 2>);
  return reinterpret_cast<const void*>(&decode_kernel<T, 4>);
}

// Whether an instance may use kMaxSmem of dynamic shared memory on a device,
// a bit for each device, by [bf16][J index]. At namespace scope: a
// function-local static of a template would be one object for every library
// in the process that holds the same instance.
static unsigned smem_ready[2][3];

// Allow the instance for (bf16, D) kMaxSmem of dynamic shared memory on the
// current device, once a device.
inline cudaError_t allow_smem(const void* kernel, bool bf16, int D) {
  unsigned& done = smem_ready[bf16][D <= 128 ? 0 : D <= 256 ? 1 : 2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

inline bool valid_shapes(int B, int Hkv, int G, int D, int W, int elem) {
  return B >= 1 && Hkv >= 1 && G >= 1 && D >= 1 && D <= kMaxD && W >= 1 &&
         smem_bytes(elem, G, D, kChunkAlign, 0) <= kMaxSmem;
}

// The launch at these shapes on the current device, from the shapes, the SM
// count and the occupancy calculator only: each (sequence, kv head) cell's W
// slots cut into n_split chunks of `chunk` slots (a multiple of kChunkAlign,
// from kMinChunk to kMaxChunk, its tiles within kMaxSmem), so that the
// cells' chunks come to about kFill work items an SM; chunk c takes slots
// [c chunk, min(W, (c + 1) chunk)). On the H100 RecurrentGemma-9B's decode
// runs fastest at 32 slots a chunk (fewer partials to merge), OLMo-1B's ring
// at 64 (2 CTAs an SM, not 1 with 128). The cooperative grid takes every
// item at once where the card holds them, else loops over them. The merge's
// order depends on chunk and n_split alone. `scratch`: the floats of the
// partials m, l [cells, n_split, G] and acc [cells, n_split, G, D].
struct Plan {
  int chunk, n_split, grid;
  long long scratch;
};

inline cudaError_t plan(int B, int Hkv, int G, int D, int W, bool bf16, Plan& p) {
  const int elem = bf16 ? 2 : 4;
  if (!valid_shapes(B, Hkv, G, D, W, elem)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long cells = (long long)B * Hkv;
  const int want = (int)(kFill * sms / cells > 1 ? kFill * sms / cells : 1);  // chunks a cell
  const int per = (W + want - 1) / want;  // slots a chunk, before rounding
  int chunk = imin(kMaxChunk, imax(kMinChunk, (per + kChunkAlign - 1) / kChunkAlign * kChunkAlign));
  while (chunk > kChunkAlign && smem_bytes(elem, G, D, chunk, 0) > kMaxSmem) chunk -= kChunkAlign;
  const int n_split = (W + chunk - 1) / chunk;
  const int smem = smem_bytes(elem, G, D, chunk, n_split);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const void* kernel = bf16 ? instance<__nv_bfloat16>(D) : instance<float>(D);
  err = allow_smem(kernel, bf16, D);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = cells * n_split, fit = (long long)per_sm * sms;
  p = {chunk, n_split, (int)(items < fit ? items : fit), cells * n_split * G * (D + 2)};
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Args& a, int grid, cudaStream_t st) {
  if (!valid_shapes(a.B, a.Hkv, a.G, a.D, a.W, sizeof(T)) || a.chunk < 1 ||
      a.chunk > kMaxChunk || a.chunk % 4 != 0 || a.n_split != (a.W + a.chunk - 1) / a.chunk ||
      grid < 1 || smem_bytes(sizeof(T), a.G, a.D, a.chunk, a.n_split) > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  const void* kernel = instance<T>(a.D);
  cudaError_t err = allow_smem(kernel, sizeof(T) == 2, a.D);
  if (err == cudaSuccess) {
    Args copy = a;
    void* args[] = {&copy};
    err = cudaLaunchCooperativeKernel(
        kernel, dim3(grid), dim3(kThreads), args,
        smem_bytes(sizeof(T), a.G, a.D, a.chunk, a.n_split), st);
  }
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

}  // namespace decode
}  // namespace chef

// The launch plan of chef_decode_attention at these shapes on the current
// device (bf16 != 0: q, k and v in bfloat16): plan[0] = chunk, plan[1] =
// n_split, plan[2] = grid, plan[3] = floats of the m, l and acc scratch
// (chef::decode::plan). Returns an error where the shapes are not taken.
extern "C" int chef_decode_plan(int B, int Hkv, int G, int D, int W, int bf16, long long* plan) {
  chef::decode::Plan p{};
  const cudaError_t err = chef::decode::plan(B, Hkv, G, D, W, bf16 != 0, p);
  if (err == cudaSuccess) {
    plan[0] = p.chunk, plan[1] = p.n_split, plan[2] = p.grid, plan[3] = p.scratch;
  }
  return static_cast<int>(err);
}

// q [B, Hkv, G, D] contiguous; k, v [B, W, Hkv, D] with the given (batch,
// slot, head) strides in elements and a last stride of 1, of q's type
// (float32, or bfloat16 when bf16 != 0); valid [W] bool; out [B, Hkv, G, D]
// in q's type; m, l [B, Hkv, n_split, G] and acc [B, Hkv, n_split, G, D]
// float32 scratch; chunk, n_split and grid from chef_decode_plan, one
// cooperative launch of `grid` CTAs. inv_softcap is 1 / softcap rounded once
// to float32 by the caller.
extern "C" int chef_decode_attention(const void* q, const void* k, const void* v,
                                     const unsigned char* valid, void* out, int B, int Hkv,
                                     int G, int D, int W, int chunk, int n_split, int grid,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     float softcap, float inv_softcap, float scale, float* m,
                                     float* l, float* acc, int bf16, void* stream) {
  const chef::decode::Args a{q, k, v, valid, out, B, Hkv, G, D, W, chunk, n_split,
                             k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, softcap, inv_softcap, scale,
                             m, l, acc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? chef::decode::launch<__nv_bfloat16>(a, grid, st)
                               : chef::decode::launch<float>(a, grid, st));
}
