// Per-page partial softmax of single-token GQA decode attention through a
// block table (replaces the TPU kernel
// repro/kernels/paged_attention.py::paged_attention_partials_pallas). For
// slot b, kv head h and logical page j, with physical page id = table[b, j]
// and the page's absolute key positions kpos = j * P + t, t < P:
//
//     s[g, t] = softcap * tanh((q[g].k[t] * scale) / softcap)    (softcap > 0)
//     valid[t] = kpos <= pos[b] && (window == 0 || kpos > pos[b] - window)
//     s = valid ? s : -1e30;  m[g] = max_t s;  p = valid ? exp(s - m) : 0
//     l[g] = sum_t p;  acc[g] = sum_t p[g, t] v[t]
//
// A table entry equal to the trash page 0, and a page none of whose keys is
// valid, give the neutral partial (-1e30, 0, 0) without reading the pool
// (for finite pools the plain version's bits: the engine's pools start
// zeroed). The caller merges the pages with `combine_pages` (plain PyTorch,
// shared with the plain version).
//
// The int8 mode (its own entry, chef_paged_attention_quant; replaces the TPU
// kernel repro/kernels/paged_attention.py::paged_attention_partials_quant_pallas)
// reads int8 code pools with one float32 scale per (page, kv head) and
// widens each code in registers as float(code) * scale[page, h]
// (`_dequant_page`: one exact conversion and one multiply, the plain
// version's bits); the rest is the float mode's partial. The pool crosses
// memory at a quarter of the float32 bytes.
//
// Bound on the H100: device-memory bytes, one read of every live page's K and
// V rows of one head (2 P D elements a page) plus every table page's partial
// written (G (D + 2) floats); the 4 G P D flops a page are far below the
// float32 rate. At decode sizes (a few MB over 2,048 to 3,016 page cells)
// latency weighs as much as bytes: a cell's work is two dependent trips to
// device memory (its table entry and position, then its page) and a short
// chain of arithmetic. So the design keeps every cell's loads in flight at
// once and puts no barrier between cells:
//
//   * A warp a page cell (slot, kv head, page), a CTA `warps` such warps
//     over consecutive pages of one (slot, kv head); no __syncthreads. The
//     warp reads its page id and pos[b]; a trash page, or a page whose keys
//     all lie past pos[b] or at or before pos[b] - window, writes the
//     neutral partial with 16-byte stores and reads nothing of the pool.
//   * A live page's K and V rows of head h go to the warp's own slice of
//     shared memory in their own type, every 16-byte cp.async issued before
//     the first use (K in one commit group, V in a second: the scores start
//     while V lands). A row that does not start 16-byte aligned (D not a
//     multiple of 16 bytes' worth) is copied with plain loads. The first
//     row group's q slice is loaded into registers while K lands; the rest
//     of q (the same for every page of (b, h)) is read through L1.
//   * The warp takes the cell's G query rows `rows` (1, 2 or 4) at a time,
//     so G x D never has to fit a warp's registers (G 12 at D 128, G 16 at D
//     256 run 3 and 4 groups). Scores: lane l holds the 4-column slices
//     d = 4 l + 128 i of the group's q rows and of each key, and the rows x
//     kTile partial dot products are summed over the warp by a transpose
//     reduction (each shuffle level halves the values a lane holds: 9
//     shuffles for 8 scores, 31 for 32), kTile keys at a time. Softmax: 32 /
//     rows lanes a query row, max and sum by shuffles. p.v: a lane owns its
//     4-column slices of the group's rows, p read from shared memory 4 keys
//     a 16-byte broadcast, acc written with 16-byte stores.
//   * Deterministic: no atomics, and every sum's order depends on the shapes
//     only, so a call repeats bit for bit. The launch plan (`plan`: rows a
//     warp, warps a CTA, shared memory) is this file's alone; the wrapper
//     asks chef_paged_plan for it only to report it.
#include "attn_common.cuh"

namespace chef {
namespace paged {

constexpr int kWarps = 4;       // warps (page cells) of a CTA at most
constexpr int kTile = 8;        // keys whose scores one transpose reduction sums
constexpr int kMaxRows = 4;     // query rows a warp takes at once
constexpr int kMaxSmem = 232448;  // the H100's opt-in shared memory a CTA (227 KB)

struct Args {
  const void* q;        // [B, Hkv, G, D]
  const void* k_pages;  // [N_pages, P, Hkv, D]
  const void* v_pages;
  const int* table;     // [B, n_pages]
  const int* pos;       // [B]
  float* m;             // [B, Hkv, n_pages, G]
  float* l;
  float* acc;           // [B, Hkv, n_pages, G, D]
  int Hkv, G, D, P, n_pages, window;
  float softcap, inv_softcap, scale;
  const float* k_scale;  // int8 pools only: [N_pages, Hkv]
  const float* v_scale;
  int slice;             // bytes of a warp's shared memory (plan)
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// Bytes of a staged K or V row: D elements rounded up to 16 bytes.
__host__ __device__ constexpr int row_bytes(int D, int elem) { return (D * elem + 15) / 16 * 16; }

// The launch at these shapes: `rows` query rows a warp at once, `warps` page
// cells a CTA, `slice` bytes of shared memory a warp (its page's K and V
// rows, then the scores of one row group, [rows][round4(P)] floats), `smem`
// bytes a CTA. False where a warp's page does not fit.
struct Plan {
  int rows, warps, slice, smem;
};

inline bool plan(int G, int D, int P, int kv_elem, Plan& p) {
  if (G < 1 || D < 1 || P < 1) return false;
  p.rows = G == 1 ? 1 : G == 2 ? 2 : kMaxRows;
  const long long slice = 2LL * P * row_bytes(D, kv_elem) + 4LL * p.rows * round4(P);
  if (slice > kMaxSmem) return false;
  p.slice = (int)slice;
  p.warps = kMaxSmem / p.slice < kWarps ? kMaxSmem / p.slice : kWarps;
  p.smem = p.warps * p.slice;
  return true;
}

// Four consecutive staged elements as float32: float and bf16 as they are,
// int8 codes times their page's scale.
__device__ __forceinline__ void load4(const float* p, float, float (&o)[4]) {
  const float4 v = lds4(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float, float (&o)[4]) {
  const float4 v = lds4(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float s, float (&o)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = static_cast<float>(c.x) * s, o[1] = static_cast<float>(c.y) * s;
  o[2] = static_cast<float>(c.z) * s, o[3] = static_cast<float>(c.w) * s;
}

// Four consecutive q elements (left of them before the row's end) from
// global memory as float32, one 16-byte (bf16: 8-byte) load where `vec`.
__device__ __forceinline__ void load_q4(const float* p, int left, bool vec, float (&o)[4]) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = e < left ? __ldg(p + e) : 0.f;
  }
}
__device__ __forceinline__ void load_q4(const __nv_bfloat16* p, int left, bool vec,
                                        float (&o)[4]) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(u.x << 16), o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16), o[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = e < left ? to_f32(p[e]) : 0.f;
  }
}

// Rows g0 .. g0 + R - 1 of q at the column slice d0 .. d0 + 3, zero past G
// and D.
template <typename TQ, int R>
__device__ __forceinline__ void load_q_rows(float (&qr)[R][4], const TQ* q, int g0, int d0, int G,
                                            int D, bool qvec) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (g0 + i < G && d0 < D) {
      load_q4(q + (int64_t)(g0 + i) * D + d0, D - d0, qvec, qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[i][e] = 0.f;
    }
  }
}

// Rows [0, n) of `src` (row r at src + r * stride elements, D elements each)
// into the warp's shared memory at dst, pitch elements a row: a row that
// starts 16-byte aligned in 16-byte cp.async copies (zero-filled past D to
// the next 16 bytes), another with plain loads (zero past D likewise).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride, int n, int D,
                                           int pitch, int lane) {
  constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte copy
  const int nq = (D + kPer - 1) / kPer;
  for (int i = lane; i < n * nq; i += 32) {
    const int r = i / nq, c = (i - r * nq) * kPer;
    const T* row = src + r * stride;
    T* d = dst + r * pitch + c;
    const int left = D - c;  // elements of this row from c on
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      const int bytes = (left < kPer ? left : kPer) * (int)sizeof(T);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(d)),
                   "l"(row + c), "r"(bytes)
                   : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) d[e] = e < left ? row[c + e] : T(0.f);
    }
  }
}

// n floats at p set to x: 16-byte stores from the first aligned float on.
__device__ __forceinline__ void fill(float* p, int n, float x, int lane) {
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2);
  head = head < n ? head : n;
  if (lane < head) p[lane] = x;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const int n4 = (n - head) >> 2;
  for (int i = lane; i < n4; i += 32) p4[i] = make_float4(x, x, x, x);
  const int tail = head + 4 * n4;
  if (tail + lane < n) p[tail + lane] = x;
}

// The transpose reduction: z holds a lane's N partial sums; each level of
// shuffles (lane bit O) keeps half of them, the lanes with bit O set the
// upper half, and adds the partner's; once a lane holds one value the rest
// is a butterfly. Afterwards lane l holds in z[0 .. max(1, N / 32)) the warp
// sums of values (l N) / 32 on (N <= 32: value l / (32 / N)).
template <int N, int C, int O>
__device__ __forceinline__ void transpose_reduce(float (&z)[N], int lane) {
  if constexpr (O > 0) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool hi = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = hi ? z[i] : z[i + H];
        const float keep = hi ? z[i + H] : z[i];
        z[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      transpose_reduce<N, H, O / 2>(z, lane);
    } else {
      z[0] += __shfl_xor_sync(0xffffffffu, z[0], O);
      transpose_reduce<N, 1, O / 2>(z, lane);
    }
  }
}

// TQ: the type of q; TKV: the pools' (TQ itself, or int8_t with scales);
// R: query rows a warp takes at once.
template <typename TQ, typename TKV, int R>
__global__ void __launch_bounds__(kWarps * 32) paged_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;  // the page of the table
  const int h = blockIdx.y, b = blockIdx.z;
  if (j >= a.n_pages) return;
  const int G = a.G, D = a.D, P = a.P;
  const int page = a.table[(int64_t)b * a.n_pages + j];
  const int pos_b = a.pos[b];
  const int64_t cell = ((int64_t)b * a.Hkv + h) * a.n_pages + j;  // (b, h, j)
  float* m_out = a.m + cell * G;
  float* l_out = a.l + cell * G;
  float* acc_out = a.acc + cell * G * D;
  const int first = j * P;  // the page's first key position
  if (page == 0 || first > pos_b || (a.window > 0 && first + P - 1 <= pos_b - a.window)) {
    for (int g = lane; g < G; g += 32) {  // the neutral partial, the pool unread
      m_out[g] = kNegInf;
      l_out[g] = 0.f;
    }
    fill(acc_out, G * D, 0.f, lane);
    return;
  }

  constexpr int N = R * kTile;             // partial scores a lane sums per tile
  constexpr int NL = N >= 32 ? N / 32 : 1;  // scores a lane holds after the reduction
  constexpr int REP = N >= 32 ? 1 : 32 / N;  // lanes that hold the same score
  constexpr int S = 32 / R;                 // softmax lanes of a query row
  const int kvp = row_bytes(D, sizeof(TKV)) / (int)sizeof(TKV);  // staged row pitch
  const int SP = round4(P);                                      // a score row's pitch
  TKV* Ks = reinterpret_cast<TKV*>(smem + warp * a.slice);       // [P][kvp]
  TKV* Vs = Ks + P * kvp;                                        // [P][kvp]
  float* Ss = reinterpret_cast<float*>(Vs + P * kvp);            // [R][SP]: scores, then p
  const int64_t row_stride = (int64_t)a.Hkv * D;  // from key t to key t + 1
  const int64_t base = (int64_t)page * P * row_stride + (int64_t)h * D;
  stage_rows(Ks, static_cast<const TKV*>(a.k_pages) + base, row_stride, P, D, kvp, lane);
  cp_async_commit();
  stage_rows(Vs, static_cast<const TKV*>(a.v_pages) + base, row_stride, P, D, kvp, lane);
  cp_async_commit();
  const float ks = a.k_scale ? a.k_scale[(int64_t)page * a.Hkv + h] : 1.f;
  const float vs = a.v_scale ? a.v_scale[(int64_t)page * a.Hkv + h] : 1.f;
  const TQ* q = static_cast<const TQ*>(a.q) + ((int64_t)b * a.Hkv + h) * G * D;
  const bool qvec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & (4 * sizeof(TQ) - 1)) == 0;
  const bool avec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(a.acc) & 15) == 0;
  float q0[R][4];  // the first row group's first column slice, in flight while K lands
  load_q_rows(q0, q, 0, 4 * lane, G, D, qvec);
  cp_async_wait<1>();  // this lane's K copies are in
  __syncwarp();        // and every lane's

  for (int g0 = 0; g0 < G; g0 += R) {
    // scores of rows g0 .. g0 + R - 1, kTile keys at a time
    for (int k0 = 0; k0 < P; k0 += kTile) {
      float z[N];
#pragma unroll
      for (int i = 0; i < N; ++i) z[i] = 0.f;
      for (int d0 = 4 * lane; d0 < D; d0 += 128) {  // no shuffle inside: lanes past D skip
        float qr[R][4];
        if (g0 == 0 && d0 < 128) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qr[i][e] = q0[i][e];
          }
        } else {
          load_q_rows(qr, q, g0, d0, G, D, qvec);
        }
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          if (k0 + t < P) {
            float kr[4];
            load4(Ks + (k0 + t) * kvp + d0, ks, kr);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              float& zi = z[i * kTile + t];
#pragma unroll
              for (int e = 0; e < 4; ++e) zi = fmaf(qr[i][e], kr[e], zi);
            }
          }
        }
      }
      transpose_reduce<N, N, 16>(z, lane);
      if (lane % REP == 0) {
#pragma unroll
        for (int r = 0; r < NL; ++r) {
          const int v = lane * N / 32 + r;  // the score this lane holds: (row, key)
          const int g = v / kTile, t = k0 + v % kTile;
          if (t < P) {
            float x = z[r] * a.scale;
            if (a.softcap != 0.f) x = a.softcap * tanhf(x * a.inv_softcap);
            Ss[g * SP + t] = visible(pos_b, first + t, 1, a.window) ? x : kNegInf;
          }
        }
      }
    }
    __syncwarp();

    {  // softmax: S lanes a query row
      const int g = lane / S, sub = lane % S;
      float* srow = Ss + g * SP;
      float mx = kNegInf;
      for (int t = sub; t < P; t += S) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int o = S / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int t = sub; t < P; t += S) {
        const float p = visible(pos_b, first + t, 1, a.window) ? expf(srow[t] - mx) : 0.f;
        srow[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = S / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (sub == 0 && g0 + g < G) {
        m_out[g0 + g] = mx;
        l_out[g0 + g] = sum;
      }
    }
    cp_async_wait<0>();  // V in (a no-op after the first group)
    __syncwarp();

    // p.v: lane l owns columns d = 4 l + 128 i of the group's rows
    for (int d0 = 4 * lane; d0 < D; d0 += 128) {
      float acc[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      }
      for (int t = 0; t < P; t += 4) {
        float pr[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 p4 = lds4(Ss + i * SP + t);
          pr[i][0] = p4.x, pr[i][1] = p4.y, pr[i][2] = p4.z, pr[i][3] = p4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (t + u < P) {
            float vr[4];
            load4(Vs + (t + u) * kvp + d0, vs, vr);
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pr[i][u], vr[e], acc[i][e]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (g0 + i >= G) break;
        float* dst = acc_out + (int64_t)(g0 + i) * D + d0;
        if (avec) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (d0 + e < D) dst[e] = acc[i][e];
          }
        }
      }
    }
    __syncwarp();  // Ss is free for the next group
  }
}

template <typename TQ, typename TKV>
const void* instance(int rows) {
  if (rows == 1) return reinterpret_cast<const void*>(&paged_kernel<TQ, TKV, 1>);
  if (rows == 2) return reinterpret_cast<const void*>(&paged_kernel<TQ, TKV, 2>);
  return reinterpret_cast<const void*>(&paged_kernel<TQ, TKV, kMaxRows>);
}

// Whether an instance may take kMaxSmem of dynamic shared memory on a device,
// a bit for each device, by [types][rows index]. At namespace scope: a
// function-local static of a template would be one object for every library
// in the process that holds the same instance.
static unsigned smem_ready[4][3];

inline cudaError_t allow_smem(const void* kernel, int types, int rows) {
  unsigned& done = smem_ready[types][rows == 1 ? 0 : rows == 2 ? 1 : 2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// types: 0 float32, 1 bf16, 2 int8 pools with float32 q, 3 with bf16 q.
template <typename TQ, typename TKV>
cudaError_t launch(Args a, int B, int types, cudaStream_t st) {
  Plan p{};
  if (B < 1 || a.Hkv < 1 || a.n_pages < 1 || B > 65535 || a.Hkv > 65535 ||
      !plan(a.G, a.D, a.P, sizeof(TKV), p)) {
    return cudaErrorInvalidValue;
  }
  a.slice = p.slice;
  const void* kernel = instance<TQ, TKV>(p.rows);
  cudaError_t err = p.smem > 48 * 1024 ? allow_smem(kernel, types, p.rows) : cudaSuccess;
  if (err == cudaSuccess) {
    void* args[] = {&a};
    const dim3 grid((a.n_pages + p.warps - 1) / p.warps, a.Hkv, B);
    err = cudaLaunchKernel(kernel, grid, dim3(32 * p.warps), args, p.smem, st);
  }
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

}  // namespace paged
}  // namespace chef

// The launch plan of the paged kernels at these shapes (kv_bytes: 4 float32,
// 2 bfloat16, 1 int8 pools): plan[0] = query rows a warp takes at once,
// plan[1] = warps (page cells) a CTA, plan[2] = keys a transpose reduction
// sums, plan[3] = bytes of dynamic shared memory a CTA. Returns an error
// where the shapes are not taken.
extern "C" int chef_paged_plan(int G, int D, int P, int kv_bytes, int* plan) {
  chef::paged::Plan p{};
  if ((kv_bytes != 1 && kv_bytes != 2 && kv_bytes != 4) ||
      !chef::paged::plan(G, D, P, kv_bytes, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan[0] = p.rows, plan[1] = p.warps, plan[2] = chef::paged::kTile, plan[3] = p.smem;
  return 0;
}

// q [B, Hkv, G, D] and the pools [N_pages, P, Hkv, D] contiguous, of one type
// (float32, or bfloat16 when bf16 != 0); table [B, n_pages] and pos [B] int32;
// m, l [B, Hkv, n_pages, G] and acc [B, Hkv, n_pages, G, D] float32 out.
// inv_softcap is 1 / softcap rounded once to float32 by the caller.
extern "C" int chef_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                    const int* table, const int* pos, float* m, float* l,
                                    float* acc, int B, int Hkv, int G, int D, int P,
                                    int n_pages, int window, float softcap, float inv_softcap,
                                    float scale, int bf16, void* stream) {
  const chef::paged::Args a{q,   k_pages, v_pages, table,   pos,    m,       l,
                            acc, Hkv,     G,       D,       P,      n_pages, window,
                            softcap, inv_softcap, scale, nullptr, nullptr, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? chef::paged::launch<__nv_bfloat16, __nv_bfloat16>(a, B, 1, st)
           : chef::paged::launch<float, float>(a, B, 0, st));
}

// The int8 mode: k_pages, v_pages [N_pages, P, Hkv, D] int8 codes, k_scale,
// v_scale [N_pages, Hkv] float32; q float32, or bfloat16 when bf16 != 0; the
// rest as chef_paged_attention.
extern "C" int chef_paged_attention_quant(const void* q, const void* k_pages,
                                          const void* v_pages, const float* k_scale,
                                          const float* v_scale, const int* table,
                                          const int* pos, float* m, float* l, float* acc, int B,
                                          int Hkv, int G, int D, int P, int n_pages, int window,
                                          float softcap, float inv_softcap, float scale, int bf16,
                                          void* stream) {
  const chef::paged::Args a{q,   k_pages, v_pages, table,   pos,     m,       l,
                            acc, Hkv,     G,       D,       P,       n_pages, window,
                            softcap, inv_softcap, scale, k_scale, v_scale, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? chef::paged::launch<__nv_bfloat16, int8_t>(a, B, 3, st)
                               : chef::paged::launch<float, int8_t>(a, B, 2, st));
}
