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
// and a table entry equal to the trash page 0 writes the neutral partial
// (-1e30, 0, 0) without reading the pool. The caller merges the pages with
// `combine_pages` (plain PyTorch, shared with the plain version).
//
// The TPU kernel runs the (b, h, page) grid in order and DMAs one page per
// step through the scalar-prefetched table. Here every (page, kv head, slot)
// cell is its own CTA (grid n_pages x Hkv x B, 128 threads), since the
// partials are independent: no carry, no atomics, so the result repeats bit
// for bit. A CTA stages q [G, D] and the page's K and V rows [P, D] in shared
// memory as float32 (bf16 widened on load), computes each of the G x P
// scores with one warp (lane-strided products, a fixed shuffle tree), then
// one thread per query row takes the row's max and sum over the P keys in
// order, and one thread per (g, d) sums p . v over the P keys in order.
// Nothing assumes a page size: the default is P = 8 (ServeConfig).
//
// Bound on the H100: device-memory bytes, one read of every valid page's K
// and V rows of one head (2 * P * D * 4 bytes a page in float32) plus the
// partials written; the 4 * G * P * D flops a page are far below the
// float32 rate for G <= 8.
#include "attn_common.cuh"

namespace chef {

constexpr int kPagedThreads = 128;

struct PagedArgs {
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
};

template <typename T>
__global__ void __launch_bounds__(kPagedThreads) paged_partials_kernel(PagedArgs a) {
  extern __shared__ float smem[];
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G, D = a.D, P = a.P;
  const int64_t cell = ((int64_t)b * a.Hkv + h) * a.n_pages + j;  // (b, h, j)
  float* m_out = a.m + cell * G;
  float* l_out = a.l + cell * G;
  float* acc_out = a.acc + cell * G * D;
  const int page = a.table[(int64_t)b * a.n_pages + j];
  if (page == 0) {  // trash page: the neutral partial, the pool unread
    for (int g = tid; g < G; g += kPagedThreads) {
      m_out[g] = kNegInf;
      l_out[g] = 0.f;
    }
    for (int i = tid; i < G * D; i += kPagedThreads) acc_out[i] = 0.f;
    return;
  }
  float* Qs = smem;         // [G][D]
  float* Ks = Qs + G * D;   // [P][D]
  float* Vs = Ks + P * D;   // [P][D]
  float* Ss = Vs + P * D;   // [G][P]: scores, then p
  const T* q = static_cast<const T*>(a.q) + ((int64_t)b * a.Hkv + h) * G * D;
  const int64_t row_stride = (int64_t)a.Hkv * D;  // from key t to key t + 1
  const int64_t base = (int64_t)page * P * row_stride + (int64_t)h * D;
  const T* k = static_cast<const T*>(a.k_pages) + base;
  const T* v = static_cast<const T*>(a.v_pages) + base;
  for (int i = tid; i < G * D; i += kPagedThreads) Qs[i] = to_f32(q[i]);
  for (int i = tid; i < P * D; i += kPagedThreads) {
    const int t = i / D, d = i % D;
    Ks[i] = to_f32(k[t * row_stride + d]);
    Vs[i] = to_f32(v[t * row_stride + d]);
  }
  __syncthreads();

  const int pos_b = a.pos[b];
  for (int e = warp; e < G * P; e += kPagedThreads / 32) {
    const int g = e / P, t = e % P;
    float x = 0.f;
    for (int d = lane; d < D; d += 32) x = fmaf(Qs[g * D + d], Ks[t * D + d], x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) {
      x *= a.scale;
      if (a.softcap != 0.f) x = a.softcap * tanhf(x * a.inv_softcap);
      const int kp = j * P + t;
      Ss[e] = visible(pos_b, kp, 1, a.window) ? x : kNegInf;
    }
  }
  __syncthreads();

  for (int g = tid; g < G; g += kPagedThreads) {
    float* srow = Ss + g * P;
    float mx = kNegInf;
    for (int t = 0; t < P; ++t) mx = fmaxf(mx, srow[t]);
    float sum = 0.f;
    for (int t = 0; t < P; ++t) {
      const float p = visible(pos_b, j * P + t, 1, a.window) ? expf(srow[t] - mx) : 0.f;
      srow[t] = p;
      sum += p;
    }
    m_out[g] = mx;
    l_out[g] = sum;
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kPagedThreads) {
    const int g = i / D, d = i % D;
    float x = 0.f;
    for (int t = 0; t < P; ++t) x = fmaf(Ss[g * P + t], Vs[t * D + d], x);
    acc_out[i] = x;
  }
}

template <typename T>
cudaError_t launch_paged(const PagedArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)a.G * a.D + 2 * (size_t)a.P * a.D + a.G * a.P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_partials_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.n_pages, a.Hkv, B);
  paged_partials_kernel<T><<<grid, kPagedThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace chef

// q [B, Hkv, G, D] and the pools [N_pages, P, Hkv, D] contiguous, of one type
// (float32, or bfloat16 when bf16 != 0); table [B, n_pages] and pos [B] int32;
// m, l [B, Hkv, n_pages, G] and acc [B, Hkv, n_pages, G, D] float32 out.
// inv_softcap is 1 / softcap rounded once to float32 by the caller.
extern "C" int chef_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                    const int* table, const int* pos, float* m, float* l,
                                    float* acc, int B, int Hkv, int G, int D, int P,
                                    int n_pages, int window, float softcap, float inv_softcap,
                                    float scale, int bf16, void* stream) {
  const chef::PagedArgs a{q, k_pages, v_pages, table,  pos,     m,           l,    acc, Hkv,
                          G, D,       P,       n_pages, window, softcap, inv_softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? chef::launch_paged<__nv_bfloat16>(a, B, st)
                               : chef::launch_paged<float>(a, B, st));
}
