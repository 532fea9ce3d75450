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
// 2 CTAs on 132 SMs. Here the ring is cut into chunks of kDecodeChunk slots.
// Pass 1 gives each (chunk, kv head, sequence) cell its own CTA (grid
// n_split x Hkv x B, 256 threads), which stages q [G, D] and its chunk's K
// and V rows in shared memory as float32 (bf16 widened on load), read from
// the ring in the model layout [B, W, Hkv, D] through its strides (the cache
// is never transposed), and writes the chunk's partial softmax (m, l, acc)
// exactly as the paged kernel does for a page: a warp a score (lane-strided
// products, a fixed shuffle tree), one thread a query row for max and sum in
// slot order, one thread a (g, d) for p.v in slot order. A chunk with no
// valid slot gives the neutral partial (-1e30, 0, 0). Pass 2, launched by
// the same call, merges the chunks: one CTA a (g, kv head, sequence) row
// stages the chunks' m and l in shared memory (loaded in parallel), takes
// M = max of the m, weights exp(m - M), then l and acc summed in chunk
// order, out = acc / max(l, 1e-30) in q's type. No atomics: the result
// repeats bit for bit.
//
// Bound on the H100: device-memory bytes, one read of the ring's K and V of
// each (sequence, kv head) (2 W D 4 bytes in float32); the 4 G W D flops are
// far below the float32 rate for the G <= 16 of the serving archs.
#include "attn_common.cuh"

namespace chef {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeChunk = 32;  // ring slots of a pass-1 CTA
constexpr int kMergeThreads = 256;

struct DecodeArgs {
  const void* q;               // [B, Hkv, G, D] contiguous
  const void* k;               // [B, W, Hkv, D] through strides
  const void* v;
  const unsigned char* valid;  // [W] bool
  void* out;                   // [B, Hkv, G, D] in q's type
  int Hkv, G, D, W, n_split;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float softcap, inv_softcap, scale;
  float* m;                    // [B, Hkv, n_split, G] scratch
  float* l;
  float* acc;                  // [B, Hkv, n_split, G, D] scratch
};

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads) decode_partials_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  __shared__ bool ok[kDecodeChunk];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G, D = a.D;
  const int t0 = c * kDecodeChunk;
  const int n = min(kDecodeChunk, a.W - t0);  // slots of this chunk
  const int64_t cell = ((int64_t)b * a.Hkv + h) * a.n_split + c;  // (b, h, c)
  float* Qs = smem;                     // [G][D]
  float* Ks = Qs + G * D;               // [kDecodeChunk][D]
  float* Vs = Ks + kDecodeChunk * D;    // [kDecodeChunk][D]
  float* Ss = Vs + kDecodeChunk * D;    // [G][kDecodeChunk]: scores, then p
  const T* q = static_cast<const T*>(a.q) + ((int64_t)b * a.Hkv + h) * G * D;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + (int64_t)t0 * a.k_ss + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + (int64_t)t0 * a.v_ss + h * a.v_sh;
  for (int i = tid; i < G * D; i += kDecodeThreads) Qs[i] = to_f32(q[i]);
#pragma unroll 4
  for (int i = tid; i < n * D; i += kDecodeThreads) {
    const int t = i / D, d = i % D;
    Ks[i] = to_f32(k[t * a.k_ss + d]);
    Vs[i] = to_f32(v[t * a.v_ss + d]);
  }
  for (int t = tid; t < n; t += kDecodeThreads) ok[t] = a.valid[t0 + t] != 0;
  __syncthreads();

  for (int e = warp; e < G * n; e += kDecodeThreads / 32) {
    const int g = e / n, t = e % n;
    float x = 0.f;
    for (int d = lane; d < D; d += 32) x = fmaf(Qs[g * D + d], Ks[t * D + d], x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) {
      x *= a.scale;
      if (a.softcap != 0.f) x = a.softcap * tanhf(x * a.inv_softcap);
      Ss[g * kDecodeChunk + t] = ok[t] ? x : kNegInf;
    }
  }
  __syncthreads();

  for (int g = tid; g < G; g += kDecodeThreads) {
    float* srow = Ss + g * kDecodeChunk;
    float mx = kNegInf;
    for (int t = 0; t < n; ++t) mx = fmaxf(mx, srow[t]);
    float sum = 0.f;
    for (int t = 0; t < n; ++t) {
      const float p = ok[t] ? expf(srow[t] - mx) : 0.f;
      srow[t] = p;
      sum += p;
    }
    a.m[cell * G + g] = mx;
    a.l[cell * G + g] = sum;
  }
  __syncthreads();

  float* acc_out = a.acc + cell * G * D;
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    float x = 0.f;
    for (int t = 0; t < n; ++t) x = fmaf(Ss[g * kDecodeChunk + t], Vs[t * D + d], x);
    acc_out[i] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads) decode_merge_kernel(DecodeArgs a) {
  extern __shared__ float w[];  // [n_split]: m of each chunk, then its weight exp(m - M)
  float* ls = w + a.n_split;    // [n_split]: l of each chunk
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.G, D = a.D;
  const int64_t base = ((int64_t)b * a.Hkv + h) * a.n_split;  // chunk 0 of (b, h)
  for (int c = threadIdx.x; c < a.n_split; c += kMergeThreads) {  // the loads in parallel
    w[c] = a.m[(base + c) * G + g];
    ls[c] = a.l[(base + c) * G + g];
  }
  __syncthreads();
  float M = kNegInf;  // every thread the same, in chunk order
  for (int c = 0; c < a.n_split; ++c) M = fmaxf(M, w[c]);
  __syncthreads();
  for (int c = threadIdx.x; c < a.n_split; c += kMergeThreads) w[c] = expf(w[c] - M);
  __syncthreads();
  float lt = 0.f;
  for (int c = 0; c < a.n_split; ++c) lt = fmaf(ls[c], w[c], lt);
  lt = fmaxf(lt, 1e-30f);
  T* out = static_cast<T*>(a.out) + (((int64_t)b * a.Hkv + h) * G + g) * D;
  const float* acc = a.acc + (base * G + g) * D;
  const int64_t cstride = (int64_t)G * D;  // from chunk c to chunk c + 1
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float x = 0.f;
#pragma unroll 8
    for (int c = 0; c < a.n_split; ++c) x = fmaf(acc[c * cstride + d], w[c], x);
    store(out + d, x / lt);
  }
}

template <typename T>
cudaError_t launch_decode(const DecodeArgs& a, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)a.G * a.D + 2 * (size_t)kDecodeChunk * a.D + a.G * kDecodeChunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partials_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_partials_kernel<T><<<dim3(a.n_split, a.Hkv, B), kDecodeThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t wbytes = 2 * sizeof(float) * (size_t)a.n_split;
  if (wbytes > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_merge_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wbytes);
    if (err != cudaSuccess) return err;
  }
  decode_merge_kernel<T><<<dim3(a.G, a.Hkv, B), kMergeThreads, wbytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace chef

// q [B, Hkv, G, D] contiguous; k, v [B, W, Hkv, D] with the given (batch,
// slot, head) strides in elements and a last stride of 1, of q's type
// (float32, or bfloat16 when bf16 != 0); valid [W] bool; out [B, Hkv, G, D]
// in q's type; m, l [B, Hkv, n_split, G] and acc [B, Hkv, n_split, G, D]
// float32 scratch, n_split = ceil(W / 32). inv_softcap is 1 / softcap rounded
// once to float32 by the caller.
extern "C" int chef_decode_attention(const void* q, const void* k, const void* v,
                                     const unsigned char* valid, void* out, int B, int Hkv,
                                     int G, int D, int W, int n_split, long long k_sb,
                                     long long k_ss, long long k_sh, long long v_sb,
                                     long long v_ss, long long v_sh, float softcap,
                                     float inv_softcap, float scale, float* m, float* l,
                                     float* acc, int bf16, void* stream) {
  const chef::DecodeArgs a{q, k, v, valid, out, Hkv, G, D, W, n_split, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, softcap, inv_softcap, scale, m, l, acc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? chef::launch_decode<__nv_bfloat16>(a, B, st)
                               : chef::launch_decode<float>(a, B, st));
}
