// One chunk of the chunked (memory-efficient) GQA prefill: the flash fold
// resumed over one KV chunk (replaces the TPU kernel
// repro/kernels/chunked_prefill.py::chunked_prefill_partials_pallas, whose
// `_chunk_call` runs one chunk a pallas_call).
//
// The TPU kernel carries (m, l, acc) across a chunk's KV blocks in VMEM and
// across chunks as array inputs and outputs. Here one launch takes one
// chunk: each (q tile, q head, batch) CTA reads its rows' carry from the
// float32 carry tensors (m, l [B, Hq, Sq], acc [B, Hq, Sq, D]), walks the
// chunk's KV tiles with the flash tile program of attn_common.cuh (dead
// tiles skipped, as the flash kernel skips them) and writes the carry back
// in place, unnormalised. The first chunk's carry-in is the neutral (-1e30,
// 0, 0); after the last, the carry is the singleton split-K partial that
// `combine_pages` finishes. The caller rounds the chunk up to a multiple of
// the 64-key tile, so chunk boundaries fall on the flash kernel's tile
// boundaries and chunked-plus-merge runs the flash kernel's exact sequence
// of tile steps: the same bits for any chunk.
//
// Peak extra memory is the carry, Sq * Hq * (D + 2) floats a batch row.
// Bound on the H100: float32 operations, as the flash kernel (4 D flops a
// visible pair), plus each chunk's read and write of the carry.
#include "attn_common.cuh"

namespace chef {

template <int DMAX, typename T>
__global__ void __launch_bounds__(kFlashThreads) chunk_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  FlashCta<DMAX, T> cta(a, smem);
  cta.begin(a, true);
  for (int k0 = 0; k0 < a.Skv; k0 += kBK) cta.template tile<false>(a, k0);
  cta.write_carry(a);
}

template <int DMAX, typename T>
struct ChunkLaunch {
  static cudaError_t run(const FlashArgs& a, int B, cudaStream_t stream) {
    return launch_flash_grid<DMAX>(chunk_kernel<DMAX, T>, a, B, stream);
  }
};

}  // namespace chef

// q [B, Sq, Hq, D]; k / v this chunk's [B, Skv, Hkv, D] (Skv = the chunk's
// length), of one type (float32, or bfloat16 when bf16 != 0) with a last
// stride of 1, the other strides in elements; qpos [Sq], kpos the chunk's
// [Skv] int32; m, l [B, Hq, Sq] and acc [B, Hq, Sq, D] float32 contiguous,
// read and written in place.
extern "C" int chef_chunked_prefill(const void* q, const void* k, const void* v,
                                    const int* qpos, const int* kpos, float* m, float* l,
                                    float* acc, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, int causal,
                                    int window, float softcap, float inv_softcap, float scale,
                                    int bf16, void* stream) {
  const chef::FlashArgs a{q,    k,    v,       qpos,   kpos,    nullptr,     Sq,    Skv,
                          Hq,   Hkv,  D,       q_sb,   q_ss,    q_sh,        k_sb,  k_ss,
                          k_sh, v_sb, v_ss,    v_sh,   0,       0,           0,     causal,
                          window, softcap, inv_softcap, scale, nullptr, 0,  1,     1,
                          m,    l,    acc};
  return static_cast<int>(chef::dispatch_flash<chef::ChunkLaunch>(
      a, B, bf16, static_cast<cudaStream_t>(stream)));
}
