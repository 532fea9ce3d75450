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
// here one CTA owns one (q tile, q head, batch) cell and loops over every KV
// tile itself, testing each with the band predicate: the flash tile program
// of attn_common.cuh (64 x 64 tiles, (m, l, acc) in shared memory and
// registers, masks from the positions only, dead tiles skipped).
//
// Bound on the H100: for a prefill at S = 256 with D = 128 the scores and the
// value product are 4 * S^2 * D flops a head in float32 (no tensor cores in
// this first version) against 4 * S * D * 4 bytes of q, k, v and out, so it
// is bound by operations at the 67 TFLOP/s float32 rate.
#include "attn_common.cuh"

namespace chef {

template <int DMAX, typename T>
__global__ void __launch_bounds__(kFlashThreads) flash_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  FlashCta<DMAX, T> cta(a, smem);
  cta.begin(a, false);
  for (int k0 = 0; k0 < a.Skv; k0 += kBK) cta.template tile<false>(a, k0);
  cta.write_out(a);
}

template <int DMAX, typename T>
struct FlashLaunch {
  static cudaError_t run(const FlashArgs& a, int B, cudaStream_t stream) {
    return launch_flash_grid<DMAX>(flash_kernel<DMAX, T>, a, B, stream);
  }
};

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
  const chef::FlashArgs a{q,    k,    v,    qpos, kpos, out,  Sq,     Skv,    Hq,      Hkv,
                          D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,    v_sh,
                          o_sb, o_ss, o_sh, causal, window, softcap, inv_softcap, scale};
  return static_cast<int>(chef::dispatch_flash<chef::FlashLaunch>(
      a, B, bf16, static_cast<cudaStream_t>(stream)));
}
