// Banded (sliding-window) and block-sparse GQA flash attention (replaces the
// TPU kernels repro/kernels/local_attention.py::local_attention_pallas and
// ::block_sparse_attention_pallas, which share `_banded_call`).
//
// Both compute what chef_flash_attention computes, with whole KV tiles that
// can contribute nothing skipped:
//
//   * local: before its loop each CTA finds the first and the last KV tile
//     that the band predicate (`_band_live`: causal and window from the
//     tiles' position extremes) keeps live, one warp per tile over kpos, and
//     walks only that range. A sliding-window prefill thus does O(Sq *
//     window) work and reads only the K/V in its band, where the flash kernel
//     visits every tile of Skv and tests each.
//   * block-sparse: the caller's block mask [nq, nk] is at the caller's
//     granularity (blocks of mask_bq x mask_bk elements, `ops._attn_blocks`:
//     100-row blocks at Sq = 200, say), not the kernel's 64 x 64 tiles. So
//     element (i, j) is masked where mask[i / mask_bq][j / mask_bk] == 0,
//     and a tile is skipped only when every mask cell it covers is 0 (or the
//     band kills it). Causal and window still mask elements inside enabled
//     cells; a row with no enabled key gives 0.
//
// The tile step (scores, softcap, masks, online softmax, P.V) is the flash
// kernel's own (attn_common.cuh), and a skipped tile is an exact no-op, so
// local equals flash for the same spec bit for bit, as block-sparse does
// with an all-ones mask, and block-sparse with the band's block mask equals
// local.
//
// Bound on the H100: float32 operations, 4 D flops a visible (query, key)
// pair (a StarCoder2 prefill at 8192 tokens with window 4096: 25.2 M visible
// pairs a head), against one read of q, of the band's K/V and one write of
// out. The tile program runs them on the tensor cores in split TF32 (165
// TFLOP/s a float32 product, not the CUDA cores' 67), with the band's next
// K/V tile in flight while a tile is folded, in 64-row CTAs (four warps, or
// four pairs of warps at D 256) so that each K/V tile of the band is staged
// once for 64 rows; the diagonal tiles of the band compute their masked
// halves too.
#include "attn_common.cuh"

namespace chef {

// range[0], range[1] = the first and last KV tile the band keeps live for
// the CTA's rows (range[0] > range[1] where none is).
__device__ __forceinline__ void band_range(const FlashArgs& a, int qmin, int qmax, int* range) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    range[0] = INT_MAX;
    range[1] = -1;
  }
  __syncthreads();
  const int ntiles = (a.Skv + kBK - 1) / kBK;
  for (int t = warp; t < ntiles; t += blockDim.x / 32) {
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int c = lane; c < kBK; c += 32) {
      const int j = t * kBK + c;
      if (j < a.Skv) {
        const int kp = a.kpos[j];
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
    }
    if (lane == 0 && band_live(a, qmin, qmax, kmin, kmax)) {
      atomicMin(&range[0], t);
      atomicMax(&range[1], t);
    }
  }
  __syncthreads();
}

template <int DMAX, typename T, bool kMask>
__global__ void __launch_bounds__(BandTile<DMAX, T>::L::kThreads) banded_kernel(FlashArgs a) {
  extern __shared__ float4 smem[];  // 16-byte aligned
  __shared__ int range[2];
  BandTile<DMAX, T> cta(a, reinterpret_cast<unsigned char*>(smem));
  cta.begin(a, false);
  band_range(a, cta.qmin, cta.qmax, range);
  cta.template run<kMask>(a, range[0], range[1] + 1);
  cta.write_out(a);
}

template <int DMAX, typename T>
struct LocalLaunch {
  static cudaError_t run(const FlashArgs& a, int B, cudaStream_t stream) {
    return launch_flash_grid<BandTile<DMAX, T>>(banded_kernel<DMAX, T, false>, a, B, stream);
  }
};

template <int DMAX, typename T>
struct SparseLaunch {
  static cudaError_t run(const FlashArgs& a, int B, cudaStream_t stream) {
    return launch_flash_grid<BandTile<DMAX, T>>(banded_kernel<DMAX, T, true>, a, B, stream);
  }
};

}  // namespace chef

// The arguments of chef_flash_attention (same layouts and types).
extern "C" int chef_local_attention(const void* q, const void* k, const void* v,
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
  return static_cast<int>(chef::dispatch_flash<chef::LocalLaunch>(
      a, B, bf16, static_cast<cudaStream_t>(stream)));
}

// chef_local_attention's arguments plus the block mask [Sq / mask_bq,
// mask_nk] int32 (contiguous), mask_nk = Skv / mask_bk.
extern "C" int chef_block_sparse_attention(
    const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out,
    int B, int Sq, int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    int window, float softcap, float inv_softcap, float scale, const int* mask, int mask_nk,
    int mask_bq, int mask_bk, int bf16, void* stream) {
  const chef::FlashArgs a{q,    k,    v,    qpos, kpos, out,  Sq,     Skv,    Hq,      Hkv,
                          D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,    v_sh,
                          o_sb, o_ss, o_sh, causal, window, softcap, inv_softcap, scale,
                          mask, mask_nk, mask_bq, mask_bk};
  return static_cast<int>(chef::dispatch_flash<chef::SparseLaunch>(
      a, B, bf16, static_cast<cudaStream_t>(stream)));
}
