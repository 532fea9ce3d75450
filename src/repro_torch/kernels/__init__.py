"""Hand-written CUDA kernels for Hopper (sm_90a): the CHEF cleaning loop's
and the serving paths'.

  lr_grad            Eq. 1 batch gradient (validation gradient)
  lr_hvp             H(w)v, the CG inner loop
  minibatch_grad     gathered mini-batch gradient, the sgd_train step and the
                     explicit DeltaGrad-L replay steps
  infl_scores        Eq. 6 score matrix
  replay_correction  DeltaGrad-L correction over a batch's changed rows, every
                     replay step
  flash_attention    GQA flash attention, every prefill and tail prefill
  paged_attention    per-page decode partials through a block table, every
                     decode step (merged by `combine_pages`); its module also
                     holds paged_attention_quant, the same over int8 pools
                     with per-(page, head) scales
  decode_attention   one-token attention over the ring cache with a slot
                     mask, every decode step of a local / ring layer
  local_attention    banded flash attention (dead band tiles skipped), every
                     prefill of a sliding-window arch; its module also holds
                     block_sparse_attention (a caller's block mask)
  chunked_prefill    the flash fold over one KV chunk, carry in and out,
                     every prefill with prefill_chunk > 0 and a longer span

`ops` holds the model-layout adapters of the attention kernels.

Each module holds the kernel's wrapper, its plain PyTorch version and a note
on what it replaces and what bounds it. lr_hvp, minibatch_grad and
replay_correction share `csrc/lr_gather.cuh` (one launch a call, each row
read once); lr_grad runs `csrc/lr_rowcol.cuh`'s three passes; the flash,
banded, block-sparse and chunked kernels share `csrc/attn_common.cuh`. `build` compiles `csrc/` with nvcc;
`common.LAUNCHES` counts each kernel's launches (`build.KERNELS` names each
kernel's source).
"""
from repro_torch.kernels.common import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
