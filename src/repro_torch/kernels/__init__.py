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
                     decode step (merged by `combine_pages`)
  local_attention    banded flash attention (dead band tiles skipped), every
                     prefill of a sliding-window arch; its module also holds
                     block_sparse_attention (a caller's block mask)
  chunked_prefill    the flash fold over one KV chunk, carry in and out,
                     every prefill with prefill_chunk > 0 and a longer span

`ops` holds the model-layout adapters of the attention kernels.

Each module holds the kernel's wrapper, its plain PyTorch version and a note
on what it replaces and what bounds it. `build` compiles `csrc/` with nvcc;
`common.LAUNCHES` counts each kernel's launches (`build.KERNELS` names each
kernel's source).
"""
from repro_torch.kernels.common import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
