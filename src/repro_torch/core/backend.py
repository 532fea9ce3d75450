"""Backend dispatch for the CHEF hot loops.

One frozen `Backend`, chosen once per run (`ChefConfig.backend` or an
explicit override) and passed down, carries the loop's ops:

  lr_grad(w, Xa, Y, weights, l2)         -> [C, d+1]  Eq. 1 batch gradient
  lr_hvp(w, v, Xa, weights, l2, P=None)  -> [C, d+1]  H(w)v (CG inner loop)
  infl_scores(v, Xa, P, Y, gamma)        -> [N, C]    Eq. 6 score matrix
  probs_scores(w, v, Xa, Y, gamma)       -> [N, C]    probs, then Eq. 6
  minibatch_grad(w, Xa, Y, weights, idx, l2) -> [C, d+1]  the sgd_train step
                                                      and the explicit replay steps
  replay_correction(w, Xa, Y_old, Y_new, w_old, w_new, corr_idx, corr_mask,
                    batch_size)          -> [C, d+1]  DeltaGrad-L Eq. 4 correction
  probs(w, Xa)                           -> [N, C]    softmax(Xa wᵀ)

Serving ops, in the model layout (q [B,S,Hq,D]; k, v [B,S,Hkv,D]):

  flash_attention(q, k, v, qpos, kpos, spec)  -> [B,Sq,Hq,D]  every prefill
                                                 and tail prefill of a
                                                 full-attention arch
  local_attention(q, k, v, qpos, kpos, spec)  -> [B,Sq,Hq,D]  every prefill
                                                 of a windowed arch (dead
                                                 band blocks skipped)
  chunked_prefill(q, k, v, qpos, kpos, spec, chunk)
                                              -> [B,Sq,Hq,D]  a prefill with
                                                 ServeConfig.prefill_chunk
                                                 > 0 and Skv > chunk
  block_sparse_attention(q, k, v, qpos, kpos, block_mask, spec)
                                              -> [B,Sq,Hq,D]  a caller's
                                                 [nq, nk] block mask
  paged_decode_attention(q, k_pages, v_pages, pages, pos, spec)
                                              -> [B,1,Hq,D]   every decode step
                                                 over the paged cache
  quant_paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, pages,
                               pos, spec)     -> [B,1,Hq,D]   the same over
                                                 int8 page pools
  decode_attention(q, k, v, valid, spec)      -> [B,1,Hq,D]   every decode step
                                                 over the ring cache

  reference  plain PyTorch on any device: the semantic oracle.
  cuda       the hand-written kernels of `repro_torch.kernels`. Each wrapper
             computes its kernel's plain version for CPU tensors only; for
             CUDA tensors it launches the kernel or raises.

The two agree to float32 rounding; choosing one is a question of speed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

BACKENDS = ("reference", "cuda")


@dataclass(frozen=True)
class Backend:
    """Dispatch object for the loop's ops (frozen and hashable)."""

    name: str = "reference"

    def __post_init__(self):
        if self.name not in BACKENDS:
            raise ValueError(f"unknown backend {self.name!r}; expected one of {BACKENDS}")

    def lr_grad(self, w, Xa, Y, weights, l2: float) -> torch.Tensor:
        """Eq. 1 batch gradient of the weighted LR objective -> [C, d+1]."""
        if self.name == "reference":
            from repro_torch.core import lr_head

            return lr_head.grad_reference(w, Xa, Y, weights, l2)
        from repro_torch.kernels.lr_grad import lr_grad

        return lr_grad(w, Xa, Y, weights, l2)

    def lr_hvp(self, w, v, Xa, weights, l2: float, P=None) -> torch.Tensor:
        """H(w)v -> [C, d+1]. P optionally carries precomputed probs; the
        kernel recomputes them in its row pass and ignores P."""
        if self.name == "reference":
            from repro_torch.core import lr_head

            return lr_head.hvp_reference(w, v, Xa, weights, l2, P=P)
        from repro_torch.kernels.lr_hvp import lr_hvp

        return lr_hvp(w, v, Xa, weights, l2)

    def infl_scores(self, v, Xa, P, Y, gamma: float) -> torch.Tensor:
        """Eq. 6 INFL score matrix [N, C]."""
        if self.name == "reference":
            from repro_torch.core.influence import infl_scores_reference

            return infl_scores_reference(v, Xa, P, Y, gamma)
        from repro_torch.kernels.infl_scores import infl_scores

        return infl_scores(v, Xa, P, Y, gamma)

    def probs_scores(self, w, v, Xa, Y, gamma: float) -> torch.Tensor:
        """P = softmax(Xa wᵀ), then the Eq. 6 scores [N, C]."""
        return self.infl_scores(v, Xa, self.probs(w, Xa), Y, gamma)

    def minibatch_grad(self, w, Xa, Y, weights, idx, l2: float) -> torch.Tensor:
        """Gathered mini-batch gradient over B_t = Xa[idx] (Eq. 4 left term)."""
        if self.name == "reference":
            from repro_torch.core import lr_head

            return lr_head.minibatch_grad_reference(w, Xa, Y, weights, idx, l2)
        from repro_torch.kernels.minibatch_grad import minibatch_grad

        return minibatch_grad(w, Xa, Y, weights, idx, l2)

    def replay_correction(self, w, Xa, Y_old, Y_new, w_old, w_new, corr_idx, corr_mask,
                          batch_size: int) -> torch.Tensor:
        """DeltaGrad-L replay correction over the changed slots of B_t (Eq. 4
        right term); padded slots (corr_mask == 0) add exactly zero."""
        if self.name == "reference":
            from repro_torch.core import deltagrad

            return deltagrad.replay_correction_reference(w, Xa, Y_old, Y_new, w_old, w_new,
                                                         corr_idx, corr_mask, batch_size)
        from repro_torch.kernels.replay_correction import replay_correction

        return replay_correction(w, Xa, Y_old, Y_new, w_old, w_new, corr_idx, corr_mask,
                                 batch_size)

    def flash_attention(self, q, k, v, qpos, kpos, spec) -> torch.Tensor:
        """Prefill attention: q [B,Sq,Hq,D]; k, v [B,Skv,Hkv,D]; qpos [Sq] and
        kpos [Skv] absolute positions; `spec` an `AttnSpec` (causal, window,
        logit softcap) -> [B,Sq,Hq,D]."""
        from repro_torch.kernels import ops

        if self.name == "reference":
            return ops.flash_attention_ref(q, k, v, qpos, kpos, spec)
        return ops.flash_attention(q, k, v, qpos, kpos, spec)

    def chunked_prefill(self, q, k, v, qpos, kpos, spec, chunk: int) -> torch.Tensor:
        """Chunked prefill attention: `flash_attention`'s signature plus the
        KV chunk; its result for any chunk, with O(Sq * chunk) live scores.
        The partials' `combine_pages` merge is the same function on both
        backends."""
        from repro_torch.kernels import ops

        if self.name == "reference":
            return ops.chunked_prefill_ref(q, k, v, qpos, kpos, spec, chunk)
        return ops.chunked_prefill(q, k, v, qpos, kpos, spec, chunk)

    def local_attention(self, q, k, v, qpos, kpos, spec) -> torch.Tensor:
        """Banded (sliding-window) prefill attention: `flash_attention` with
        the KV blocks outside the causal / window band skipped, so O(Sq *
        window) live work; the same result."""
        from repro_torch.kernels import ops

        if self.name == "reference":
            return ops.local_attention_ref(q, k, v, qpos, kpos, spec)
        return ops.local_attention(q, k, v, qpos, kpos, spec)

    def block_sparse_attention(self, q, k, v, qpos, kpos, block_mask, spec) -> torch.Tensor:
        """Block-sparse prefill attention: KV blocks with a 0 in `block_mask`
        ([nq, nk] at `ops.attn_block_mask_shape`) skipped; causal / window
        still mask elements inside enabled blocks. An all-ones mask gives
        `flash_attention`."""
        from repro_torch.kernels import ops

        if self.name == "reference":
            return ops.block_sparse_attention_ref(q, k, v, qpos, kpos, block_mask, spec)
        return ops.block_sparse_attention(q, k, v, qpos, kpos, block_mask, spec)

    def paged_decode_attention(self, q, k_pages, v_pages, pages, pos, spec) -> torch.Tensor:
        """One-token attention over the paged cache: q [B,1,Hq,D]; pools
        [N_pages, P, Hkv, D]; pages [B, n_pages] block table; pos [B] per-slot
        positions (the cache already holds position pos) -> [B,1,Hq,D]."""
        from repro_torch.kernels import ops

        if self.name == "reference":
            return ops.paged_decode_attention_ref(q, k_pages, v_pages, pages, pos, spec)
        return ops.paged_decode_attention(q, k_pages, v_pages, pages, pos, spec)

    def quant_paged_decode_attention(self, q, k_pages, v_pages, k_scale, v_scale, pages, pos,
                                     spec) -> torch.Tensor:
        """`paged_decode_attention` over int8 pools: k_pages / v_pages
        [N_pages, P, Hkv, D] int8 codes, k_scale / v_scale [N_pages, Hkv]
        float32 per-(page, head) scales, dequantized where the pages are
        read (no dense float copy of the pool)."""
        from repro_torch.kernels import ops

        if self.name == "reference":
            return ops.quant_paged_decode_attention_ref(q, k_pages, v_pages, k_scale, v_scale,
                                                        pages, pos, spec)
        return ops.quant_paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, pages,
                                                pos, spec)

    def decode_attention(self, q, k, v, valid, spec) -> torch.Tensor:
        """One-token attention over the ring cache: q [B,1,Hq,D]; k, v
        [B,W,Hkv,D] the ring's contents (dequantized for an int8 ring);
        valid [W] the attendable slots (`models.attention.ring_valid`) ->
        [B,1,Hq,D]."""
        from repro_torch.kernels import ops

        if self.name == "reference":
            return ops.decode_attention_ref(q, k, v, valid, spec)
        return ops.decode_attention(q, k, v, valid, spec)

    def unsharded(self) -> "Backend":
        """The backend for small side computations (the validation gradient).
        The port has no sharded backend yet, so this is `self`."""
        return self

    def probs(self, w, Xa) -> torch.Tensor:
        """softmax(Xa wᵀ) -> [N, C]."""
        from repro_torch.core import lr_head

        return lr_head.probs(w, Xa)


def get_backend(spec: Union[Backend, str, None] = None) -> Backend:
    """Resolve a spec (Backend | name | None) to a Backend; None -> reference,
    as in the JAX package."""
    if isinstance(spec, Backend):
        return spec
    return Backend(spec or "reference")
