"""Model-layout adapters around the attention kernels (the serving half of
`repro/kernels/ops.py`).

The model keeps q [B, S, Hq, D] and k / v [B, S, Hkv, D]; the flash forms
take the kernel layout [B, H, S, D], which here is a transposed view (no
copy: the CUDA kernel reads through strides). The paged pools already carry
the kernel layout [N_pages, P, Hkv, D]; only q is regrouped to
[B, Hkv, G, D].

Each op has a kernel form (`flash_attention`, `paged_decode_attention`: the
CUDA kernel on a CUDA tensor) and a reference form (`*_ref`: the plain
version on any device). Both forms go through the same adapter, so they see
the same layouts, positions and merge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_reference
from repro_torch.kernels.flash_attention import flash_attention as flash_attention_kernel
from repro_torch.kernels.paged_attention import (combine_pages, paged_attention_partials,
                                                 paged_attention_partials_reference)


def _attn_blocks(Sq: int, Skv: int) -> tuple[int, int]:
    """(block_q, block_k) of the plain flash version: the largest divisor of
    each length <= 128, as the JAX package's blocked program picks them. The
    CUDA kernel picks its own tiles and ignores these."""
    def pick(S: int) -> int:
        for b in range(min(128, S), 0, -1):
            if S % b == 0:
                return b
        return 1

    return pick(Sq), pick(Skv)


def _flash_adapt(inner, q, k, v, qpos, kpos, spec):
    """Model layout in and out for both flash forms: q [B,S,H,D] ->
    [B,H,S,D] views, one block choice, int32 positions."""
    bq, bk = _attn_blocks(q.shape[1], k.shape[1])
    o = inner(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), qpos.to(torch.int32),
              kpos.to(torch.int32), causal=spec.causal, window=spec.window,
              softcap=spec.logit_softcap, block_q=bq, block_k=bk)
    return o.transpose(1, 2)


def flash_attention(q, k, v, qpos, kpos, spec) -> torch.Tensor:
    """Kernel form: [B, Sq, Hq, D] attention through the flash kernel."""
    return _flash_adapt(flash_attention_kernel, q, k, v, qpos, kpos, spec)


def flash_attention_ref(q, k, v, qpos, kpos, spec) -> torch.Tensor:
    """Reference form: the same adapter around the plain blocked program."""
    return _flash_adapt(flash_attention_reference, q, k, v, qpos, kpos, spec)


def _paged_layout(q, k_pages):
    """q [B, 1, Hq, D] -> [B, Hkv, G, D] (a view of the contiguous q)."""
    B, _, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    G = Hq // Hkv
    return q.reshape(B, Hkv, G, D), G


def paged_decode_finish(m, l, acc, q) -> torch.Tensor:
    """Merge half of the paged decode op: `combine_pages` over the partials,
    back to the model layout [B, 1, Hq, D] in q's dtype."""
    B, _, Hq, D = q.shape
    return combine_pages(m, l, acc).to(q.dtype).reshape(B, 1, Hq, D)


def _paged(partials, q, k_pages, v_pages, pages, pos, spec) -> torch.Tensor:
    qg, _ = _paged_layout(q, k_pages)
    m, l, acc = partials(qg, k_pages, v_pages, pages.to(torch.int32), pos.to(torch.int32),
                         window=spec.window, softcap=spec.logit_softcap)
    return paged_decode_finish(m, l, acc, q)


def paged_decode_attention(q, k_pages, v_pages, pages, pos, spec) -> torch.Tensor:
    """Kernel form: one-token attention over the paged cache. q [B,1,Hq,D];
    pools [N_pages, P, Hkv, D]; pages [B, n_pages]; pos [B] -> [B,1,Hq,D]."""
    return _paged(paged_attention_partials, q, k_pages, v_pages, pages, pos, spec)


def paged_decode_attention_ref(q, k_pages, v_pages, pages, pos, spec) -> torch.Tensor:
    """Reference form: the plain partials and the same merge."""
    return _paged(paged_attention_partials_reference, q, k_pages, v_pages, pages, pos, spec)
