"""Model-layout adapters around the attention kernels (the serving half of
`repro/kernels/ops.py`).

The model keeps q [B, S, Hq, D] and k / v [B, S, Hkv, D]; the flash forms
take the kernel layout [B, H, S, D], which here is a transposed view (no
copy: the CUDA kernel reads through strides). The paged pools already carry
the kernel layout [N_pages, P, Hkv, D]; only q is regrouped to
[B, Hkv, G, D].

Each op has a kernel form (`flash_attention`, `local_attention`,
`block_sparse_attention`, `chunked_prefill`, `paged_decode_attention`: the
CUDA kernel on a CUDA tensor) and a reference form (`*_ref`: the plain
version on any device). Both forms go through the same adapter, so they see
the same layouts, positions and merge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chunked_prefill as chunked_lib
from repro_torch.kernels import local_attention as local_lib
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


def _kernel_layout(inner, q, k, v, qpos, kpos, spec, **extra):
    """Call a flash-layout form: q [B,S,H,D] -> [B,H,S,D] views, one block
    choice, int32 positions; returns what `inner` returns."""
    bq, bk = _attn_blocks(q.shape[1], k.shape[1])
    return inner(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), qpos.to(torch.int32),
                 kpos.to(torch.int32), causal=spec.causal, window=spec.window,
                 softcap=spec.logit_softcap, block_q=bq, block_k=bk, **extra)


def _flash_adapt(inner, q, k, v, qpos, kpos, spec, **extra):
    """Model layout in and out for the flash-shaped forms (flash, local,
    block-sparse)."""
    return _kernel_layout(inner, q, k, v, qpos, kpos, spec, **extra).transpose(1, 2)


def flash_attention(q, k, v, qpos, kpos, spec) -> torch.Tensor:
    """Kernel form: [B, Sq, Hq, D] attention through the flash kernel."""
    return _flash_adapt(flash_attention_kernel, q, k, v, qpos, kpos, spec)


def flash_attention_ref(q, k, v, qpos, kpos, spec) -> torch.Tensor:
    """Reference form: the same adapter around the plain blocked program."""
    return _flash_adapt(flash_attention_reference, q, k, v, qpos, kpos, spec)


def local_attention(q, k, v, qpos, kpos, spec) -> torch.Tensor:
    """Kernel form: [B, Sq, Hq, D] banded attention (whole KV blocks outside
    the causal / window band skipped); flash attention's result."""
    return _flash_adapt(local_lib.local_attention, q, k, v, qpos, kpos, spec)


def local_attention_ref(q, k, v, qpos, kpos, spec) -> torch.Tensor:
    """Reference form: the same adapter around the plain banded program."""
    return _flash_adapt(local_lib.local_attention_reference, q, k, v, qpos, kpos, spec)


def attn_block_mask_shape(Sq: int, Skv: int) -> tuple[int, int]:
    """(nq, nk) of the block mask `block_sparse_attention` takes for Sq
    queries over Skv keys: the blocks of `_attn_blocks`."""
    bq, bk = _attn_blocks(Sq, Skv)
    return Sq // bq, Skv // bk


def block_sparse_attention(q, k, v, qpos, kpos, block_mask, spec) -> torch.Tensor:
    """Kernel form: [B, Sq, Hq, D] attention with the KV blocks that have a 0
    in `block_mask` ([nq, nk], see `attn_block_mask_shape`) skipped; causal
    and window still mask elements inside enabled blocks."""
    return _flash_adapt(local_lib.block_sparse_attention, q, k, v, qpos, kpos, spec,
                        block_mask=block_mask.to(torch.int32).contiguous())


def block_sparse_attention_ref(q, k, v, qpos, kpos, block_mask, spec) -> torch.Tensor:
    """Reference form: the plain program, the same blocks skipped."""
    return _flash_adapt(local_lib.block_sparse_attention_reference, q, k, v, qpos, kpos, spec,
                        block_mask=block_mask)


def chunked_prefill_partials(q, k, v, qpos, kpos, spec, chunk: int):
    """Kernel half of the chunked-prefill op: the flash fold run chunk by
    chunk, its final carry as the singleton partials m, l [B, Hq, 1, Sq] and
    acc [B, Hq, 1, Sq, D] float32 (kernel layout)."""
    return _kernel_layout(chunked_lib.chunked_prefill_partials, q, k, v, qpos, kpos, spec,
                          chunk=chunk)


def chunked_prefill_partials_ref(q, k, v, qpos, kpos, spec, chunk: int):
    """Reference form of `chunked_prefill_partials`: the plain fold."""
    return _kernel_layout(chunked_lib.chunked_prefill_partials_reference, q, k, v, qpos, kpos,
                          spec, chunk=chunk)


def chunked_prefill_finish(m, l, acc, q) -> torch.Tensor:
    """Merge half of the chunked-prefill op: `combine_pages` over the
    singleton partial (weights exp(0) = 1, so flash's finalize), in q's dtype
    and the model layout [B, Sq, Hq, D]."""
    return combine_pages(m, l, acc).to(q.dtype).transpose(1, 2)


def chunked_prefill(q, k, v, qpos, kpos, spec, chunk: int) -> torch.Tensor:
    """Kernel form: chunked GQA prefill, O(Sq * chunk) live scores; flash
    attention's result for any chunk."""
    m, l, acc = chunked_prefill_partials(q, k, v, qpos, kpos, spec, chunk)
    return chunked_prefill_finish(m, l, acc, q)


def chunked_prefill_ref(q, k, v, qpos, kpos, spec, chunk: int) -> torch.Tensor:
    """Reference form: the plain partials and the same merge."""
    m, l, acc = chunked_prefill_partials_ref(q, k, v, qpos, kpos, spec, chunk)
    return chunked_prefill_finish(m, l, acc, q)


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
