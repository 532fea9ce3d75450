"""Chunked (memory-efficient) GQA prefill: the flash fold split into KV
chunks, resumable through its carry, in the kernel layout q [B, Hq, Sq, D],
k / v [B, Hkv, Skv, D].

Each chunk takes the online-softmax carry (m, l, acc) in and gives it back
updated; after the last chunk the carry is a singleton split-K partial, m, l
[B, Hq, 1, Sq] and acc [B, Hq, 1, Sq, D] float32, which the caller finishes
with `paged_attention.combine_pages` (ops.chunked_prefill_finish). Chunk
boundaries are block-aligned (`chunk_blocks`), so the chunked fold steps the
same blocks in the same order as the full flash program, and the singleton
merge is exactly flash's finalize (weights exp(0) = 1): the result is flash
attention's for any chunk. Only O(Sq * chunk) scores are live at a time; the
carry, Sq * Hq * (D + 2) floats a batch row, is the extra memory.

Replaces the TPU kernel `repro/kernels/chunked_prefill.py::
chunked_prefill_partials_pallas` (one `_chunk_call` a chunk). The CUDA kernel
(`csrc/chunked_prefill.cu`) is one launch a chunk: each CTA reads its rows'
carry, walks the chunk's KV tiles with the flash kernel's tile program and
writes the carry back in place. The host loop over chunks lives here, as in
the JAX package. The chunk rounds up to a multiple of the kernel's 64-key
tile, so the chunks end on the flash kernel's tile boundaries. Bound on the
H100: float32 operations, as flash (4 D flops a visible pair).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.flash_attention import (NEG_INF, _kv_block_step, _strides, check_inputs,
                                                 mask_args)

KV_TILE = 64  # csrc/attn_common.cuh: kBK, the keys of the kernel's KV tile

_ARGTYPES = ([common.PTR] * 8 + [common.INT] * 6 + [common.INT64] * 9 + [common.INT] * 2
             + [common.FLOAT] * 3 + [common.INT, common.PTR])


def chunk_blocks(chunk: int, block_k: int) -> int:
    """The chunk rounded up to a multiple of block_k (at least one block), so
    that chunk boundaries fall on block boundaries (the JAX package's rule)."""
    return max(block_k, -(-int(chunk) // block_k) * block_k)


def _neutral_carry(q):
    B, Hq, Sq, D = q.shape
    dev = q.device
    return (torch.full((B, Hq, Sq), NEG_INF, device=dev), torch.zeros(B, Hq, Sq, device=dev),
            torch.zeros(B, Hq, Sq, D, device=dev))


def chunked_prefill_partials_reference(q, k, v, qpos, kpos, *, causal: bool = True,
                                       window: int = 0, softcap: float = 0.0, chunk: int,
                                       block_q: int = 128, block_k: int = 128):
    """Plain PyTorch version: the blocked `_kv_block_step` fold, one loop a
    chunk over the chunk's KV blocks, each step taking every q block at once
    (batched over (B, Hkv, G) with the kv head broadcast). -> (m [B, Hq, 1,
    Sq], l [B, Hq, 1, Sq], acc [B, Hq, 1, Sq, D]) float32."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    assert Sq % block_q == 0 and Skv % block_k == 0, (Sq, Skv, block_q, block_k)
    nq = Sq // block_q
    c = chunk_blocks(chunk, block_k)
    qf = q.float().reshape(B, Hkv, G, nq, block_q, D)
    kf = k.float()[:, :, None, None]  # [B, Hkv, 1, 1, Skv, D]
    vf = v.float()[:, :, None, None]
    qpb = qpos.reshape(nq, block_q)
    m, l, acc = (x.reshape(B, Hkv, G, nq, block_q, *x.shape[3:]) for x in _neutral_carry(q))
    carry = (m, l, acc)
    for start in range(0, Skv, c):
        for k0 in range(start, min(start + c, Skv), block_k):
            carry = _kv_block_step(carry, qf, kf[..., k0:k0 + block_k, :],
                                   vf[..., k0:k0 + block_k, :], qpb, kpos[k0:k0 + block_k],
                                   scale=D**-0.5, causal=causal, window=window,
                                   softcap=float(softcap))
    m, l, acc = carry
    return (m.reshape(B, Hq, 1, Sq), l.reshape(B, Hq, 1, Sq), acc.reshape(B, Hq, 1, Sq, D))


def chunked_prefill_partials(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
                             softcap: float = 0.0, chunk: int, block_q: int = 128,
                             block_k: int = 128):
    """The singleton partials (m, l, acc) of the chunked fold: the kernel on a
    CUDA tensor, one launch for each chunk of chunk_blocks(chunk, KV_TILE)
    keys; the plain version (with blocks `block_q`, `block_k`) on a CPU
    tensor. Inputs as `flash_attention.flash_attention` takes them."""
    if q.device.type == "cpu":
        return chunked_prefill_partials_reference(q, k, v, qpos, kpos, causal=causal,
                                                  window=window, softcap=softcap, chunk=chunk,
                                                  block_q=block_q, block_k=block_k)
    device = check_inputs("chunked_prefill", q, k, v, qpos, kpos)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    m, l, acc = _neutral_carry(q)
    fn = build.entry("chunked_prefill", "chef_chunked_prefill", _ARGTYPES)
    c = chunk_blocks(chunk, KV_TILE)
    for start in range(0, Skv, c):
        stop = min(start + c, Skv)
        kc, vc, kp = k[:, :, start:stop], v[:, :, start:stop], kpos[start:stop]
        common.launch("chunked_prefill", fn, device, q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                      qpos.data_ptr(), kp.data_ptr(), m.data_ptr(), l.data_ptr(),
                      acc.data_ptr(), B, Sq, stop - start, Hq, Hkv, D, *_strides(q),
                      *_strides(kc), *_strides(vc), *mask_args(causal, window, softcap, D),
                      int(q.dtype == torch.bfloat16))
    return m[:, :, None], l[:, :, None], acc[:, :, None]
