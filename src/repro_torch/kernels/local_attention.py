"""Banded (sliding-window) and block-sparse GQA flash attention, in the kernel
layout q [B, Hq, Sq, D], k / v [B, Hkv, Skv, D].

Both are the flash program with whole KV blocks that can contribute nothing
skipped:

* `local_attention` skips blocks that the causal / window band masks
  entirely, by a predicate on the blocks' position extremes (`band_live`),
  so a sliding-window prefill does O(Sq * window) live work instead of
  O(Sq * Skv).
* `block_sparse_attention` also skips blocks a caller's [nq, nk] block mask
  disables (0 entries); causal / window still mask elements inside enabled
  blocks, so an all-ones mask gives flash and the band's mask gives local.

A skipped block is an exact no-op on the online-softmax carry (m stays, alpha
= exp(0) = 1, p = 0), so both equal flash attention for the same spec.

Replaces the TPU kernels `repro/kernels/local_attention.py::
local_attention_pallas` and `::block_sparse_attention_pallas`. The CUDA
kernels (`csrc/local_attention.cu`) run the flash kernel's tile program
(`csrc/attn_common.cuh`); each CTA walks only its band's range of KV tiles,
and the block-sparse kernel masks elements by the caller's mask at the
caller's block granularity (`block_q`, `block_k`), which need not be the
kernel's 64 x 64 tiles. Bound on the H100: float32 operations, 4 D flops a
visible (query, key) pair, which the tile program runs on the tensor cores
in split TF32 (165 TFLOP/s a float32 product), the band's next K/V tile in
flight while a tile is folded.

The plain versions mirror the JAX package's `_banded_reference`: the blocked
`_kv_block_step` program over the caller's blocks, dead blocks skipped. The
skip set comes from one host copy of the positions (and the mask) per call,
and each KV block steps every live q block at once, so a long prefill takes
one batched step per KV block rather than one host decision per block pair.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import (ARGTYPES, NEG_INF, _kv_block_step,
                                                 launch_flash_layout)

# chef_block_sparse_attention's: chef_local_attention's plus the mask
# pointer, its width and its block sizes, before the bf16 flag
_SPARSE_ARGTYPES = (ARGTYPES[:-2] + [common.PTR, common.INT, common.INT, common.INT]
                    + ARGTYPES[-2:])


def band_live(qp, kp, *, causal: bool, window: int):
    """Whether each (q block, KV block) cell can hold any visible pair (the
    JAX package's `_band_live`, for every cell at once): qp [nq, BQ], kp
    [nk, BK] positions -> [nq, nk] bool. Conservative: false only where the
    causal / window band masks the whole cell."""
    qp, kp = np.asarray(qp, np.int64), np.asarray(kp, np.int64)
    live = np.ones((qp.shape[0], kp.shape[0]), bool)
    if causal:
        live &= qp.max(-1)[:, None] >= kp.min(-1)[None, :]
    if window:
        live &= qp.min(-1)[:, None] - kp.max(-1)[None, :] < window
    return live


def _live_blocks(mask, qpos, kpos, nq: int, nk: int, causal: bool, window: int) -> np.ndarray:
    """[nq, nk] bool: the blocks the plain version steps, from one host copy
    of the positions and the mask."""
    parts = [qpos.reshape(-1).to(torch.int64), kpos.reshape(-1).to(torch.int64)]
    if mask is not None:
        parts.append(mask.reshape(-1).to(torch.int64))
    host = torch.cat(parts).cpu().numpy()
    Sq, Skv = qpos.numel(), kpos.numel()
    live = band_live(host[:Sq].reshape(nq, -1), host[Sq:Sq + Skv].reshape(nk, -1),
                     causal=causal, window=window)
    if mask is not None:
        live &= host[Sq + Skv:].reshape(nq, nk) != 0
    return live


def _banded_reference(mask, q, k, v, qpos, kpos, *, causal, window, softcap, block_q, block_k):
    """The plain blocked program: every live (q block, KV block) cell steps
    `_kv_block_step` in KV order, dead cells are skipped. Batched over
    (B, Hkv, G) with the kv head broadcast to its G query heads, and over the
    live q blocks of each KV block (a slice where they are consecutive)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    assert Sq % block_q == 0 and Skv % block_k == 0, (Sq, Skv, block_q, block_k)
    nq, nk = Sq // block_q, Skv // block_k
    if mask is not None:
        assert tuple(mask.shape) == (nq, nk), (tuple(mask.shape), nq, nk)
    live = _live_blocks(mask, qpos, kpos, nq, nk, causal, window)
    qf = q.float().reshape(B, Hkv, G, nq, block_q, D)
    kf = k.float()[:, :, None, None]  # [B, Hkv, 1, 1, Skv, D]
    vf = v.float()[:, :, None, None]
    qpb = qpos.reshape(nq, block_q)
    m = qf.new_full((B, Hkv, G, nq, block_q), NEG_INF)
    l = qf.new_zeros(B, Hkv, G, nq, block_q)
    acc = qf.new_zeros(B, Hkv, G, nq, block_q, D)
    # each KV block's live q blocks; those that are not one run go to the
    # device in one copy
    runs = [np.flatnonzero(live[:, ki]) for ki in range(nk)]
    scattered = [r for r in runs if r.size and r[-1] - r[0] + 1 != r.size]
    ids = torch.as_tensor(np.concatenate(scattered) if scattered else np.zeros(0, np.int64),
                          device=q.device)
    offset = 0
    for ki, rows in enumerate(runs):
        if not rows.size:
            continue
        if rows[-1] - rows[0] + 1 == rows.size:
            sel = slice(int(rows[0]), int(rows[-1]) + 1)
        else:
            sel = ids[offset:offset + rows.size]
            offset += rows.size
        k0 = ki * block_k
        m_new, l_new, acc_new = _kv_block_step(
            (m[..., sel, :], l[..., sel, :], acc[..., sel, :, :]), qf[..., sel, :, :],
            kf[..., k0:k0 + block_k, :], vf[..., k0:k0 + block_k, :], qpb[sel],
            kpos[k0:k0 + block_k], scale=D**-0.5, causal=causal, window=window,
            softcap=float(softcap))
        m[..., sel, :], l[..., sel, :], acc[..., sel, :, :] = m_new, l_new, acc_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def local_attention_reference(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
                              softcap: float = 0.0, block_q: int = 128,
                              block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version of `local_attention` -> [B, Hq, Sq, D] in q's
    dtype (float32 arithmetic)."""
    return _banded_reference(None, q, k, v, qpos, kpos, causal=causal, window=window,
                             softcap=softcap, block_q=block_q, block_k=block_k)


def block_sparse_attention_reference(q, k, v, qpos, kpos, *, block_mask, causal: bool = True,
                                     window: int = 0, softcap: float = 0.0, block_q: int = 128,
                                     block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version of `block_sparse_attention`: the blocks are the
    mask's, so a live block is one whole enabled mask cell."""
    return _banded_reference(block_mask, q, k, v, qpos, kpos, causal=causal, window=window,
                             softcap=softcap, block_q=block_q, block_k=block_k)


def local_attention(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Banded attention [B, Hq, Sq, D]: the kernel on a CUDA tensor, the plain
    version (with blocks `block_q`, `block_k`) on a CPU tensor. Inputs as
    `flash_attention.flash_attention` takes them."""
    if q.device.type == "cpu":
        return local_attention_reference(q, k, v, qpos, kpos, causal=causal, window=window,
                                         softcap=softcap, block_q=block_q, block_k=block_k)
    return launch_flash_layout("local_attention", "chef_local_attention", ARGTYPES, q, k, v,
                               qpos, kpos, causal=causal, window=window, softcap=softcap)


def block_sparse_attention(q, k, v, qpos, kpos, *, block_mask, causal: bool = True,
                           window: int = 0, softcap: float = 0.0, block_q: int = 128,
                           block_k: int = 128) -> torch.Tensor:
    """Block-sparse attention [B, Hq, Sq, D]: KV blocks with a 0 in
    `block_mask` [Sq / block_q, Skv / block_k] are skipped; the kernel on a
    CUDA tensor (the mask int32 and contiguous on the same card), the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return block_sparse_attention_reference(q, k, v, qpos, kpos, block_mask=block_mask,
                                                causal=causal, window=window, softcap=softcap,
                                                block_q=block_q, block_k=block_k)
    Sq, Skv = q.shape[2], k.shape[2]
    if Sq % block_q or Skv % block_k:
        raise ValueError(f"block_sparse_attention: blocks {block_q} x {block_k} do not divide "
                         f"{Sq} x {Skv}")
    nq, nk = Sq // block_q, Skv // block_k
    common.check_attention("block_sparse_attention",
                           q=(q, tuple(q.shape), "float", False),
                           block_mask=(block_mask, (nq, nk), "int32", True))
    return launch_flash_layout("block_sparse_attention", "chef_block_sparse_attention",
                               _SPARSE_ARGTYPES, q, k, v, qpos, kpos, causal=causal,
                               window=window, softcap=softcap,
                               extra=(block_mask.data_ptr(), nk, block_q, block_k))

