"""Single-token GQA decode attention over the ring KV cache, with a validity
mask over the ring's slots.

q [B, Hkv, G, D] (one token a sequence, grouped by kv head); k, v
[B, W, Hkv, D], the ring in the model's layout; valid [W] bool, the slots
that hold an attendable token (`models.attention.ring_valid`). For each
(b, kv head): s = q.k^T * scale, then the softcap; s = -1e30 where !valid;
p = valid ? exp(s - max s) : 0; o = p.v / max(sum p, 1e-30), in q's dtype.

Replaces the TPU kernel
`repro/kernels/decode_attention.py::decode_attention_pallas`, whose grid is
(B, Hkv) with the whole ring of a head in one cell. That grid would be 2
CTAs on 132 SMs at RecurrentGemma-9B's decode shape (B 2, one kv head), so
the CUDA kernel (`csrc/decode_attention.cu`) splits the ring into chunks of
`CHUNK` slots, one CTA a (chunk, kv head, batch) cell writing a partial
softmax (m, l, acc), and merges the chunks in a second kernel of the same
call, in a fixed order with no atomics: the result repeats bit for bit. It
reads the ring through its strides, so the cache is never transposed. Bound
on the H100: device-memory bytes, one read of the ring's K and V.

The plain version, `decode_attention_reference`, is the JAX package's
`_decode_cell` arithmetic over every (b, kv head) at once (one softmax over
the whole ring); the kernel's split softmax differs from it by float
rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

NEG_INF = -1e30
CHUNK = 32  # ring slots a CTA reads: csrc/decode_attention.cu kDecodeChunk
MAX_SMEM = 232_448  # the H100's opt-in shared memory a block can use

_ARGTYPES = ([common.PTR] * 5 + [common.INT] * 6 + [common.INT64] * 6 + [common.FLOAT] * 3
             + [common.PTR] * 3 + [common.INT, common.PTR])


def decode_attention_reference(q, k, v, valid, *, softcap: float = 0.0,
                               scale: float = None) -> torch.Tensor:
    """Plain PyTorch version of `_decode_cell` over every (b, kv head): q
    [B, Hkv, G, D]; k, v [B, W, Hkv, D]; valid [W] bool -> [B, Hkv, G, D] in
    q's dtype, the arithmetic in float32."""
    D = q.shape[-1]
    kt = k.float().permute(0, 2, 1, 3)  # [B, Hkv, W, D]
    vt = v.float().permute(0, 2, 1, 3)
    s = (q.float() @ kt.transpose(-1, -2)) * float(scale or D**-0.5)  # [B, Hkv, G, W]
    if softcap:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    o = (p @ vt) / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return o.to(q.dtype)


def decode_attention(q, k, v, valid, *, softcap: float = 0.0) -> torch.Tensor:
    """Decode attention [B, Hkv, G, D] in q's dtype: the kernel on a CUDA
    tensor, the plain version on a CPU tensor. q contiguous; k, v any
    [B, W, Hkv, D] views with a last stride of 1, of q's float type; valid
    [W] bool."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, valid, softcap=softcap)
    B, Hkv, G, D = q.shape
    W = k.shape[1]
    smem = 4 * (G * D + 2 * CHUNK * D + G * CHUNK) + CHUNK
    if smem > MAX_SMEM:
        raise ValueError(f"decode_attention: G {G} x D {D} needs {smem} B of shared memory, "
                         f"more than the {MAX_SMEM} B a block can use")
    device = common.check_attention(
        "decode_attention", q=(q, (B, Hkv, G, D), "float", True),
        k=(k, (B, W, Hkv, D), "float", False), v=(v, (B, W, Hkv, D), "float", False))
    if valid.dtype != torch.bool or tuple(valid.shape) != (W,) or valid.device != device:
        raise ValueError(f"decode_attention: valid must be a bool tensor of shape ({W},) on "
                         f"{device}, got {valid.dtype} {tuple(valid.shape)} on {valid.device}")
    valid = valid.contiguous()
    n_split = -(-W // CHUNK)
    m = torch.empty(B, Hkv, n_split, G, device=device)
    l = torch.empty_like(m)
    acc = torch.empty(B, Hkv, n_split, G, D, device=device)
    out = torch.empty_like(q)
    fn = build.entry("decode_attention", "chef_decode_attention", _ARGTYPES)
    common.launch("decode_attention", fn, device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  valid.data_ptr(), out.data_ptr(), B, Hkv, G, D, W, n_split,
                  k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
                  float(softcap), 1.0 / softcap if softcap else 0.0, D**-0.5, m.data_ptr(),
                  l.data_ptr(), acc.data_ptr(), int(q.dtype == torch.bfloat16))
    return out
