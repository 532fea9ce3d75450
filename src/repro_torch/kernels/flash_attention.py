"""GQA flash attention forward (causal by positions, optional sliding window
and logit softcap), in the kernel layout q [B, Hq, Sq, D], k / v
[B, Hkv, Skv, D].

Replaces the TPU kernel
`repro/kernels/flash_attention.py::flash_attention_pallas`. The CUDA kernel
(`csrc/flash_attention.cu`) gives each (q tile, q head, batch) cell its own
CTA, which loops over the KV tiles with the online-softmax (m, l, acc) in
shared memory and registers; it reads and writes the model layout through
strides, takes any Sq and Skv, masks from the position tensors only, and
skips KV tiles in which nothing can be visible. Bound on the H100 at the
serving shapes: float32 operations (4 D flops a visible (query, key) pair).

The plain version, `flash_attention_reference`, is the JAX package's blocked
program: `_kv_block_step`'s arithmetic over the block decomposition the
caller picks (`ops._attn_blocks`). The kernel picks its own H100 tiles; the
two differ by float rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # csrc/flash_attention.cu: the largest DMAX instance

# chef_flash_attention's (and chef_local_attention's) argument types
ARGTYPES = ([common.PTR] * 6 + [common.INT] * 6 + [common.INT64] * 12 + [common.INT] * 2
             + [common.FLOAT] * 3 + [common.INT, common.PTR])


def _kv_block_step(carry, q, k, v, qp, kp, *, scale: float, causal: bool, window: int,
                   softcap: float):
    """One online-softmax KV step: q [..., BQ, D]; k, v [..., BK, D] (the
    leading dims broadcast); qp [..., BQ] (one q block, or several stacked
    in front) and kp [BK] positions -> the new (m, l, acc)."""
    m_prev, l_prev, acc_prev = carry
    s = (q @ k.transpose(-1, -2)) * scale  # [..., BQ, BK]
    if softcap:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    mask = torch.ones(qp.shape + kp.shape, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[..., :, None] >= kp[None, :]
    if window:
        mask &= qp[..., :, None] - kp[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(torch.clamp(m_prev - m_new, max=0.0))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc = acc_prev * alpha[..., None] + p @ v
    return m_new, l_new, acc


def flash_attention_reference(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
                              softcap: float = 0.0, block_q: int = 128,
                              block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the blocked online-softmax program of the JAX
    package's `flash_attention_reference`, batched over (B, Hkv, G) with the
    kv head broadcast to its G query heads (K/V never repeated). Returns
    [B, Hq, Sq, D] in q's dtype; the arithmetic is float32."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    assert Sq % block_q == 0 and Skv % block_k == 0, (Sq, Skv, block_q, block_k)
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    out = qf.new_empty(B, Hkv, G, Sq, D)
    for q0 in range(0, Sq, block_q):
        carry = (qf.new_full((B, Hkv, G, block_q), NEG_INF), qf.new_zeros(B, Hkv, G, block_q),
                 qf.new_zeros(B, Hkv, G, block_q, D))
        for k0 in range(0, Skv, block_k):
            carry = _kv_block_step(carry, qf[..., q0:q0 + block_q, :], kf[..., k0:k0 + block_k, :],
                                   vf[..., k0:k0 + block_k, :], qpos[q0:q0 + block_q],
                                   kpos[k0:k0 + block_k], scale=D**-0.5, causal=causal,
                                   window=window, softcap=float(softcap))
        _, l, acc = carry
        out[..., q0:q0 + block_q, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, sequence, head) strides of a kernel-layout [B, H, S, D] view."""
    return t.stride(0), t.stride(2), t.stride(1)


def check_inputs(kernel: str, q, k, v, qpos, kpos) -> torch.device:
    """The flash-layout kernels' input check (q [B, Hq, Sq, D], k / v
    [B, Hkv, Skv, D] views with a last stride of 1, int32 positions, a whole
    query group per kv head, D <= MAX_HEAD_DIM). Returns the device."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv or D > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: {Hq} query heads over {Hkv} kv heads, head dim {D}; "
                         f"the kernel takes a whole group per kv head and D <= {MAX_HEAD_DIM}")
    return common.check_attention(
        kernel, q=(q, (B, Hq, Sq, D), "float", False),
        k=(k, (B, Hkv, Skv, D), "float", False), v=(v, (B, Hkv, Skv, D), "float", False),
        qpos=(qpos, (Sq,), "int32", True), kpos=(kpos, (Skv,), "int32", True))


def mask_args(causal: bool, window: int, softcap: float, D: int) -> tuple:
    """(causal, window, softcap, 1 / softcap, scale) as the kernels take them:
    1 / softcap rounded once to float32, as the JAX kernel's
    s * (1.0 / softcap) rounds it."""
    return (int(causal), int(window), float(softcap), 1.0 / softcap if softcap else 0.0,
            D**-0.5)


def launch_flash_layout(kernel: str, symbol: str, argtypes, q, k, v, qpos, kpos, *,
                        causal: bool, window: int, softcap: float, extra=()) -> torch.Tensor:
    """Check the inputs, allocate the output as a view of a [B, Sq, Hq, D]
    tensor and launch `symbol`, whose arguments are chef_flash_attention's
    with `extra` before the bf16 flag."""
    device = check_inputs(kernel, q, k, v, qpos, kpos)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = q.new_empty(B, Sq, Hq, D).transpose(1, 2)
    fn = build.entry(kernel, symbol, argtypes)
    common.launch(kernel, fn, device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  qpos.data_ptr(), kpos.data_ptr(), out.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
                  *_strides(q), *_strides(k), *_strides(v), *_strides(out),
                  *mask_args(causal, window, softcap, D), *extra,
                  int(q.dtype == torch.bfloat16))
    return out


def flash_attention(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Attention [B, Hq, Sq, D]: the kernel on a CUDA tensor, the plain version
    (with blocks `block_q`, `block_k`) on a CPU tensor. q, k, v may be any
    strided views with a last stride of 1 (the model layout transposed); on
    the card the result is a view of a [B, Sq, Hq, D] tensor. qpos, kpos are
    int32."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, qpos, kpos, causal=causal, window=window,
                                         softcap=softcap, block_q=block_q, block_k=block_k)
    return launch_flash_layout("flash_attention", "chef_flash_attention", ARGTYPES, q, k, v,
                               qpos, kpos, causal=causal, window=window, softcap=softcap)
