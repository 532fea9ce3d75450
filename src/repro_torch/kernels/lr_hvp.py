"""Hessian-vector product of the LR head, the CG inner loop:
H(w)v = sᵀ·Xa / N + λv with s = γ(p⊙u − p(p·u)), p = softmax(Xa·wᵀ),
u = Xa·vᵀ.

Replaces the TPU kernel `repro/kernels/lr_hvp.py::lr_hvp_pallas`, which
carries the [C, D] sum across a sequential grid. The CUDA kernel
(`csrc/lr_hvp.cu`, design in `csrc/lr_rowcol.cuh`) takes it in a row pass,
a column pass over fixed row chunks and a fixed-order sum of the chunks, with
no atomics. Bound on the H100: device-memory bytes, one read of Xa.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 4 + [common.INT] * 4 + [common.FLOAT] + [common.PTR] * 4


def lr_hvp_plain(w, v, Xa, weights, l2: float, P: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the reference form of H(w)v. P may carry
    precomputed probs (the reference backend's CG passes them)."""
    if P is None:
        P = torch.softmax(Xa @ w.T, dim=-1)
    U = Xa @ v.T
    S = P * U - P * torch.sum(P * U, dim=-1, keepdim=True)
    S = S * weights[:, None]
    return S.T @ Xa / Xa.shape[0] + l2 * v


def lr_hvp(w, v, Xa, weights, l2: float) -> torch.Tensor:
    """H(w)v [C, D]: the kernel on a CUDA tensor (probs recomputed inside),
    the plain version on a CPU tensor."""
    if Xa.device.type == "cpu":
        return lr_hvp_plain(w, v, Xa, weights, l2)
    (n, d), c = Xa.shape, w.shape[0]
    device = common.check("lr_hvp", c, w=(w, (c, d)), v=(v, (c, d)), Xa=(Xa, (n, d)),
                          weights=(weights, (n,)))
    R = Xa.new_empty(n, c)
    rows, chunks = common.chunk_rows(n, d, common.n_sms(device))
    partial = Xa.new_empty(chunks, c, d)
    out = Xa.new_empty(c, d)
    fn = build.entry("lr_hvp", "chef_lr_hvp", _ARGTYPES)
    common.launch("lr_hvp", fn, device, w.data_ptr(), v.data_ptr(), Xa.data_ptr(),
                  weights.data_ptr(), n, d, c, rows, float(l2), R.data_ptr(), partial.data_ptr(),
                  out.data_ptr())
    return out
