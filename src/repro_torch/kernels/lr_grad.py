"""Eq. 1 batch gradient of the LR head, ((softmax(Xa·wᵀ) − Y)·γ)ᵀ·Xa / N + λw.

Replaces the TPU kernel `repro/kernels/lr_grad.py::lr_grad_pallas`, which
carries the [C, D] sum across a sequential grid. The CUDA kernel
(`csrc/lr_grad.cu`, design in `csrc/lr_rowcol.cuh`) takes it in a row pass,
a column pass over fixed row chunks and a fixed-order sum of the chunks, with
no atomics. Bound on the H100: device-memory bytes, one read of Xa.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 4 + [common.INT] * 4 + [common.FLOAT] + [common.PTR] * 4


def lr_grad_plain(w, Xa, Y, weights, l2: float) -> torch.Tensor:
    """Plain PyTorch version: the reference form of the batch gradient."""
    P = torch.softmax(Xa @ w.T, dim=-1)
    R = (P - Y) * weights[:, None]
    return R.T @ Xa / Xa.shape[0] + l2 * w


def lr_grad(w, Xa, Y, weights, l2: float) -> torch.Tensor:
    """Batch gradient [C, D]: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if Xa.device.type == "cpu":
        return lr_grad_plain(w, Xa, Y, weights, l2)
    (n, d), c = Xa.shape, w.shape[0]
    device = common.check("lr_grad", c, w=(w, (c, d)), Xa=(Xa, (n, d)), Y=(Y, (n, c)),
                          weights=(weights, (n,)))
    R = Xa.new_empty(n, c)
    rows, chunks = common.chunk_rows(n, d, common.n_sms(device))
    partial = Xa.new_empty(chunks, c, d)
    out = Xa.new_empty(c, d)
    fn = build.entry("lr_grad", "chef_lr_grad", _ARGTYPES)
    common.launch("lr_grad", fn, device, w.data_ptr(), Xa.data_ptr(), Y.data_ptr(),
                  weights.data_ptr(), n, d, c, rows, float(l2), R.data_ptr(), partial.data_ptr(),
                  out.data_ptr())
    return out
