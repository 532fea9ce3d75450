"""Gathered mini-batch gradient, the step of `sgd_train` (Eq. 4, left term):
((softmax(Xa[B]·wᵀ) − Y[B])·γ[B])ᵀ·Xa[B] / |B| + λw with B = idx.

Replaces the TPU kernel
`repro/kernels/minibatch_grad.py::minibatch_grad_pallas`. The CUDA kernel
(`csrc/minibatch_grad.cu`, design in `csrc/lr_rowcol.cuh`) reads the batch
rows through idx inside both passes, so the gathered [bs, D] batch never
reaches device memory, and sums in a fixed order with no atomics, so
`sgd_train` repeats bit for bit on the card. Bound on the H100: device-memory
bytes, one read of the bs gathered rows; at the mimic widths (bs = 2000) that
is a few microseconds, so launch overhead weighs as much as the work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 5 + [common.INT] * 4 + [common.FLOAT] + [common.PTR] * 4


def minibatch_grad_plain(w, Xa, Y, weights, idx, l2: float) -> torch.Tensor:
    """Plain PyTorch version: gather, then the batch gradient."""
    xb, yb, wb = Xa[idx], Y[idx], weights[idx]
    P = torch.softmax(xb @ w.T, dim=-1)
    return ((P - yb) * wb[:, None]).T @ xb / idx.shape[0] + l2 * w


def minibatch_grad(w, Xa, Y, weights, idx, l2: float) -> torch.Tensor:
    """Mini-batch gradient [C, D]: the kernel on a CUDA tensor, the plain
    version on a CPU tensor. `idx` holds int64 row ids in [0, N); callers
    check the range once for a whole schedule (`lr_head.sgd_train`)."""
    if Xa.device.type == "cpu":
        return minibatch_grad_plain(w, Xa, Y, weights, idx, l2)
    (n, d), c, bs = Xa.shape, w.shape[0], idx.shape[0]
    device = common.check("minibatch_grad", c, w=(w, (c, d)), Xa=(Xa, (n, d)), Y=(Y, (n, c)),
                          weights=(weights, (n,)), idx=(idx, (bs,)))
    R = Xa.new_empty(bs, c)
    rows, chunks = common.chunk_rows(bs, d, common.n_sms(device))
    partial = Xa.new_empty(chunks, c, d)
    out = Xa.new_empty(c, d)
    fn = build.entry("minibatch_grad", "chef_minibatch_grad", _ARGTYPES)
    common.launch("minibatch_grad", fn, device, w.data_ptr(), Xa.data_ptr(), Y.data_ptr(),
                  weights.data_ptr(), idx.data_ptr(), bs, d, c, rows, float(l2), R.data_ptr(),
                  partial.data_ptr(), out.data_ptr())
    return out
