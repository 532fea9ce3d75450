"""Gathered mini-batch gradient, the step of `sgd_train` (Eq. 4, left term):
((softmax(Xa[B]·wᵀ) − Y[B])·γ[B])ᵀ·Xa[B] / |B| + λw with B = idx.

Replaces the TPU kernel
`repro/kernels/minibatch_grad.py::minibatch_grad_pallas`. Bound on the H100:
device-memory bytes, one read of the bs gathered rows (at the mimic widths,
bs = 2000 and D = 2049, 16.4 MB: 4.9 us), with C flops a byte, under the
float32 CUDA cores' ridge. The CUDA kernel (`csrc/minibatch_grad.cu`, design
in `csrc/lr_gather.cuh`) is one launch a call that reads each batch row once,
through idx, so the gathered [bs, D] batch never reaches device memory: a
cooperative grid of about two CTAs an SM, each streaming its rows through
shared memory (the next rows' copies in flight) into its partial sum in
registers, then, after a grid barrier, the CTAs' partials added in CTA order
(`common.gather_plan`). The
order is fixed by the shapes and the SM count, with no atomics, so
`sgd_train` repeats bit for bit on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 5 + [common.INT] * 5 + [common.FLOAT] + [common.PTR] * 3


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
    few, grid = common.gather_plan(bs, d, c, common.n_sms(device))
    partial = None if few else Xa.new_empty(grid, c, d)  # kept alive past the launch
    out = Xa.new_empty(c, d)
    fn = build.entry("minibatch_grad", "chef_minibatch_grad", _ARGTYPES)
    common.launch("minibatch_grad", fn, device, w.data_ptr(), Xa.data_ptr(), Y.data_ptr(),
                  weights.data_ptr(), idx.data_ptr(), bs, d, c, grid, few, float(l2),
                  None if few else partial.data_ptr(), out.data_ptr())
    return out
