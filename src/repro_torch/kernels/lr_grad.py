"""Eq. 1 batch gradient of the LR head, ((softmax(Xa·wᵀ) − Y)·γ)ᵀ·Xa / N + λw.

Replaces the TPU kernel `repro/kernels/lr_grad.py::lr_grad_pallas`, which
carries the [C, D] sum across a sequential grid. Bound on the H100:
device-memory bytes, one read of Xa (the validation gradient at mimic's 579
rows, D 2049: 4.75 MB, 1.4 us), under the latency of one launch. The CUDA
kernel (`csrc/lr_grad.cu`, design in `csrc/lr_gather.cuh`, mode kGrad over
contiguous rows) is one launch a call that reads each row once, on
`common.gather_plan`'s plan: a handful of rows go to the few-rows kernel,
more to the many-rows cooperative grid of up to two CTAs an SM and one a
row, whose [grid, C, D] partials (written and read again in L2) are added
in CTA order after a grid barrier. The order is fixed by the shapes and the
SM count, with no atomics, so a result repeats bit for bit on the card. On
the H100 a grid of fewer CTAs with more rows each was slower at every
Table 3 validation shape (chip_smoke.py's lr_grad phase): each CTA's rows
are a serial chain of loads, and the partials stay in L2.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 4 + [common.INT] * 5 + [common.FLOAT] + [common.PTR] * 3


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
    few, grid = common.gather_plan(n, d, c, common.n_sms(device))
    partial = None if few else Xa.new_empty(grid, c, d)  # kept alive past the launch
    out = Xa.new_empty(c, d)
    fn = build.entry("lr_grad", "chef_lr_grad", _ARGTYPES)
    common.launch("lr_grad", fn, device, w.data_ptr(), Xa.data_ptr(), Y.data_ptr(),
                  weights.data_ptr(), n, d, c, grid, few, float(l2),
                  None if few else partial.data_ptr(), out.data_ptr())
    return out
