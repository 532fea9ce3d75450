"""Hessian-vector product of the LR head, the CG inner loop:
H(w)v = sᵀ·Xa / N + λv with s = γ(p⊙u − p(p·u)), p = softmax(Xa·wᵀ),
u = Xa·vᵀ.

Replaces the TPU kernel `repro/kernels/lr_hvp.py::lr_hvp_pallas`, which
carries the [C, D] sum across a sequential grid. Bound on the H100:
device-memory bytes, one read of Xa (at the mimic widths, N = 78,487 and
D = 2049, 643 MB: 0.192 ms), with 3C flops a byte, under the float32 CUDA
cores' ridge. The CUDA kernel (`csrc/lr_hvp.cu`, design in
`csrc/lr_gather.cuh`, mode kHvp) is one launch a call that reads each row
once: a cooperative grid of about two CTAs an SM (`common.gather_plan`),
each streaming its contiguous rows through shared memory into a [C, D]
partial (in registers where a thread's columns of w, v and the partial fit
them, as at C <= 2 and D 2049; else in scratch, added to once for each
group of rows), then, after a grid barrier, the CTAs' partials added in CTA
order. The order is fixed by the shapes and the SM count, with no
atomics, so a CG solve repeats bit for bit on the card. Slow where the
partial lives in scratch: on the H100 at N 78,487 and D 2049, C 16 takes
2.4 ms, more than this module's plain version (1.4 ms; C 2: 0.27 ms).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 4 + [common.INT] * 4 + [common.FLOAT] + [common.PTR] * 3


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
    _, grid = common.gather_plan(n, d, c, common.n_sms(device), few_ok=False)
    partial = Xa.new_empty(grid, c, d)
    out = Xa.new_empty(c, d)
    fn = build.entry("lr_hvp", "chef_lr_hvp", _ARGTYPES)
    common.launch("lr_hvp", fn, device, w.data_ptr(), v.data_ptr(), Xa.data_ptr(),
                  weights.data_ptr(), n, d, c, grid, float(l2), partial.data_ptr(),
                  out.data_ptr())
    return out
