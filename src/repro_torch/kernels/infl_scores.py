"""Eq. 6 INFL score matrix: U = Xa·vᵀ, S = Σ_c(Y + (1−γ)(P − Y))⊙U − U.

Replaces the TPU kernel `repro/kernels/infl_scores.py::infl_scores_pallas`.
The CUDA kernel (`csrc/infl_scores.cu`) gives each row one warp: one pass,
no reduction across blocks. Bound on the H100: device-memory bytes, one read
of Xa.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 4 + [common.INT] * 3 + [common.FLOAT] + [common.PTR] * 2


def infl_scores_plain(v, Xa, P, Y, gamma: float) -> torch.Tensor:
    """Plain PyTorch version: the reference form of the score matrix."""
    U = Xa @ v.T
    base = torch.sum((Y + (1.0 - gamma) * (P - Y)) * U, dim=-1)
    return base[:, None] - U


def infl_scores(v, Xa, P, Y, gamma: float) -> torch.Tensor:
    """Score matrix [N, C]: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if Xa.device.type == "cpu":
        return infl_scores_plain(v, Xa, P, Y, gamma)
    (n, d), c = Xa.shape, v.shape[0]
    device = common.check("infl_scores", c, v=(v, (c, d)), Xa=(Xa, (n, d)), P=(P, (n, c)),
                          Y=(Y, (n, c)))
    S = Xa.new_empty(n, c)
    fn = build.entry("infl_scores", "chef_infl_scores", _ARGTYPES)
    common.launch("infl_scores", fn, device, v.data_ptr(), Xa.data_ptr(), P.data_ptr(),
                  Y.data_ptr(), n, d, c, float(1.0 - gamma), S.data_ptr())
    return S
