"""DeltaGrad-L replay correction over the changed rows of one batch (Eq. 4,
right term, as Section 4.2 adapts it to label cleaning):

    p = softmax(Xa[ci]·wᵀ)
    out = ((p − Y_new[ci])·(γ_new[ci]·cm) − (p − Y_old[ci])·(γ_old[ci]·cm))ᵀ·Xa[ci] / |B|

Replaces the TPU kernel
`repro/kernels/replay_correction.py::replay_correction_pallas`. Bound on the
H100: at the mimic widths a replay step changes 1 to 3 rows (about 25 KB,
0.015 us of bytes), so a call is latency: the launch, then the ids, then the
rows, two dependent loads; with many slots, device-memory bytes. The CUDA
kernel (`csrc/replay_correction.cu`, design in `csrc/lr_gather.cuh`) is the
gathered reduction's correction mode, one launch a call: up to
`common.few_slots` slots, one CTA per block of 256 columns, each computing
every slot's logits with all its threads (every copy issued at once), one
softmax and the two-branch residual, then its columns of residualᵀ·Xa[ci],
with no scratch; with more slots, the many-rows grid `minibatch_grad` runs.
Sums run in an order fixed by the shapes and the SM count, with no atomics,
so a replay repeats bit for bit. A padded slot (cm = 0, ci = 0) adds exactly
zero.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, common

_ARGTYPES = [common.PTR] * 8 + [common.INT] * 5 + [common.FLOAT] + [common.PTR] * 3


def replay_correction_plain(w, Xa, Y_old, Y_new, w_old, w_new, ci, cm,
                            batch_size: int) -> torch.Tensor:
    """Plain PyTorch version, the float program of the JAX package's
    `replay_correction_reference`."""
    xb = Xa[ci]
    P = torch.softmax(xb @ w.T, dim=-1)
    g_new = (P - Y_new[ci]) * (w_new[ci] * cm)[:, None]
    g_old = (P - Y_old[ci]) * (w_old[ci] * cm)[:, None]
    return (g_new - g_old).T @ xb / batch_size


def replay_correction(w, Xa, Y_old, Y_new, w_old, w_new, ci, cm,
                      batch_size: int) -> torch.Tensor:
    """Correction [C, D]: the kernel on a CUDA tensor, the plain version on a
    CPU tensor. `ci` holds int64 row ids in [0, N), `cm` the float32 slot
    mask; callers check the ids' range once for a whole replay
    (`deltagrad.deltagrad_replay`)."""
    if Xa.device.type == "cpu":
        return replay_correction_plain(w, Xa, Y_old, Y_new, w_old, w_new, ci, cm, batch_size)
    (n, d), c, r = Xa.shape, w.shape[0], ci.shape[0]
    device = common.check("replay_correction", c, w=(w, (c, d)), Xa=(Xa, (n, d)),
                          Y_old=(Y_old, (n, c)), Y_new=(Y_new, (n, c)), w_old=(w_old, (n,)),
                          w_new=(w_new, (n,)), ci=(ci, (r,)), cm=(cm, (r,)))
    few, grid = common.gather_plan(r, d, c, common.n_sms(device))
    partial = None if few else Xa.new_empty(grid, c, d)  # kept alive past the launch
    out = Xa.new_empty(c, d)
    fn = build.entry("replay_correction", "chef_replay_correction", _ARGTYPES)
    common.launch("replay_correction", fn, device, w.data_ptr(), Xa.data_ptr(),
                  Y_old.data_ptr(), Y_new.data_ptr(), w_old.data_ptr(), w_new.data_ptr(),
                  ci.data_ptr(), cm.data_ptr(), r, d, c, grid, few, float(batch_size),
                  None if few else partial.data_ptr(), out.data_ptr())
    return out
