"""DeltaGrad-L (paper Section 4.2, Algorithm 2): incremental model update
after cleaning a small set of labels, by replaying the cached SGD trajectory.

Label cleaning = delete the b samples with (old probabilistic labels, weight
γ) + add the same samples with (cleaned one-hot labels, weight 1). Per
Eq. (4) the updated mini-batch gradient is the cached/approximated old-batch
gradient plus a correction over ONLY the changed samples in the batch —
O(b) work instead of O(|B_t|).

The old-batch gradient at the *new* iterate w^I_t is:
  * computed explicitly in the first j0 iterations and every T0 afterwards
    (these iterations also update the L-BFGS (ΔW, ΔG) history), and
  * approximated elsewhere via Eq. (5):  B_t (w^I_t − w_t) + cached g_t,
    with B_t the compact limited-memory BFGS Hessian estimate
    (Byrd–Nocedal–Schnabel representation; history size m0).

The JAX package scans the replay; here it is a Python loop whose only host
decisions are known before it starts (the explicit-step mask), so nothing
inside it waits for the device: the curvature guard and the pair count stay
on the device, and the small solve is `torch.linalg.solve_ex`, which checks
no error.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.backend import Backend, get_backend
from repro_torch.kernels.common import check_row_ids
from repro_torch.kernels.replay_correction import (
    replay_correction_plain as replay_correction_reference,
)

__all__ = [
    "DGConfig", "lbfgs_Bv", "build_correction_schedule", "replay_correction_reference",
    "deltagrad_replay", "absorb_rows",
]


@dataclass(frozen=True)
class DGConfig:
    burn_in: int = 10  # j0
    period: int = 10  # T0
    history: int = 2  # m0
    lr: float = 0.05
    l2: float = 0.05


# ----------------------------------------------------------------------------
# Compact L-BFGS Hessian product: B v
# ----------------------------------------------------------------------------


def lbfgs_Bv(S, Yh, n_pairs, v) -> torch.Tensor:
    """Compact-form BFGS Hessian estimate applied to v.

    S, Yh: [m0, P] ring buffers of parameter / gradient differences (most
    recent last); n_pairs: how many entries are valid (a 0-d integer tensor,
    read on the device). Falls back to B = I when no pairs exist."""
    m0 = S.shape[0]
    valid = (torch.arange(m0, device=S.device) >= (m0 - n_pairs)).to(torch.float32)
    Sv = S * valid[:, None]
    Yv = Yh * valid[:, None]
    sy_last = torch.sum(S[-1] * Yh[-1])
    ss_last = torch.sum(S[-1] * S[-1])
    sigma = torch.where(ss_last > 1e-30, sy_last / torch.clamp_min(ss_last, 1e-30), 1.0)
    sigma = torch.clamp_min(sigma, 1e-8)

    STS = Sv @ Sv.T  # [m0, m0]
    STY = Sv @ Yv.T
    Ltri = torch.tril(STY, diagonal=-1)
    Dm = torch.diag(torch.diag(STY))
    # M = [[sigma S^T S, L], [L^T, -D]]
    M = torch.cat([torch.cat([sigma * STS, Ltri], dim=1), torch.cat([Ltri.T, -Dm], dim=1)], dim=0)
    # regularize invalid rows/cols to identity so the solve stays well-posed
    mask2 = torch.cat([valid, valid])
    M = M * mask2[:, None] * mask2[None, :] + torch.diag(1.0 - mask2)
    rhs = torch.cat([sigma * (Sv @ v), Yv @ v]) * mask2
    z = torch.linalg.solve_ex(M, rhs).result
    z = z * mask2
    Bv = sigma * v - (sigma * (Sv.T @ z[:m0]) + Yv.T @ z[m0:])
    return torch.where(n_pairs > 0, Bv, v)


# ----------------------------------------------------------------------------
# Correction schedule (host-side, numpy): where do cleaned samples appear?
# ----------------------------------------------------------------------------


def build_correction_schedule(idx_schedule, changed_idx):
    """For each iteration t, the changed-sample slots inside B_t.

    Returns numpy (corr_idx [T, r_max] int32 — global sample ids, padded
    with 0; corr_mask [T, r_max] float32 — 1 for real entries).

    One `np.isin` membership test over the whole [T, bs] schedule plus a
    stable argsort that compacts each row's hits to the front IN BATCH-SLOT
    ORDER: that order is the correction's summation order.
    `_build_correction_schedule_loop` is the oracle it must match exactly."""
    idx_np = np.asarray(idx_schedule)
    changed = np.asarray(changed_idx).reshape(-1)
    hit = np.isin(idx_np, changed)  # [T, bs]
    r_max = max(1, int(hit.sum(axis=1).max(initial=0)))
    order = np.argsort(~hit, axis=1, kind="stable")[:, :r_max]
    sel = np.take_along_axis(hit, order, axis=1)
    ids = np.take_along_axis(idx_np, order, axis=1)
    corr_idx = np.where(sel, ids, 0).astype(np.int32)
    corr_mask = sel.astype(np.float32)
    return corr_idx, corr_mask


def _build_correction_schedule_loop(idx_schedule, changed_idx):
    """Python double loop over T x bs: the oracle `build_correction_schedule`
    must match exactly."""
    idx_np = np.asarray(idx_schedule)
    changed = set(int(c) for c in np.asarray(changed_idx).tolist())
    T = idx_np.shape[0]
    hits = [[int(s) for s in row if int(s) in changed] for row in idx_np]
    r_max = max(1, max((len(h) for h in hits), default=1))
    corr_idx = np.zeros((T, r_max), np.int32)
    corr_mask = np.zeros((T, r_max), np.float32)
    for t, h in enumerate(hits):
        for j, s in enumerate(h):
            corr_idx[t, j] = s
            corr_mask[t, j] = 1.0
    return corr_idx, corr_mask


# ----------------------------------------------------------------------------
# Replay
# ----------------------------------------------------------------------------


def deltagrad_replay(cache_ws, cache_gs, idx_schedule, Xa, Y_old, Y_new, w_old, w_new,
                     corr_idx, corr_mask, cfg: DGConfig, batch_size: int,
                     backend: Optional[Backend] = None):
    """Algorithm 2 adapted for label cleaning (Section 4.2). Returns
    (w^I_T, (ws, gs)): the replayed [T, C, d+1] weights before each step and
    the step's corrected gradients, the cache the next round replays against.

    cache_ws, cache_gs [T, C, d+1]: the cached trajectory; idx_schedule
    [T, bs]; w_old / w_new [N]: the per-sample weights before and after
    cleaning (γ for uncleaned, 1 for cleaned); corr_idx / corr_mask
    [T, r_max] from `build_correction_schedule` (numpy or tensors).

    The explicit-step batch gradients go through `Backend.minibatch_grad`,
    every step's correction through `Backend.replay_correction`."""
    bk = get_backend(backend)
    device = Xa.device
    T, C, D = cache_ws.shape
    m0 = cfg.history
    n = Xa.shape[0]
    idx_schedule = torch.as_tensor(idx_schedule, dtype=torch.int64).to(device)
    ci_all = torch.as_tensor(corr_idx, dtype=torch.int64).to(device)
    cm_all = torch.as_tensor(corr_mask, dtype=torch.float32).to(device)
    check_row_ids(idx_schedule, n, "batch schedule")
    check_row_ids(ci_all, n, "correction schedule")

    t_arr = np.arange(T)
    explicit = (t_arr < cfg.burn_in) | (((t_arr - cfg.burn_in) % cfg.period) == 0)

    ws = torch.empty_like(cache_ws)
    gs = torch.empty_like(cache_gs)
    Sbuf = torch.zeros(m0, C * D, device=device)
    Ybuf = torch.zeros(m0, C * D, device=device)
    n_pairs = torch.zeros((), dtype=torch.int64, device=device)
    wI = cache_ws[0]
    for t in range(T):
        w_t, g_t = cache_ws[t], cache_gs[t]
        if explicit[t]:
            g_old = bk.minibatch_grad(wI, Xa, Y_old, w_old, idx_schedule[t], cfg.l2)
            s = (wI - w_t).reshape(-1)
            y = (g_old - g_t).reshape(-1)
            good = torch.sum(s * y) > 1e-12  # curvature guard
            Sbuf = torch.where(good, torch.cat([Sbuf[1:], s[None]]), Sbuf)
            Ybuf = torch.where(good, torch.cat([Ybuf[1:], y[None]]), Ybuf)
            n_pairs = torch.where(good, torch.clamp_max(n_pairs + 1, m0), n_pairs)
        else:
            Bv = lbfgs_Bv(Sbuf, Ybuf, n_pairs, (wI - w_t).reshape(-1))
            g_old = Bv.reshape(C, D) + g_t
        g = g_old + bk.replay_correction(wI, Xa, Y_old, Y_new, w_old, w_new, ci_all[t],
                                         cm_all[t], batch_size)
        # the replayed trajectory and its corrected gradients become the
        # cache the NEXT cleaning round replays against (Section 4.2 (2))
        ws[t] = wI
        gs[t] = g
        wI = wI - cfg.lr * g
    return wI, (ws, gs)


def absorb_rows(traj, sched, Xa, Y_old, Y_new, w_old, w_new, changed_idx, cfg: DGConfig,
                backend: Optional[Backend] = None):
    """Warm-start on newly-arrived rows (`changed_idx`, a tensor of row ids)
    by trajectory replay over the schedule `sched` [T, bs]: an append is,
    to the replay, a label change of the arriving rows from (padding label,
    weight 0) to (weak label, weight γ). Needs a schedule drawn over the
    fixed capacity, so the arriving rows already hold batch slots. Returns
    (w, new_traj) like `deltagrad_replay`."""
    ci, cm = build_correction_schedule(sched.cpu().numpy(), changed_idx.cpu().numpy())
    return deltagrad_replay(traj[0], traj[1], sched, Xa, Y_old, Y_new, w_old, w_new, ci, cm,
                            cfg, int(sched.shape[1]), backend=backend)
