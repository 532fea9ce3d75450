"""Sample-selector baselines from the paper's Exp1 (Section 5.1).

Every selector returns a `priority` tensor — ASCENDING order = clean first —
plus optional suggested labels (None when the method cannot suggest any, in
which case only human annotators clean).

  INFL-D       Eq. (2), Koh & Liang [20]
  INFL-Y       Eq. (7), Zhang et al. [41]'s label-perturbation influence
  Active (one) least-confidence sampling [34]
  Active (two) entropy sampling [34]
  O2U-lite     cyclic-LR loss ranking (O2U-Net [16]'s core signal: noisy
               samples keep high loss through an over/underfit LR cycle)
  TARS-lite    annotator-disagreement x loss (TARS [9]'s flip-probability-
               times-impact structure)
  DUTI-lite    truncated bi-level debugging [41]: a few unrolled inner SGD
               steps on relaxed labels, outer gradient on validation loss
  loss / random

All are plain PyTorch, as the JAX package computes them in plain ops too; no
kernel is involved. The random baseline's draw goes through the module-level
`random_priority`, so that a test can hand the port the JAX package's draw.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import lr_head
from repro_torch.core.influence import infl_d, infl_y

__all__ = [
    "Selection", "select_infl_d", "select_infl_y", "select_active_one", "select_active_two",
    "select_loss", "random_priority", "select_random", "select_o2u", "select_tars_lite",
    "select_duti_lite",
]


class Selection(NamedTuple):
    priority: torch.Tensor  # [N] ascending = clean first
    suggested: Optional[torch.Tensor]  # [N] int labels or None


def select_infl_d(w, v, Xa, Y) -> Selection:
    """INFL-D priorities (Eq. 2); no suggested labels."""
    return Selection(infl_d(w, v, Xa, Y), None)


def select_infl_y(w, v, Xa, Y) -> Selection:
    """INFL-Y priorities and suggested labels (Eq. 7)."""
    r = infl_y(w, v, Xa, Y)
    return Selection(r.priority, r.suggested)


def select_active_one(w, Xa) -> Selection:
    """Least confidence first."""
    P = lr_head.probs(w, Xa)
    return Selection(torch.amax(P, dim=-1), None)


def select_active_two(w, Xa) -> Selection:
    """Highest entropy first."""
    P = lr_head.probs(w, Xa)
    ent = -torch.sum(P * torch.log(torch.clamp_min(P, 1e-12)), dim=-1)
    return Selection(-ent, None)


def select_loss(w, Xa, Y) -> Selection:
    """Highest loss first."""
    return Selection(-lr_head.per_sample_loss(w, Xa, Y), None)


def random_priority(n: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) priorities [n], drawn on the CPU from `generator` so that every
    device gets the same draw."""
    return torch.rand(n, generator=generator).to(device)


def select_random(generator: Optional[torch.Generator], n: int, device="cpu") -> Selection:
    """Uniformly random order."""
    return Selection(random_priority(n, generator, device), None)


def select_o2u(w0, Xa, Y, weights, idx_schedule, *, l2: float, lr_max: float,
               cycle_len: int = 50, n_cycles: int = 2) -> Selection:
    """O2U-lite: train with a cyclical LR and rank by the per-sample loss
    averaged over the cycle (noisily-labeled samples are re-forgotten when
    the LR swings the model back toward underfitting)."""
    steps = min(idx_schedule.shape[0], cycle_len * n_cycles)
    w = w0
    loss_sum = torch.zeros(Xa.shape[0], device=Xa.device)
    for t in range(steps):
        lr_t = lr_max * (1.0 + math.cos(2 * math.pi * (t % cycle_len) / cycle_len)) / 2
        idx = idx_schedule[t]
        xb, yb, wb = Xa[idx], Y[idx], weights[idx]
        P = lr_head.probs(w, xb)
        g = ((P - yb) * wb[:, None]).T @ xb / idx.shape[0] + l2 * w
        w = w - lr_t * g
        loss_sum = loss_sum + lr_head.per_sample_loss(w, Xa, Y)
    return Selection(-loss_sum / steps, None)


def select_tars_lite(w, Xa, Y, human_labels, n_classes: int) -> Selection:
    """Flip probability (annotator disagreement with the current label) times
    loss impact."""
    onehot = torch.nn.functional.one_hot(human_labels, n_classes).to(torch.float32)  # [N, A, C]
    agree = torch.einsum("nac,nc->na", onehot, Y.to(torch.float32))
    p_flip = 1.0 - torch.mean(agree, dim=-1)  # [N]
    impact = lr_head.per_sample_loss(w, Xa, Y)
    return Selection(-(p_flip * impact), None)


def select_duti_lite(w, Xa, Y, weights, Xa_val, Y_val, *, l2: float, lr: float,
                     inner_steps: int = 8, outer_steps: int = 20,
                     outer_lr: float = 1.0) -> Selection:
    """Truncated bi-level debugging (DUTI [41], probabilistic-label variant of
    Appendix F.3): optimize relaxed labels Y' to minimize validation loss of
    the inner-trained model; rank by how far Y' moved, suggest argmax Y'.
    The outer gradient is `torch.autograd.grad` through the unrolled inner
    loop."""
    ones_val = torch.ones(Xa_val.shape[0], device=Xa_val.device)

    def inner(Yp):
        wi = w
        for _ in range(inner_steps):
            P = lr_head.probs(wi, Xa)
            g = ((P - Yp) * weights[:, None]).T @ Xa / Xa.shape[0] + l2 * wi
            wi = wi - lr * g
        return lr_head.loss(wi, Xa_val, Y_val, ones_val, 0.0)

    logits = torch.log(torch.clamp_min(Y, 1e-6))
    for _ in range(outer_steps):
        Yp = torch.softmax(logits, dim=-1).requires_grad_(True)
        (g,) = torch.autograd.grad(inner(Yp), Yp)
        logits = logits - outer_lr * g
    Yp = torch.softmax(logits, dim=-1)
    moved = torch.sum(torch.abs(Yp - Y), dim=-1)
    return Selection(-moved, torch.argmax(Yp, dim=-1))
