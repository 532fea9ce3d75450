"""The CHEF head: L2-regularized multinomial logistic regression on frozen
backbone features — the paper's strongly-convex model (Section 3.2).

Everything is closed-form (no autodiff), which is what the kernels rest on:

  z_i = W x̃_i                     x̃ = [x, 1] (bias absorbed), W [C, d+1]
  p_i = softmax(z_i)
  F(w, z_i)        = -sum_c y_ic log p_ic
  grad_W F(w,z_i)  = (p_i - y_i) x̃_iᵀ
  H(w,z_i) v      -> u_i = V x̃_i ; s_i = p_i*u_i - p_i (p_i·u_i) ; (s_i x̃_iᵀ)

The batch objective follows paper Eq. (1): (1/N) Σ γ_z F(w,z) + (λ/2)||W||².
The hot functions (`grad`, `hvp`, the `sgd_train` step) dispatch through a
`Backend`. The reference forms are the kernels' plain versions.

Random draws go through two module-level functions, `batch_schedule` and
`power_init`, so that a test can hand the port the JAX package's draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.backend import Backend, get_backend
from repro_torch.kernels.common import check_row_ids
from repro_torch.kernels.lr_grad import lr_grad_plain as grad_reference
from repro_torch.kernels.lr_hvp import lr_hvp_plain as hvp_reference
from repro_torch.kernels.minibatch_grad import minibatch_grad_plain as minibatch_grad_reference

__all__ = [
    "augment", "init_head", "probs", "loss", "grad_reference", "grad", "hvp_reference", "hvp",
    "power_init", "per_sample_hessian_norm", "minibatch_grad_reference", "per_sample_loss",
    "batch_schedule", "sgd_train",
]


def augment(X: torch.Tensor) -> torch.Tensor:
    """[N, d] -> [N, d+1] with a trailing ones column (absorbed bias)."""
    return torch.cat([X, X.new_ones(*X.shape[:-1], 1)], dim=-1)


def init_head(generator: Optional[torch.Generator], n_classes: int, feat_dim: int,
              scale: float = 0.0, device=None) -> torch.Tensor:
    """Head weights [C, d+1]: zeros, or N(0, scale²) drawn from `generator`."""
    if scale == 0.0:
        return torch.zeros(n_classes, feat_dim + 1, device=device)
    w = torch.randn(n_classes, feat_dim + 1, generator=generator,
                    device=generator.device if generator is not None else "cpu")
    return (w * scale).to(device)


def probs(w, Xa) -> torch.Tensor:
    """softmax(W x̃) for augmented features Xa [N, d+1] -> [N, C]."""
    return torch.softmax(Xa @ w.T, dim=-1)


def loss(w, Xa, Y, weights, l2: float) -> torch.Tensor:
    """Paper Eq. (1): (1/N) Σ γ_z CE(z) + (λ/2)||w||²."""
    ce = -torch.sum(Y * torch.log_softmax(Xa @ w.T, dim=-1), dim=-1)
    return torch.sum(weights * ce) / Xa.shape[0] + 0.5 * l2 * torch.sum(w * w)


def grad(w, Xa, Y, weights, l2: float, backend: Optional[Backend] = None) -> torch.Tensor:
    """(1/N) Σ γ_i (p_i - y_i) x̃_iᵀ + λ w through the backend."""
    return get_backend(backend).lr_grad(w, Xa, Y, weights, l2)


def hvp(w, v, Xa, weights, l2: float, P: Optional[torch.Tensor] = None,
        backend: Optional[Backend] = None) -> torch.Tensor:
    """H(w) v for the batch objective. P may be precomputed probs."""
    return get_backend(backend).lr_hvp(w, v, Xa, weights, l2, P=P)


def power_init(n: int, c: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The power method's start vectors [n, c] ~ N(0, 1), drawn on the CPU
    (from a generator seeded 0 when none is given) so that every device gets
    the same draw."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randn(n, c, generator=generator).to(device)


def per_sample_hessian_norm(w, Xa, P: Optional[torch.Tensor] = None, iters: int = 12,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """||H(w, z_i)|| for every sample (Theorem 1 provenance).

    The per-sample CE Hessian is the Kronecker product A_p ⊗ x̃x̃ᵀ with
    A_p = diag(p) − ppᵀ, so ||H_z|| = ||A_p|| · ||x̃||², with ||A_p|| from the
    power method (Appendix D) batched over samples on the C x C factor.
    """
    if P is None:
        P = probs(w, Xa)
    N, C = P.shape
    g = power_init(N, C, generator, P.device)
    for _ in range(iters):
        Ag = P * g - P * torch.sum(P * g, dim=-1, keepdim=True)
        g = Ag / torch.clamp_min(torch.linalg.norm(Ag, dim=-1, keepdim=True), 1e-30)
    Ag = P * g - P * torch.sum(P * g, dim=-1, keepdim=True)
    a_norm = torch.sum(g * Ag, dim=-1) / torch.clamp_min(torch.sum(g * g, dim=-1), 1e-30)
    xsq = torch.sum(Xa * Xa, dim=-1)
    return torch.clamp_min(a_norm, 0.0) * xsq


def per_sample_loss(w, Xa, Y) -> torch.Tensor:
    """Cross entropy of every sample [N]."""
    return -torch.sum(Y * torch.log_softmax(Xa @ w.T, dim=-1), dim=-1)


# ----------------------------------------------------------------------------
# SGD training with trajectory caching (the substrate DeltaGrad-L replays)
# ----------------------------------------------------------------------------


def batch_schedule(seed: int, n: int, batch_size: int, n_epochs: int) -> torch.Tensor:
    """Deterministic mini-batch index schedule [T, batch_size] (int64, on the
    CPU): one permutation of the n rows per epoch, cut into
    max(n // batch_size, 1) batches."""
    steps = max(n // batch_size, 1)
    gen = torch.Generator().manual_seed(seed)
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(n_epochs)])
    return perms[:, : steps * batch_size].reshape(n_epochs * steps, batch_size)


def sgd_train(w0, Xa, Y, weights, idx_schedule, *, l2: float, lr: float,
              momentum: float = 0.0, cache_trajectory: bool = True,
              backend: Optional[Backend] = None):
    """Plain SGD (paper Section 5.1) over a precomputed batch schedule
    [T, bs] that lies on Xa's device. Returns (w_final, traj) with
    traj = (ws, gs), the [T, C, d+1] weights before each step and the step's
    gradients, kept for DeltaGrad-L when `cache_trajectory`, else None.

    Every step's gathered mini-batch gradient dispatches through the
    backend; the kernel sums in a fixed order, so a run repeats bit for bit."""
    bk = get_backend(backend)
    check_row_ids(idx_schedule, Xa.shape[0], "batch schedule")
    T = idx_schedule.shape[0]
    ws = gs = None
    if cache_trajectory:
        ws = w0.new_empty(T, *w0.shape)
        gs = w0.new_empty(T, *w0.shape)
    w, mom = w0, torch.zeros_like(w0)
    for t in range(T):
        g = bk.minibatch_grad(w, Xa, Y, weights, idx_schedule[t], l2)
        if cache_trajectory:
            ws[t] = w
            gs[t] = g
        if momentum:
            mom = momentum * mom + g
            w = w - lr * mom
        else:
            w = w - lr * g
    return w, ((ws, gs) if cache_trajectory else None)
