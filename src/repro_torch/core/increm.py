"""Increm-INFL: Theorem 1 bounds + Algorithm 1 candidate pruning.

Provenance (computed once in the Initialization step, paper Section 4.1.2):
  * w⁰ — the round-0 model
  * p⁰_i = softmax(w⁰ x̃_i) — round-0 probabilities
  * hnorm_i = ||H(w⁰, z̃_i)|| = ||diag(p⁰)−p⁰p⁰ᵀ|| · ||x̃_i||² — per-sample
    Hessian norm via the power method on the CxC Kronecker factor.

At round k (Theorem 1, with e1 = vᵀ(w^k−w⁰), e2 = ||v||·||w^k−w⁰||):

  I_0(i,c)   = (ỹ_i − e_c + (1−γ)(p⁰_i − ỹ_i)) · u_i,   u_i = v x̃_i
  lower(i,c) = I_0 − hnorm·e2·(1−ỹ_c) + (1−γ)/2·(e1−e2)·hnorm
  upper(i,c) = I_0 + hnorm·e2·(1−ỹ_c) + (1−γ)/2·(e1+e2)·hnorm

Algorithm 1: keep the top-b smallest I_0 (their largest upper bound = L) plus
every sample whose lower bound < L for some class. Exact Eq. 6 evaluation then
runs only on the survivors — and provably returns the same top-b as Full.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import lr_head
from repro_torch.core.backend import Backend, get_backend
from repro_torch.core.influence import infl_scores


@dataclass
class Provenance:
    w0: torch.Tensor  # [C, d+1]
    p0: torch.Tensor  # [N, C]
    hnorm: torch.Tensor  # [N]


def build_provenance(w0, Xa, power_iters: int = 12,
                     generator: Optional[torch.Generator] = None,
                     backend: Optional[Backend] = None) -> Provenance:
    """Initialization-step provenance (w0, p0, hnorm) over the full Xa."""
    p0 = get_backend(backend).probs(w0, Xa)
    hnorm = lr_head.per_sample_hessian_norm(w0, Xa, P=p0, iters=power_iters,
                                            generator=generator)
    return Provenance(w0, p0, hnorm)


def extend_provenance(prov: Provenance, Xa_new, *, power_iters: int = 12,
                      generator: Optional[torch.Generator] = None, at=None,
                      backend: Optional[Backend] = None) -> Provenance:
    """Grow Theorem-1 provenance to newly-arrived rows without re-anchoring:
    p0 and hnorm of the new rows at the SAME w0, the existing rows untouched
    (the bounds are per-sample and anchored at w0, so every bound that held
    before still holds). O(m) work for m new rows.

    `at=None` concatenates the new rows onto p0 / hnorm; `at` ([m] row ids)
    writes them into new tensors at those rows of capacity-shaped caches
    (the stream's window store, whose padding rows the eligibility mask
    keeps out of Algorithm 1). The power method's start vectors come from
    `generator`, so an extended hnorm is deterministic given (w0, Xa_new,
    generator) but not bit for bit a full rebuild; Algorithm 1's top-b
    guarantee holds for any valid hnorm."""
    p_new = get_backend(backend).probs(prov.w0, Xa_new)
    h_new = lr_head.per_sample_hessian_norm(prov.w0, Xa_new, P=p_new, iters=power_iters,
                                            generator=generator)
    if at is None:
        return Provenance(prov.w0, torch.cat([prov.p0, p_new]), torch.cat([prov.hnorm, h_new]))
    at = torch.as_tensor(at, dtype=torch.int64, device=prov.p0.device)
    return Provenance(prov.w0, prov.p0.index_copy(0, at, p_new),
                      prov.hnorm.index_copy(0, at, h_new))


@dataclass
class Bounds:
    center: torch.Tensor  # [N, C] I_0
    lower: torch.Tensor  # [N, C]
    upper: torch.Tensor  # [N, C]


def theorem1_bounds(prov: Provenance, w_k, v, Xa, Y, gamma: float, tight: bool = False,
                    backend: Optional[Backend] = None) -> Bounds:
    """`tight=False` is the paper's Theorem 1 verbatim. `tight=True` drops
    the Diff₁ width, which is exactly 0 for cross entropy (Σ_j δ_j = 0
    cancels the softmax term). The O(NC) centre goes through the backend."""
    dw = w_k - prov.w0
    e1 = torch.sum(v * dw)
    e2 = torch.linalg.norm(v) * torch.linalg.norm(dw)
    I0 = infl_scores(v, Xa, prov.p0, Y, gamma, backend=backend)  # centre at p0
    h = prov.hnorm[:, None]
    width1 = torch.zeros_like(I0) if tight else h * e2 * (1.0 - Y)
    lo2 = 0.5 * (1.0 - gamma) * (e1 - e2) * h
    hi2 = 0.5 * (1.0 - gamma) * (e1 + e2) * h
    return Bounds(I0, I0 - width1 + lo2, I0 + width1 + hi2)


@dataclass
class PruneResult:
    candidates: torch.Tensor  # [N] bool — survivors needing exact evaluation
    n_candidates: int
    L: torch.Tensor  # the top-b upper-bound threshold


def algorithm1(bounds: Bounds, eligible: torch.Tensor, b: int) -> PruneResult:
    """Paper Algorithm 1 over per-sample min-class values. The top b and the
    argmin class take the lowest index first among equal values."""
    inf = torch.full_like(bounds.center[:, 0], float("inf"))
    center_min = torch.where(eligible, torch.amin(bounds.center, dim=-1), inf)
    cmin = torch.argmin(bounds.center, dim=-1)
    upper_at_cmin = torch.gather(bounds.upper, 1, cmin[:, None])[:, 0]
    top_idx = torch.sort(center_min, stable=True).indices[:b]
    in_top = torch.zeros_like(eligible)
    in_top[top_idx] = True
    in_top &= eligible
    L = torch.amax(torch.where(in_top, upper_at_cmin, -inf))
    lower_min = torch.where(eligible, torch.amin(bounds.lower, dim=-1), inf)
    cand = in_top | (eligible & (lower_min < L))
    return PruneResult(cand, int(cand.sum()), L)


def increm_infl(prov: Provenance, w_k, v, Xa, Y, gamma: float, eligible, b: int,
                tight: bool = False, backend: Optional[Backend] = None):
    """Full Increm-INFL round: prune via Theorem 1, then exact Eq. 6 on the
    survivors. Returns (priority [N], suggested [N], prune_info).

    Non-candidates get +inf priority — Algorithm 1 guarantees the true top-b
    are all candidates, so top-b selection matches Full exactly. As in the
    JAX package, the exact pass scores every row and masks."""
    backend = get_backend(backend)
    bounds = theorem1_bounds(prov, w_k, v, Xa, Y, gamma, tight=tight, backend=backend)
    pruned = algorithm1(bounds, eligible, b)
    S = backend.probs_scores(w_k, v, Xa, Y, gamma)
    S = torch.where(pruned.candidates[:, None], S, torch.full_like(S, float("inf")))
    return torch.amin(S, dim=-1), torch.argmin(S, dim=-1), pruned
