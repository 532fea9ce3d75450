"""The human-annotation phase (paper Section 4.3): simulated annotators,
majority vote, and INFL-as-an-annotator.

Paper Section 5.1 setup: 3 independent annotators whose labels flip the
ground truth with 5% probability; INFL's suggested labels can (a) replace
annotators entirely — INFL (two) — or (b) join the vote — INFL (three).

The vote's tie-break noise goes through the module-level `tie_noise`, so
that a test can hand the port the JAX package's draws.
"""
from __future__ import annotations

from typing import Optional

import torch


def simulate_annotators(generator: Optional[torch.Generator], y_true: torch.Tensor,
                        n_classes: int, n_annotators: int, error_rate: float) -> torch.Tensor:
    """[N] int ground truth -> [N, A] int64 annotator labels (5%-flip model):
    each label flips with probability `error_rate` to a class drawn uniformly
    from the other C-1. Draws on the generator's device."""
    N = y_true.shape[0]
    dev = generator.device if generator is not None else y_true.device
    flips = torch.rand(N, n_annotators, generator=generator, device=dev) < error_rate
    offs = torch.randint(1, max(n_classes, 2), (N, n_annotators), generator=generator, device=dev)
    y = y_true.to(dev)[:, None]
    return torch.where(flips, (y + offs) % n_classes, y).to(y_true.device)


def tie_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) noise of the given shape, drawn on the CPU from `generator`
    so that every device gets the same draw."""
    return torch.rand(shape, generator=generator).to(device)


def majority_vote(labels: torch.Tensor, n_classes: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[N, A] -> [N]; ties broken by smallest class id (deterministic), or
    randomly when a generator is given."""
    counts = torch.nn.functional.one_hot(labels, n_classes).to(torch.float32).sum(dim=1)
    if generator is not None:
        counts = counts + 1e-3 * tie_noise(counts.shape, generator, counts.device)
    return torch.argmax(counts, dim=-1)


def cleaned_labels(strategy: str, human_labels: torch.Tensor, infl_labels: torch.Tensor,
                   n_classes: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Strategies from Section 5.1:
    'one'   — majority vote of the human annotators only (INFL (one))
    'two'   — INFL's suggested labels alone, no humans   (INFL (two))
    'three' — INFL joins the vote as one more annotator  (INFL (three))
    """
    if strategy == "one":
        return majority_vote(human_labels, n_classes, generator)
    if strategy == "two":
        return infl_labels.to(torch.int64)
    if strategy == "three":
        stacked = torch.cat([human_labels, infl_labels[:, None]], dim=1)
        return majority_vote(stacked, n_classes, generator)
    raise ValueError(strategy)
