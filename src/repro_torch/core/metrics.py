"""Evaluation metrics (the paper reports F1)."""
from __future__ import annotations

import torch


def f1_binary(pred: torch.Tensor, true: torch.Tensor, positive: int = 1) -> torch.Tensor:
    """F1 of class `positive` against the rest."""
    p = pred == positive
    t = true == positive
    tp = torch.sum(p & t).to(torch.float32)
    fp = torch.sum(p & ~t).to(torch.float32)
    fn = torch.sum(~p & t).to(torch.float32)
    return 2 * tp / torch.clamp_min(2 * tp + fp + fn, 1e-9)


def f1_macro(pred: torch.Tensor, true: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Mean of the per-class F1."""
    return torch.mean(torch.stack([f1_binary(pred, true, c) for c in range(n_classes)]))


def f1(pred, true, n_classes: int) -> torch.Tensor:
    """Binary F1 for two classes, macro F1 otherwise."""
    if n_classes == 2:
        return f1_binary(pred, true)
    return f1_macro(pred, true, n_classes)


def accuracy(pred, true) -> torch.Tensor:
    """Share of predictions equal to the truth."""
    return torch.mean((pred == true).to(torch.float32))
