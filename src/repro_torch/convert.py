"""Carry state across from the JAX package: numpy arrays in, the port's
objects out, on a given device. Imports nothing of `repro`; the caller
turns the JAX package's arrays into numpy (`np.asarray`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.increm import Provenance
from repro_torch.data.synth import ChefDataset


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int64), device=device)


def head_from_numpy(w, device="cpu") -> torch.Tensor:
    """Head weights [C, d+1] as float32."""
    return _f32(w, device)


def dataset_from_numpy(*, name, X, y_prob, y_weight, cleaned, y_true, human_labels, X_val,
                       y_val, X_test, y_test, n_classes, device="cpu") -> ChefDataset:
    """A `ChefDataset` from every field of the JAX package's dataset."""
    return ChefDataset(
        name=str(name), X=_f32(X, device), y_prob=_f32(y_prob, device),
        y_weight=_f32(y_weight, device),
        cleaned=torch.as_tensor(np.array(cleaned, bool), device=device),
        y_true=_i64(y_true, device), human_labels=_i64(human_labels, device),
        X_val=_f32(X_val, device), y_val=_f32(y_val, device), X_test=_f32(X_test, device),
        y_test=_i64(y_test, device), n_classes=int(n_classes))


def provenance_from_numpy(w0, p0, hnorm, device="cpu") -> Provenance:
    """Increm-INFL provenance (w0 [C, d+1], p0 [N, C], hnorm [N])."""
    return Provenance(_f32(w0, device), _f32(p0, device), _f32(hnorm, device))


def schedule_from_numpy(sched, device="cpu") -> torch.Tensor:
    """A batch schedule [T, bs] as int64 row ids."""
    return _i64(sched, device)
