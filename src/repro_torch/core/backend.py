"""Backend dispatch for the CHEF hot loops.

One frozen `Backend`, chosen once per run (`ChefConfig.backend` or an
explicit override) and passed down, carries the loop's ops:

  lr_grad(w, Xa, Y, weights, l2)         -> [C, d+1]  Eq. 1 batch gradient
  lr_hvp(w, v, Xa, weights, l2, P=None)  -> [C, d+1]  H(w)v (CG inner loop)
  infl_scores(v, Xa, P, Y, gamma)        -> [N, C]    Eq. 6 score matrix
  probs_scores(w, v, Xa, Y, gamma)       -> [N, C]    probs, then Eq. 6
  minibatch_grad(w, Xa, Y, weights, idx, l2) -> [C, d+1]  the sgd_train step
  probs(w, Xa)                           -> [N, C]    softmax(Xa wᵀ)

  reference  plain PyTorch on any device: the semantic oracle.
  cuda       the hand-written kernels of `repro_torch.kernels`. Each wrapper
             computes its kernel's plain version for CPU tensors only; for
             CUDA tensors it launches the kernel or raises.

The two agree to float32 rounding; choosing one is a question of speed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

BACKENDS = ("reference", "cuda")


@dataclass(frozen=True)
class Backend:
    """Dispatch object for the loop's ops (frozen and hashable)."""

    name: str = "reference"

    def __post_init__(self):
        if self.name not in BACKENDS:
            raise ValueError(f"unknown backend {self.name!r}; expected one of {BACKENDS}")

    def lr_grad(self, w, Xa, Y, weights, l2: float) -> torch.Tensor:
        """Eq. 1 batch gradient of the weighted LR objective -> [C, d+1]."""
        if self.name == "reference":
            from repro_torch.core import lr_head

            return lr_head.grad_reference(w, Xa, Y, weights, l2)
        from repro_torch.kernels.lr_grad import lr_grad

        return lr_grad(w, Xa, Y, weights, l2)

    def lr_hvp(self, w, v, Xa, weights, l2: float, P=None) -> torch.Tensor:
        """H(w)v -> [C, d+1]. P optionally carries precomputed probs; the
        kernel recomputes them in its row pass and ignores P."""
        if self.name == "reference":
            from repro_torch.core import lr_head

            return lr_head.hvp_reference(w, v, Xa, weights, l2, P=P)
        from repro_torch.kernels.lr_hvp import lr_hvp

        return lr_hvp(w, v, Xa, weights, l2)

    def infl_scores(self, v, Xa, P, Y, gamma: float) -> torch.Tensor:
        """Eq. 6 INFL score matrix [N, C]."""
        if self.name == "reference":
            from repro_torch.core.influence import infl_scores_reference

            return infl_scores_reference(v, Xa, P, Y, gamma)
        from repro_torch.kernels.infl_scores import infl_scores

        return infl_scores(v, Xa, P, Y, gamma)

    def probs_scores(self, w, v, Xa, Y, gamma: float) -> torch.Tensor:
        """P = softmax(Xa wᵀ), then the Eq. 6 scores [N, C]."""
        return self.infl_scores(v, Xa, self.probs(w, Xa), Y, gamma)

    def minibatch_grad(self, w, Xa, Y, weights, idx, l2: float) -> torch.Tensor:
        """Gathered mini-batch gradient over B_t = Xa[idx] (Eq. 4 left term)."""
        if self.name == "reference":
            from repro_torch.core import lr_head

            return lr_head.minibatch_grad_reference(w, Xa, Y, weights, idx, l2)
        from repro_torch.kernels.minibatch_grad import minibatch_grad

        return minibatch_grad(w, Xa, Y, weights, idx, l2)

    def unsharded(self) -> "Backend":
        """The backend for small side computations (the validation gradient).
        The port has no sharded backend yet, so this is `self`."""
        return self

    def probs(self, w, Xa) -> torch.Tensor:
        """softmax(Xa wᵀ) -> [N, C]."""
        from repro_torch.core import lr_head

        return lr_head.probs(w, Xa)


def get_backend(spec: Union[Backend, str, None] = None) -> Backend:
    """Resolve a spec (Backend | name | None) to a Backend; None -> reference,
    as in the JAX package."""
    if isinstance(spec, Backend):
        return spec
    return Backend(spec or "reference")
