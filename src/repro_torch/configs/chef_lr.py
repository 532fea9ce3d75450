"""The port's own copy of `repro.configs.chef_lr` (the port imports nothing
of `repro`). Its backend vocabulary is the port's: `cuda` | `reference`; the
sharded backend's `score_chunk` waits for the port of the `dist` layer.

The paper's own model config: an L2-regularized logistic-regression head on
frozen-backbone features (ResNet50 -> 2048-d for images, BERT -> 768-d for
text), plus the six dataset specs from Table 3 / Table 4 and the CHEF
pipeline hyper-parameters from Section 5.1.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChefConfig:
    """Hyper-parameters of one CHEF run (paper Section 5.1 + Table 4)."""

    n_classes: int = 2
    feature_dim: int = 2048
    # Eq. (1): weight on uncleaned (probabilistic-label) samples
    gamma: float = 0.8
    l2: float = 0.05
    lr: float = 0.05
    batch_size: int = 2000
    n_epochs: int = 50
    momentum: float = 0.0
    # cleaning budget / per-round batch (Section 5.1: B=100, b in {10, 100})
    budget: int = 100
    round_size: int = 10
    # early termination (first-class policy objects in
    # repro.cleaning.scheduler; all default-disabled):
    #   target_f1        — stop when validation F1 >= target (0 disables)
    #   patience         — stop after `patience` rounds without the best val
    #                      F1 improving by >= patience_delta (0 disables)
    #   min_f1_per_label — stop when the marginal val-F1 gain per cleaned
    #                      label falls below this rate (0 disables)
    target_f1: float = 0.0
    patience: int = 0
    patience_delta: float = 0.0
    min_f1_per_label: float = 0.0
    # annotation-service simulation: seconds of human latency per cleaning
    # round. The labels are deterministic either way; the latency is the
    # window the pipelined scheduler overlaps with compute (0 = instant).
    annotator_latency_s: float = 0.0
    # DeltaGrad-L hyper-parameters (Appendix F.2: j0=10, m0=2, T0=10)
    dg_burn_in: int = 10
    dg_period: int = 10
    dg_history: int = 2
    # conjugate-gradient solve of H^{-1} g
    cg_iters: int = 64
    cg_tol: float = 1e-6
    # power-method iterations for per-sample Hessian norms (Appendix D)
    power_iters: int = 12
    # annotators (Section 5.1: 3 simulated annotators, 5% flip rate)
    n_annotators: int = 3
    annotator_error: float = 0.05
    # label strategy: "one" (humans only), "two" (INFL labels only),
    # "three" (INFL + humans, majority vote)
    strategy: str = "three"
    # hot-loop backend: "cuda" (the hand-written kernels; their plain
    # versions on CPU tensors) | "reference" (plain PyTorch on any device)
    backend: str = "cuda"
    seed: int = 0


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_train: int
    n_val: int
    n_test: int
    feature_dim: int
    n_classes: int
    lr: float
    l2: float
    n_epochs: int


def paper_dataset_specs() -> dict[str, DatasetSpec]:
    """Table 3 sizes + Table 4 hyper-parameters (features: ResNet50=2048,
    BERT=768). Synthetic stand-ins reproduce these shapes."""
    return {
        "mimic": DatasetSpec("mimic", 78_487, 579, 1_628, 2048, 2, 0.0005, 0.05, 150),
        "retina": DatasetSpec("retina", 31_615, 3_512, 53_576, 2048, 2, 0.05, 0.05, 200),
        "chexpert": DatasetSpec("chexpert", 37_882, 234, 234, 2048, 2, 0.005, 0.05, 200),
        "fashion": DatasetSpec("fashion", 29_031, 146, 146, 2048, 2, 0.01, 0.001, 200),
        "fact": DatasetSpec("fact", 38_176, 255, 259, 768, 2, 0.001, 0.01, 150),
        "twitter": DatasetSpec("twitter", 11_606, 37, 37, 768, 2, 0.02, 0.01, 400),
    }
