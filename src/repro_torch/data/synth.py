"""Synthetic weak-supervision datasets with the statistical shape of the
paper's six benchmarks (Table 3): frozen-backbone features + probabilistic
labels from simulated labeling functions + noisy human annotators.

The generation model is the JAX package's (`repro/data/synth.py`); the draws
come from the port's own `torch.Generator`, so the two packages make
different datasets from the same seed. Parity tests build a dataset with the
JAX package and carry it across with `repro_torch.convert`.

1. Ground truth: C class prototypes in R^d; sample i draws its feature from
   a Gaussian around its class prototype.
2. Labeling functions (Snorkel-style weak supervision [32]): each LF is a
   noisy-prototype voter with an accuracy knob and a coverage (it abstains
   below a margin quantile). An accuracy-weighted vote combines the votes
   into probabilistic labels.
3. Human annotators: flip ground truth with probability `annotator_error`
   (Section 5.1: 5%).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, fields, replace
from typing import Optional

import torch

from repro_torch.core.annotation import simulate_annotators
from repro_torch.device import resolve_device


@dataclass
class ChefDataset:
    name: str
    X: torch.Tensor  # [N, d] frozen-backbone features
    y_prob: torch.Tensor  # [N, C] current (probabilistic or cleaned) labels
    y_weight: torch.Tensor  # [N] gamma for uncleaned, 1 for cleaned
    cleaned: torch.Tensor  # [N] bool
    y_true: torch.Tensor  # [N] int64 — hidden ground truth (simulation only)
    human_labels: torch.Tensor  # [N, A] int64 simulated annotator labels
    X_val: torch.Tensor
    y_val: torch.Tensor  # [Nv, C] one-hot
    X_test: torch.Tensor
    y_test: torch.Tensor  # [Nt] int64
    n_classes: int

    @property
    def n(self) -> int:
        """Number of training samples."""
        return self.X.shape[0]

    def to(self, device) -> "ChefDataset":
        """The dataset with every tensor on `device`."""
        return replace(self, **{f.name: getattr(self, f.name).to(device) for f in fields(self)
                                if isinstance(getattr(self, f.name), torch.Tensor)})

    def clean(self, idx: torch.Tensor, labels: torch.Tensor) -> "ChefDataset":
        """Apply cleaned (deterministic) labels at `idx` (a new dataset; this
        one is left as it was)."""
        onehot = torch.nn.functional.one_hot(labels, self.n_classes).to(self.y_prob.dtype)
        y_prob, y_weight, cleaned = self.y_prob.clone(), self.y_weight.clone(), self.cleaned.clone()
        y_prob[idx] = onehot
        y_weight[idx] = 1.0
        cleaned[idx] = True
        return replace(self, y_prob=y_prob, y_weight=y_weight, cleaned=cleaned)


def _labeling_functions(gen, X, protos, n_lfs, acc_range, cov_range):
    """Simulated LF votes [N, L] in {-1 (abstain), 0..C-1}.

    Each LF is a noisy-prototype voter: it classifies by nearest perturbed
    prototype and abstains when its margin is small, so its errors are
    systematic (clustered in feature regions the LF is blind to), like real
    Snorkel heuristics."""
    d = X.shape[1]
    dev = X.device
    proto_scale = torch.sqrt(torch.mean(protos**2) + 1e-9)
    votes = []
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((), generator=gen, device=dev)

    for _ in range(n_lfs):
        acc = uniform(*acc_range)
        # the (d/48)^(1/4) factor keeps the perturbation's component along the
        # true class direction dimension-independent
        err_scale = 6.0 * (1.0 - acc) * (d / 48.0) ** 0.25
        protos_l = protos + err_scale * proto_scale * torch.randn(
            protos.shape, generator=gen, device=dev)
        scores = X @ protos_l.T - 0.5 * torch.sum(protos_l**2, dim=-1)  # linear discriminant
        vote = torch.argmax(scores, dim=-1)
        top2 = torch.topk(scores, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        cov = uniform(*cov_range)
        thresh = torch.quantile(margin, 1.0 - cov)
        votes.append(torch.where(margin >= thresh, vote, torch.full_like(vote, -1)))
    return torch.stack(votes, dim=1)


def _label_model(votes: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Accuracy-weighted vote -> probabilistic labels [N, C]. LF accuracies
    are estimated from agreement with the majority (no ground-truth peeking):
    the one-parameter-per-LF generative label model under class balance."""
    onehot = torch.nn.functional.one_hot(votes.clamp_min(0), n_classes).to(torch.float32)
    onehot = onehot * (votes >= 0)[..., None]  # [N, L, C]
    mv = torch.argmax(onehot.sum(dim=1) + 1e-6, dim=-1)  # majority vote
    agree = torch.where(votes >= 0, (votes == mv[:, None]).to(torch.float32),
                        torch.full_like(onehot[..., 0], float("nan")))
    acc_hat = torch.clamp(torch.nanmean(agree, dim=0), 0.55, 0.95)  # [L]
    logit_w = torch.log(acc_hat / (1 - acc_hat)) / max(n_classes - 1, 1)
    return torch.softmax(torch.einsum("nlc,l->nc", onehot, logit_w), dim=-1)


def make_dataset(generator: Optional[torch.Generator] = None, *, name: str = "synth",
                 n_train: int = 4000, n_val: int = 200, n_test: int = 400,
                 feature_dim: int = 128, n_classes: int = 2, class_sep: float = 1.0,
                 noise: float = 1.0, n_lfs: int = 4, lf_acc: tuple = (0.5, 0.68),
                 lf_cov: tuple = (0.3, 0.8), gamma: float = 0.8, n_annotators: int = 3,
                 annotator_error: float = 0.05, device=None) -> ChefDataset:
    """A synthetic dataset on `device` (the card unless `device="cpu"`).
    Draws come from `generator`, on its own device (a generator seeded 0 on
    `device` when none is given)."""
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device).manual_seed(0)
    gdev = gen.device
    # class_sep is defined at the d=48 reference scale; normalizing by
    # sqrt(d/48) keeps the inter-prototype distance dimension-independent
    protos = torch.randn(n_classes, feature_dim, generator=gen, device=gdev) * class_sep * (
        48.0 / feature_dim) ** 0.5
    n_all = n_train + n_val + n_test
    y_all = torch.randint(0, n_classes, (n_all,), generator=gen, device=gdev)
    X_all = protos[y_all] + torch.randn(n_all, feature_dim, generator=gen, device=gdev) * noise
    X, X_val, X_test = torch.split(X_all, [n_train, n_val, n_test])
    y_tr, y_v, y_te = torch.split(y_all, [n_train, n_val, n_test])

    votes = _labeling_functions(gen, X, protos, n_lfs, lf_acc, lf_cov)
    y_prob = _label_model(votes, n_classes)
    human = simulate_annotators(gen, y_tr, n_classes, n_annotators, annotator_error)
    ds = ChefDataset(
        name=name,
        X=X.contiguous(),
        y_prob=y_prob,
        y_weight=torch.full((n_train,), gamma, device=gdev),
        cleaned=torch.zeros(n_train, dtype=torch.bool, device=gdev),
        y_true=y_tr.contiguous(),
        human_labels=human,
        X_val=X_val.contiguous(),
        y_val=torch.nn.functional.one_hot(y_v, n_classes).to(torch.float32),
        X_test=X_test.contiguous(),
        y_test=y_te.contiguous(),
        n_classes=n_classes,
    )
    return ds.to(device)


def make_paper_dataset(name: str, generator: Optional[torch.Generator] = None,
                       scale: float = 1.0, device=None) -> ChefDataset:
    """Synthetic stand-in with the size and shape of one of the paper's six
    datasets (Table 3). `scale` < 1 shrinks N for quick runs. Without a
    generator, draws come from one on `device` seeded from the name."""
    from repro_torch.configs.chef_lr import paper_dataset_specs

    spec = paper_dataset_specs()[name]
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(zlib.crc32(name.encode()) % (2**31))
    return make_dataset(
        generator,
        name=name,
        n_train=max(512, int(spec.n_train * scale)),
        n_val=max(64, int(spec.n_val * scale)),
        n_test=max(64, int(spec.n_test * scale)),
        feature_dim=spec.feature_dim,
        n_classes=spec.n_classes,
        device=device,
    )
