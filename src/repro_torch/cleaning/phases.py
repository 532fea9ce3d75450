"""The three CHEF phases as pluggable protocol classes.

  Selector    — sample selection: INFL, optionally pruned by Increm-INFL.
                Everything score-shaped dispatches through the session's
                `Backend` (reference | cuda).
  Annotator   — the annotation phase. `SimulatedAnnotator` computes the voted
                labels deterministically and hands back an `AnnotationTask`
                whose result becomes available after the configured human
                latency.
  Constructor — the model-constructor phase: full retrain. Constructors are
                pure with respect to the session (they return a
                `ConstructorResult`; only `session.apply_round` commits).

The baselines' selector and the DeltaGrad-L constructor are not ported
yet (ROADMAP.md); the factories raise on their names.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import annotation, increm
from repro_torch.core.influence import infl, influence_vector, top_b
from repro_torch.core.pipeline import train_head


class RoundSelection(NamedTuple):
    idx: torch.Tensor  # [b] selected sample indices
    priority: torch.Tensor  # [N]
    suggested: torch.Tensor  # [N] INFL's proposed labels
    n_candidates: int  # Increm-INFL survivors (N when Full)


class ConstructorResult(NamedTuple):
    ds: "object"  # dataset with this round's labels applied
    w: torch.Tensor
    traj: Optional[tuple]
    sched: torch.Tensor


@runtime_checkable
class Selector(Protocol):
    def select(self, session, eligible, generator) -> RoundSelection: ...


@dataclass(frozen=True)
class InflSelector:
    """INFL (Eq. 6), optionally pruned by Increm-INFL (Theorem 1 +
    Algorithm 1). `mode`: full | increm | increm_tight."""

    mode: str = "full"

    def select(self, session, eligible, generator) -> RoundSelection:
        """This round's top-b INFL selection among the eligible rows."""
        cfg, ds, bk = session.cfg, session.ds, session.backend
        v, _ = influence_vector(session.w, session.Xa_val, ds.y_val, session.Xa, ds.y_weight,
                                cfg.l2, cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, backend=bk)
        if self.mode.startswith("increm"):
            priority, suggested, pruned = increm.increm_infl(
                session.prov, session.w, v, session.Xa, ds.y_prob, cfg.gamma, eligible,
                cfg.round_size, tight=(self.mode == "increm_tight"), backend=bk)
            n_cand = pruned.n_candidates
        else:
            r = infl(session.w, v, session.Xa, ds.y_prob, cfg.gamma, backend=bk)
            priority, suggested, n_cand = r.priority, r.suggested, ds.n
        idx = top_b(priority, eligible, cfg.round_size)
        return RoundSelection(idx, priority, suggested, n_cand)


def make_selector(method: str, selector: str) -> Selector:
    """(method, selector) in `run_chef`'s vocabulary -> a Selector object."""
    if method != "infl":
        raise ValueError(f"selector method {method!r} is not ported yet; the port has 'infl'")
    if selector not in ("full", "increm", "increm_tight"):
        raise ValueError(f"unknown selector {selector!r}")
    return InflSelector(mode=selector)


class AnnotationTask:
    """A deterministic simulated-async annotation: the voted labels are fixed
    at creation, but become available only `latency_s` later."""

    def __init__(self, labels: torch.Tensor, latency_s: float = 0.0):
        self._labels = labels
        self._ready_at = time.monotonic() + max(latency_s, 0.0)

    def ready(self) -> bool:
        """Whether the annotators have answered."""
        return time.monotonic() >= self._ready_at

    def result(self) -> torch.Tensor:
        """Block until the annotators have answered, then return the voted
        labels [b]."""
        dt = self._ready_at - time.monotonic()
        if dt > 0:
            time.sleep(dt)
        return self._labels


@runtime_checkable
class Annotator(Protocol):
    def annotate(self, session, selection: RoundSelection, generator) -> AnnotationTask: ...


@dataclass(frozen=True)
class SimulatedAnnotator:
    """Section 5.1 annotators: majority vote over the dataset's simulated
    human labels, with INFL joining per the strategy (one | two | three)."""

    strategy: str = "three"
    latency_s: float = 0.0

    def annotate(self, session, selection: RoundSelection, generator) -> AnnotationTask:
        """Start the vote on the selected rows."""
        ds = session.ds
        labels = annotation.cleaned_labels(self.strategy, ds.human_labels[selection.idx],
                                           selection.suggested[selection.idx], ds.n_classes,
                                           generator=generator)
        return AnnotationTask(labels, self.latency_s)


@runtime_checkable
class Constructor(Protocol):
    def construct(self, session, idx, labels) -> ConstructorResult: ...


@dataclass(frozen=True)
class RetrainConstructor:
    """Full from-scratch retrain (the paper's Retrain baseline); the SGD loop
    dispatches through the session's `Backend`."""

    def construct(self, session, idx, labels) -> ConstructorResult:
        """Clean `idx` with `labels` and retrain the head from scratch."""
        ds_new = session.ds.clean(idx, labels)
        w, _, sched = train_head(ds_new, session.cfg, cache=False, backend=session.backend,
                                 device=session.Xa.device)
        return ConstructorResult(ds_new, w, None, sched)


def make_constructor(name: str) -> Constructor:
    """Constructor by name: retrain (DeltaGrad-L is not ported yet)."""
    if name == "retrain":
        return RetrainConstructor()
    raise ValueError(f"constructor {name!r} is not ported yet; the port has 'retrain'")
