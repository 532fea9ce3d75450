"""The three CHEF phases as pluggable protocol classes.

  Selector    — sample selection: INFL (+ Increm-INFL pruning) or one of the
                paper's Exp1 baselines. INFL's score-shaped work dispatches
                through the session's `Backend` (reference | cuda).
  Annotator   — the annotation phase. `SimulatedAnnotator` computes the voted
                labels deterministically and hands back an `AnnotationTask`
                whose result becomes available only after the configured
                human latency, the window the pipelined scheduler overlaps
                with compute. `predict()` gives what is known before the
                humans answer (INFL's suggested labels), which the
                scheduler speculates on.
  Constructor — the model-constructor phase: DeltaGrad-L replay or full
                retrain. Constructors are pure with respect to the session
                (they return a `ConstructorResult`; only
                `session.apply_round` commits), which makes speculating
                safe.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import annotation, baselines, increm, lr_head
from repro_torch.core.deltagrad import build_correction_schedule, deltagrad_replay
from repro_torch.core.influence import infl, influence_vector, top_b
from repro_torch.core.pipeline import train_head

SELECTORS = ("full", "increm", "increm_tight")
BASELINES = ("infl_d", "infl_y", "active_one", "active_two", "o2u", "tars", "duti", "loss",
             "random")


class RoundSelection(NamedTuple):
    idx: torch.Tensor  # [b] selected sample indices
    priority: torch.Tensor  # [N]
    suggested: Optional[torch.Tensor]  # [N] proposed labels (None: the method has none)
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


@dataclass(frozen=True)
class BaselineSelector:
    """The paper's Exp1 baselines (`core.baselines`) behind the same
    protocol: infl_d | infl_y | active_one | active_two | o2u | tars | duti |
    loss | random. As in the JAX package, INFL-D/Y solve for the influence
    vector on the reference backend, and O2U trains its own head from zeros
    on a 4-epoch schedule drawn with seed `cfg.seed + 7`."""

    method: str

    def select(self, session, eligible, generator) -> RoundSelection:
        """This round's top-b selection by the baseline's priority."""
        cfg, ds = session.cfg, session.ds
        Xa, Xa_val, w = session.Xa, session.Xa_val, session.w
        m = self.method
        if m in ("infl_d", "infl_y"):
            v, _ = influence_vector(w, Xa_val, ds.y_val, Xa, ds.y_weight, cfg.l2,
                                    cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
            sel = (baselines.select_infl_d(w, v, Xa, ds.y_prob) if m == "infl_d"
                   else baselines.select_infl_y(w, v, Xa, ds.y_prob))
        elif m == "active_one":
            sel = baselines.select_active_one(w, Xa)
        elif m == "active_two":
            sel = baselines.select_active_two(w, Xa)
        elif m == "loss":
            sel = baselines.select_loss(w, Xa, ds.y_prob)
        elif m == "random":
            sel = baselines.select_random(generator, ds.n, Xa.device)
        elif m == "o2u":
            sched = lr_head.batch_schedule(cfg.seed + 7, ds.n, min(cfg.batch_size, ds.n),
                                           4).to(Xa.device)
            w0 = lr_head.init_head(generator, ds.n_classes, ds.X.shape[1], device=Xa.device)
            sel = baselines.select_o2u(w0, Xa, ds.y_prob, ds.y_weight, sched, l2=cfg.l2,
                                       lr_max=cfg.lr * 4)
        elif m == "tars":
            sel = baselines.select_tars_lite(w, Xa, ds.y_prob, ds.human_labels, ds.n_classes)
        elif m == "duti":
            sel = baselines.select_duti_lite(w, Xa, ds.y_prob, ds.y_weight, Xa_val, ds.y_val,
                                             l2=cfg.l2, lr=cfg.lr)
        else:
            raise ValueError(f"unknown baseline {m!r}; expected one of {BASELINES}")
        idx = top_b(sel.priority, eligible, cfg.round_size)
        return RoundSelection(idx, sel.priority, sel.suggested, ds.n)


def make_selector(method: str, selector: str) -> Selector:
    """(method, selector) in `run_chef`'s vocabulary -> a Selector object."""
    if selector not in SELECTORS:
        raise ValueError(f"unknown selector {selector!r}; expected one of {SELECTORS}")
    if method == "infl":
        return InflSelector(mode=selector)
    if method not in BASELINES:
        raise ValueError(f"unknown method {method!r}; expected 'infl' or one of {BASELINES}")
    if selector != "full":
        raise ValueError("Increm-INFL prunes INFL scores: use selector='full' with a baseline")
    return BaselineSelector(method)


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

    def predict(self, session, selection: RoundSelection) -> Optional[torch.Tensor]: ...


@dataclass(frozen=True)
class SimulatedAnnotator:
    """Section 5.1 annotators: majority vote over the dataset's simulated
    human labels, with INFL joining per the strategy (one | two | three)."""

    strategy: str = "three"
    latency_s: float = 0.0

    def _vote_inputs(self, session, selection: RoundSelection):
        """(human labels, suggested labels, strategy) of the selected rows:
        the humans alone (strategy one) when the selector suggests none."""
        humans = session.ds.human_labels[selection.idx]
        if selection.suggested is not None:
            return humans, selection.suggested[selection.idx], self.strategy
        return humans, torch.zeros_like(selection.idx), "one"

    def annotate(self, session, selection: RoundSelection, generator) -> AnnotationTask:
        """Start the vote on the selected rows."""
        humans, suggested, strategy = self._vote_inputs(session, selection)
        labels = annotation.cleaned_labels(strategy, humans, suggested, session.ds.n_classes,
                                           generator=generator)
        return AnnotationTask(labels, self.latency_s)

    def predict(self, session, selection: RoundSelection) -> Optional[torch.Tensor]:
        """Best guess at the voted labels from what is known before the vote:
        INFL's suggestions (None where the selector suggests none). Exact
        under strategy 'two', where the suggestions are the labels."""
        if selection.suggested is None:
            return None
        return selection.suggested[selection.idx].to(torch.int64)


@runtime_checkable
class Constructor(Protocol):
    def construct(self, session, idx, labels) -> ConstructorResult: ...


@dataclass(frozen=True)
class DeltaGradConstructor:
    """DeltaGrad-L incremental replay against the round-(k-1) cache
    (Section 4.2 item (2)): cached gradients were computed on the old labels;
    corrections cover only this round's b samples. The replay dispatches
    through the session's `Backend` (explicit batch gradients + corrections)
    and its refreshed trajectory is the next round's cache."""

    def construct(self, session, idx, labels) -> ConstructorResult:
        """Clean `idx` with `labels` and replay the cached trajectory."""
        ds_old = session.ds
        ds_new = ds_old.clean(idx, labels)
        ci, cm = build_correction_schedule(session.sched.cpu().numpy(), idx.cpu().numpy())
        w, traj = deltagrad_replay(session.traj[0], session.traj[1], session.sched, session.Xa,
                                   ds_old.y_prob, ds_new.y_prob, ds_old.y_weight,
                                   ds_new.y_weight, ci, cm, session.dgc,
                                   int(session.sched.shape[1]), backend=session.backend)
        return ConstructorResult(ds_new, w, traj, session.sched)


@dataclass(frozen=True)
class RetrainConstructor:
    """Full from-scratch retrain (the paper's Retrain baseline); the SGD loop
    dispatches through the session's `Backend`. Caches a fresh trajectory
    only when a DeltaGrad round may still follow."""

    cache_trajectory: bool = False

    def construct(self, session, idx, labels) -> ConstructorResult:
        """Clean `idx` with `labels` and retrain the head from scratch."""
        ds_new = session.ds.clean(idx, labels)
        w, traj, sched = train_head(ds_new, session.cfg, cache=self.cache_trajectory,
                                    backend=session.backend, device=session.Xa.device)
        return ConstructorResult(ds_new, w, traj, sched)


def make_constructor(name: str) -> Constructor:
    """Constructor by name: deltagrad | retrain."""
    if name == "deltagrad":
        return DeltaGradConstructor()
    if name == "retrain":
        return RetrainConstructor()
    raise ValueError(f"unknown constructor {name!r}; expected 'deltagrad' or 'retrain'")
