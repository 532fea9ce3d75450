"""The CHEF pipeline — Figure 1 loop (2):

  Initialization: train the head from scratch on the weak labels and build
  the Theorem-1 provenance (Increm-INFL).

  Each round (budget b << B):
    1. sample selector  — INFL, optionally pruned by Increm-INFL
    2. annotation       — simulated human annotators + INFL-as-annotator,
                          majority vote (strategy one/two/three)
    3. model constructor — full Retrain (DeltaGrad-L is not ported yet)

  until the budget B is exhausted or an early-termination policy fires.

`run_chef` drives a `CleaningSession` through the blocking `RoundScheduler`
of `repro_torch.cleaning`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.chef_lr import ChefConfig
from repro_torch.core import lr_head, metrics
from repro_torch.core.backend import Backend, get_backend
from repro_torch.device import resolve_device


@dataclass
class RoundRecord:
    round: int
    n_cleaned_total: int
    f1_val: float
    f1_test: float
    n_candidates: int  # Increm-INFL survivors (n == N when Full)
    t_select: float
    t_update: float
    suggested_match_truth: float  # fraction of INFL labels == ground truth


@dataclass
class ChefResult:
    w: torch.Tensor
    dataset: object
    history: list
    f1_test_final: float
    f1_val_final: float
    terminated_early: bool


def _evaluate(w, ds):
    pred_val = torch.argmax(lr_head.probs(w, lr_head.augment(ds.X_val)), dim=-1)
    pred_test = torch.argmax(lr_head.probs(w, lr_head.augment(ds.X_test)), dim=-1)
    f1v = metrics.f1(pred_val, torch.argmax(ds.y_val, dim=-1), ds.n_classes)
    f1t = metrics.f1(pred_test, ds.y_test, ds.n_classes)
    return float(f1v), float(f1t)


def train_head(ds, cfg: ChefConfig, w0=None, cache: bool = True,
               backend: "Backend | str | None" = None, device=None):
    """Initialization-step training (plain SGD, paper Section 5.1) on
    `device` (the card unless `device="cpu"`; the dataset moves there).
    Returns (w, traj, sched); traj is None unless `cache`."""
    device = resolve_device(device)
    ds = ds.to(device)
    bk = get_backend(backend)
    Xa = lr_head.augment(ds.X)
    if w0 is None:
        w0 = lr_head.init_head(None, ds.n_classes, ds.X.shape[1], device=device)
    sched = lr_head.batch_schedule(cfg.seed, ds.n, min(cfg.batch_size, ds.n),
                                   cfg.n_epochs).to(device)
    w, traj = lr_head.sgd_train(w0, Xa, ds.y_prob, ds.y_weight, sched, l2=cfg.l2, lr=cfg.lr,
                                momentum=cfg.momentum, cache_trajectory=cache, backend=bk)
    return w, traj, sched


def run_chef(ds, cfg: ChefConfig, *, method: str = "infl", selector: str = "increm",
             constructor: str = "retrain", backend: "Backend | str | None" = None,
             verbose: bool = False, device=None) -> ChefResult:
    """One blocking, single-session CHEF run (the paper's loop) on `device`
    (the card unless `device="cpu"`).

    method: infl (the baselines are not ported yet);
    selector: full | increm | increm_tight; constructor: retrain (DeltaGrad-L
    is not ported yet). `backend` defaults to `cfg.backend`."""
    from repro_torch.cleaning import CleaningSession, make_scheduler

    if selector != "full" and method != "infl":
        raise ValueError("Increm-INFL prunes INFL scores: use selector='full' with a baseline")
    backend = get_backend(backend if backend is not None else cfg.backend)
    session = CleaningSession.initialize(
        ds, cfg, backend=backend, need_trajectory=(constructor == "deltagrad"),
        need_provenance=selector.startswith("increm"), device=device)
    return make_scheduler(session, method=method, selector=selector, constructor=constructor,
                          verbose=verbose).run()
