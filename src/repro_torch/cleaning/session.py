"""`CleaningSession` — the state object of one CHEF cleaning run.

A session owns the loop's mutable state explicitly: the round counter and
the budget ledger, the dataset's label state, the current head `w`, the
batch schedule, the trajectory handle, the Increm-INFL provenance and the
base seed. Round k's generators are a pure function of (seed, k)
(`round_generators`), never drawn in sequence, so round k's randomness does
not depend on what ran before it.

Checkpointing (`save`, `restore`, `restore_elastic`) waits until `ckpt/`
is ported (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import torch

from repro_torch.configs.chef_lr import ChefConfig
from repro_torch.core import lr_head
from repro_torch.core.backend import Backend, get_backend
from repro_torch.core.increm import Provenance, build_provenance
from repro_torch.core.pipeline import RoundRecord, train_head
from repro_torch.device import resolve_device


def round_generators(seed: int, k: int) -> tuple[torch.Generator, torch.Generator]:
    """(select, vote) CPU generators of round k of the session seeded `seed`."""
    base = (seed * 1_000_003 + k) * 2
    return torch.Generator().manual_seed(base), torch.Generator().manual_seed(base + 1)


@dataclass
class BudgetLedger:
    """Cleaning-budget accounting: `total` = B, `spent` = labels cleaned."""

    total: int
    spent: int = 0

    @property
    def remaining(self) -> int:
        """Labels the budget still pays for."""
        return self.total - self.spent

    def can_afford(self, b: int) -> bool:
        """Whether b more labels fit in the budget."""
        return b <= self.remaining

    def charge(self, b: int) -> None:
        """Spend b labels; raises if that exceeds the budget."""
        if not self.can_afford(b):
            raise ValueError(f"budget exceeded: spent={self.spent} + {b} > {self.total}")
        self.spent += b


@dataclass
class CleaningSession:
    """All mutable state of one cleaning run + cached derived tensors."""

    ds: "object"  # ChefDataset — label state evolves round to round
    cfg: ChefConfig
    backend: Backend
    w: torch.Tensor
    sched: torch.Tensor
    traj: Optional[tuple] = None  # (ws [T,C,d+1], gs [T,C,d+1]) DeltaGrad handle
    prov: Optional[Provenance] = None  # Increm-INFL provenance
    key: int = 0  # base seed of the per-round generators
    round: int = 0
    ledger: BudgetLedger = None  # type: ignore[assignment]
    history: list = field(default_factory=list)
    terminated: bool = False
    # derived caches
    Xa: torch.Tensor = None  # type: ignore[assignment]
    Xa_val: torch.Tensor = None  # type: ignore[assignment]

    @classmethod
    def initialize(cls, ds, cfg: ChefConfig, *, backend: "Backend | str | None" = None,
                   need_trajectory: bool = True, need_provenance: bool = True,
                   device=None) -> "CleaningSession":
        """Paper Initialization step on `device` (the card unless
        `device="cpu"`): train the head on the weak labels and build the
        provenance the later rounds need."""
        device = resolve_device(device)
        ds = ds.to(device)
        backend = get_backend(backend if backend is not None else cfg.backend)
        w, traj, sched = train_head(ds, cfg, cache=need_trajectory, backend=backend,
                                    device=device)
        session = cls(ds=ds, cfg=cfg, backend=backend, w=w, sched=sched, traj=traj,
                      key=cfg.seed + 1, ledger=BudgetLedger(cfg.budget),
                      Xa=lr_head.augment(ds.X), Xa_val=lr_head.augment(ds.X_val))
        if need_provenance:
            session.prov = build_provenance(w, session.Xa, power_iters=cfg.power_iters,
                                            backend=backend)
        return session

    def eligible(self) -> torch.Tensor:
        """[N] bool — rows the selector may pick this round: those not yet
        cleaned."""
        return ~self.ds.cleaned

    def round_keys(self, k: int):
        """(select, vote) generators of round k — a pure function of (key, k)."""
        return round_generators(self.key, k)

    def child(self, ds_new, w, traj, sched) -> "CleaningSession":
        """A view of the post-round session that shares the immutable caches
        and swaps the round-evolving state; nothing done to it changes `self`."""
        return replace(self, ds=ds_new, w=w, traj=traj, sched=sched, round=self.round + 1,
                       history=list(self.history))

    def apply_round(self, ds_new, w, traj, sched, record: RoundRecord) -> None:
        """Commit one completed round (the only state mutation point)."""
        self.ledger.charge(int(ds_new.cleaned.sum()) - int(self.ds.cleaned.sum()))
        self.ds = ds_new
        self.w = w
        self.traj = traj
        self.sched = sched
        self.history.append(record)
        self.round += 1
