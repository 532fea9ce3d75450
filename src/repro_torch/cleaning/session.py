"""`CleaningSession` — the resumable state object of one CHEF cleaning run.

A session owns the loop's mutable state explicitly: the round counter and
the budget ledger, the dataset's label state, the current head `w`, the
batch schedule, the DeltaGrad trajectory handle, the Increm-INFL provenance
and the base seed. Round k's generators are a pure function of (seed, k)
(`round_generators`), never drawn in sequence, so round k's randomness does
not depend on what ran before it.

Checkpointing goes through `repro_torch.ckpt` (atomic COMMIT-marker dirs,
async writes through `CheckpointManager`): `state_tree()` flattens the
mutable state into a fixed set of leaves, `restore()` rebuilds a session
from the latest committed round plus the immutable dataset and config the
caller still has. A session restored this way repeats the uninterrupted
run bit for bit. The leaves and layout are the JAX package's, so the port
restores a session that `repro` checkpointed; the one slot that differs is
`key` (see `state_tree`). `restore_elastic` waits for the port of the
`dist` layer.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.chef_lr import ChefConfig
from repro_torch.core import lr_head
from repro_torch.core.backend import Backend, get_backend
from repro_torch.core.deltagrad import DGConfig
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
    # an [N] bool constraint ANDed into the round's eligibility (None: every
    # row). The stream's window store sets it to its validity mask, so the
    # selector never proposes a padding row; derived stream state, never
    # checkpointed here.
    eligible_mask: Optional[torch.Tensor] = None
    # derived caches (rebuilt, never checkpointed)
    Xa: torch.Tensor = None  # type: ignore[assignment]
    Xa_val: torch.Tensor = None  # type: ignore[assignment]
    dgc: DGConfig = None  # type: ignore[assignment]

    @classmethod
    def initialize(cls, ds, cfg: ChefConfig, *, backend: "Backend | str | None" = None,
                   need_trajectory: bool = True, need_provenance: bool = True,
                   device=None) -> "CleaningSession":
        """Paper Initialization step on `device` (the card unless
        `device="cpu"`): train the head on the weak labels and cache the
        DeltaGrad / Increm-INFL provenance the later rounds need."""
        device = resolve_device(device)
        ds = ds.to(device)
        backend = get_backend(backend if backend is not None else cfg.backend)
        w, traj, sched = train_head(ds, cfg, cache=need_trajectory, backend=backend,
                                    device=device)
        session = cls(ds=ds, cfg=cfg, backend=backend, w=w, sched=sched, traj=traj,
                      key=cfg.seed + 1, ledger=BudgetLedger(cfg.budget))
        session._build_caches()
        if need_provenance:
            session.prov = build_provenance(w, session.Xa, power_iters=cfg.power_iters,
                                            backend=backend)
        return session

    def _build_caches(self) -> None:
        self.Xa = lr_head.augment(self.ds.X)
        self.Xa_val = lr_head.augment(self.ds.X_val)
        self.dgc = DGConfig(self.cfg.dg_burn_in, self.cfg.dg_period, self.cfg.dg_history,
                            self.cfg.lr, self.cfg.l2)

    def eligible(self) -> torch.Tensor:
        """[N] bool — rows the selector may pick this round: those not yet
        cleaned, and within `eligible_mask` where an owner (the stream's
        window store) set one."""
        e = ~self.ds.cleaned
        if self.eligible_mask is not None:
            e = e & self.eligible_mask
        return e

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

    # --------------------------------------------------------- checkpointing
    def state_tree(self) -> dict:
        """The mutable state as a fixed set of leaves (the checkpoint
        payload). Optional members (traj / prov) always occupy their slots —
        empty arrays + a flag — so the set never depends on the run
        configuration. `key` holds the port's int seed of the per-round
        generators, where the JAX package stores its PRNG key's data."""
        empty = np.zeros((0,), np.float32)
        has_traj = self.traj is not None
        has_prov = self.prov is not None
        hist = (np.array([[r.round, r.n_cleaned_total, r.f1_val, r.f1_test, r.n_candidates,
                           r.t_select, r.t_update, r.suggested_match_truth]
                          for r in self.history], np.float64)
                if self.history else np.zeros((0, 8), np.float64))
        return {
            "w": self.w,
            "sched": self.sched,
            "traj_ws": self.traj[0] if has_traj else empty,
            "traj_gs": self.traj[1] if has_traj else empty,
            "has_traj": np.int32(has_traj),
            "prov_w0": self.prov.w0 if has_prov else empty,
            "prov_p0": self.prov.p0 if has_prov else empty,
            "prov_hnorm": self.prov.hnorm if has_prov else empty,
            "has_prov": np.int32(has_prov),
            "key": np.int64(self.key),
            "y_prob": self.ds.y_prob,
            "y_weight": self.ds.y_weight,
            "cleaned": self.ds.cleaned,
            "round": np.int32(self.round),
            "spent": np.int32(self.ledger.spent),
            "terminated": np.int32(self.terminated),
            "history": hist,
        }

    def save(self, manager) -> None:
        """Checkpoint through a `repro_torch.ckpt.CheckpointManager` (step =
        round; the write runs in the background, overlapping the next
        round)."""
        manager.save(self.round, self.state_tree(), blocking=False)

    @staticmethod
    def state_template() -> tuple[str, ...]:
        """The leaf names of `state_tree()`, which a restore reads."""
        return tuple(convert.SESSION_STATE)

    @classmethod
    def restore(cls, ckpt_dir, ds, cfg: ChefConfig, *, backend: "Backend | str | None" = None,
                step: Optional[int] = None, device=None) -> "CleaningSession":
        """Rebuild a session on `device` (the card unless `device="cpu"`)
        from the latest committed checkpoint under `ckpt_dir`, or from
        `step`. `ds` and `cfg` supply the immutable parts (features, splits,
        annotator labels, hyper-parameters); the label state inside `ds` is
        overwritten by the checkpointed one."""
        from repro_torch.ckpt.checkpoint import restore_checkpoint

        state, _ = restore_checkpoint(ckpt_dir, cls.state_template(), step=step)
        return cls.from_state(state, ds, cfg, backend=backend, device=device)

    @classmethod
    def from_state(cls, state: dict, ds, cfg: ChefConfig, *,
                   backend: "Backend | str | None" = None, device=None) -> "CleaningSession":
        """Rebuild a session from an already-loaded `state_tree()` with numpy
        leaves (the port's or the JAX package's): the restore half without
        the checkpoint read."""
        device = resolve_device(device)
        backend = get_backend(backend if backend is not None else cfg.backend)
        st = convert.state_from_numpy(state, device)
        ds = replace(ds.to(device), y_prob=st["y_prob"], y_weight=st["y_weight"],
                     cleaned=st["cleaned"])
        traj = (st["traj_ws"], st["traj_gs"]) if int(st["has_traj"]) else None
        prov = (Provenance(st["prov_w0"], st["prov_p0"], st["prov_hnorm"])
                if int(st["has_prov"]) else None)
        history = [RoundRecord(int(r[0]), int(r[1]), float(r[2]), float(r[3]), int(r[4]),
                               float(r[5]), float(r[6]), float(r[7]))
                   for r in st["history"].reshape(-1, 8)]
        session = cls(ds=ds, cfg=cfg, backend=backend, w=st["w"], sched=st["sched"], traj=traj,
                      prov=prov, key=st["key"], round=int(st["round"]),
                      ledger=BudgetLedger(cfg.budget, spent=int(st["spent"])), history=history,
                      terminated=bool(int(st["terminated"])))
        session._build_caches()
        return session
