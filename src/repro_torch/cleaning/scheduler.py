"""The blocking round scheduler and the early-termination policies.

Each round runs select -> annotate -> construct, then commits:

    t_round = t_select + latency + t_update

With `ckpt_dir` the session checkpoints every `ckpt_every` committed rounds
through `repro_torch.ckpt.CheckpointManager` (async writes overlap the next
round), so a killed job resumes bit for bit (`CleaningSession.restore`).

Not ported yet (ROADMAP.md): the JAX package's pipelined speculation
(overlapping the annotation latency with a speculative update and the next
round's scoring) — `make_scheduler(pipelined=True)` refuses it — and its
`Heartbeat` and `retry_step` hooks, which wait for the port of
`dist/fault.py`.

Early termination is first-class: `TargetF1`, `Patience`, and
`MarginalF1PerLabel` policy objects (composable; any firing stops the run).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.cleaning.phases import (
    Annotator,
    Constructor,
    ConstructorResult,
    RoundSelection,
    Selector,
    SimulatedAnnotator,
    make_constructor,
    make_selector,
)
from repro_torch.cleaning.session import CleaningSession
from repro_torch.core.pipeline import ChefResult, RoundRecord, _evaluate
from repro_torch.device import block_until_ready


@runtime_checkable
class TerminationPolicy(Protocol):
    def should_stop(self, history: Sequence[RoundRecord]) -> bool: ...


@dataclass(frozen=True)
class TargetF1:
    """Stop once validation F1 reaches the target (paper's early stop)."""

    target: float

    def should_stop(self, history) -> bool:
        """Whether the last round reached the target."""
        return bool(history) and history[-1].f1_val >= self.target


@dataclass(frozen=True)
class Patience:
    """Stop after `rounds` consecutive rounds in which the best validation F1
    failed to improve by MORE than `min_delta` (0 = any plateau stops)."""

    rounds: int
    min_delta: float = 0.0

    def should_stop(self, history) -> bool:
        """Whether the last `rounds` rounds failed to improve."""
        if len(history) <= self.rounds:
            return False
        best_before = max(r.f1_val for r in history[: -self.rounds])
        recent_best = max(r.f1_val for r in history[-self.rounds:])
        return recent_best <= best_before + self.min_delta


@dataclass(frozen=True)
class MarginalF1PerLabel:
    """Stop when the marginal validation-F1 gain per cleaned label drops
    below `min_gain`: stop when a label stops buying F1."""

    min_gain: float

    def should_stop(self, history) -> bool:
        """Whether the last round's gain per label fell below `min_gain`."""
        if len(history) < 2:
            return False
        prev, last = history[-2], history[-1]
        labels = last.n_cleaned_total - prev.n_cleaned_total
        return labels > 0 and (last.f1_val - prev.f1_val) / labels < self.min_gain


def make_termination(cfg) -> tuple:
    """ChefConfig knobs -> policy objects (all default-disabled)."""
    policies = []
    if cfg.target_f1:
        policies.append(TargetF1(cfg.target_f1))
    if cfg.patience:
        policies.append(Patience(cfg.patience, cfg.patience_delta))
    if cfg.min_f1_per_label:
        policies.append(MarginalF1PerLabel(cfg.min_f1_per_label))
    return tuple(policies)


class _RoundOutcome(NamedTuple):
    """Everything round k computed, before any of it is committed."""

    round: int
    selection: RoundSelection
    t_select: float
    result: ConstructorResult
    t_update: float


class RoundScheduler:
    """Drives one `CleaningSession` through blocking select -> annotate ->
    construct rounds."""

    def __init__(self, session: CleaningSession, selector: Selector, annotator: Annotator,
                 constructor: Constructor, *, termination: Sequence[TerminationPolicy] = (),
                 ckpt_dir=None, ckpt_every: int = 1, ckpt_keep: int = 3,
                 verbose: bool = False):
        self.session = session
        self.selector = selector
        self.annotator = annotator
        self.constructor = constructor
        self.termination = tuple(termination)
        self.verbose = verbose
        self.ckpt = None
        self.ckpt_every = ckpt_every
        if ckpt_dir is not None:
            from repro_torch.ckpt import CheckpointManager

            self.ckpt = CheckpointManager(ckpt_dir, keep=ckpt_keep)

    @property
    def exhausted(self) -> bool:
        """Whether the run is over: terminated early or out of budget."""
        s = self.session
        return s.terminated or not s.ledger.can_afford(s.cfg.round_size)

    def run(self, max_rounds: Optional[int] = None) -> ChefResult:
        """Run rounds until the budget ends, a policy fires, or `max_rounds`."""
        done = 0
        while not self.exhausted and (max_rounds is None or done < max_rounds):
            self.step()
            done += 1
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.result()

    def result(self) -> ChefResult:
        """The run's result so far."""
        s = self.session
        if s.history:
            f1v, f1t = s.history[-1].f1_val, s.history[-1].f1_test
        else:
            f1v, f1t = _evaluate(s.w, s.ds)
        return ChefResult(s.w, s.ds, list(s.history), f1t, f1v, s.terminated)

    def step(self) -> RoundRecord:
        """Compute and commit one round."""
        return self._commit(self._compute_round())

    def _compute_round(self) -> _RoundOutcome:
        """Select / annotate / construct for the current round. Mutates no
        scheduler or session state."""
        s = self.session
        k = s.round
        g_sel, g_vote = s.round_keys(k)
        t0 = time.perf_counter()
        selection = self.selector.select(s, s.eligible(), g_sel)
        block_until_ready(selection.idx)
        t_select = time.perf_counter() - t0

        labels = self.annotator.annotate(s, selection, g_vote).result()

        t1 = time.perf_counter()
        result = self.constructor.construct(s, selection.idx, labels)
        block_until_ready(result.w)
        t_update = time.perf_counter() - t1
        return _RoundOutcome(k, selection, t_select, result, t_update)

    def _commit(self, o: _RoundOutcome) -> RoundRecord:
        """Apply one computed round: the only state-mutation point."""
        s = self.session
        selection, result = o.selection, o.result
        match = (float(torch.mean((selection.suggested[selection.idx]
                                   == s.ds.y_true[selection.idx]).to(torch.float32)))
                 if selection.suggested is not None else float("nan"))
        f1v, f1t = _evaluate(result.w, result.ds)
        record = RoundRecord(o.round, int(result.ds.cleaned.sum()), f1v, f1t,
                             selection.n_candidates, o.t_select, o.t_update, match)
        s.apply_round(result.ds, result.w, result.traj, result.sched, record)
        if any(p.should_stop(s.history) for p in self.termination):
            s.terminated = True
        if self.verbose:
            print(f"round {o.round}: cleaned={record.n_cleaned_total} f1_val={f1v:.4f} "
                  f"f1_test={f1t:.4f} cand={record.n_candidates} "
                  f"sel={o.t_select:.3f}s upd={o.t_update:.3f}s")
        if self.ckpt is not None and self.ckpt_every and s.round % self.ckpt_every == 0:
            s.save(self.ckpt)
        return record


def make_scheduler(session: CleaningSession, *, method: str = "infl", selector: str = "increm",
                   constructor: str = "deltagrad", pipelined: bool = False,
                   **kw) -> RoundScheduler:
    """`run_chef`-vocabulary convenience constructor. `kw` goes to
    `RoundScheduler` (ckpt_dir, ckpt_every, ckpt_keep, verbose)."""
    if pipelined:
        raise NotImplementedError("pipelined speculation is not ported yet; use pipelined=False")
    cfg = session.cfg
    return RoundScheduler(session, make_selector(method, selector),
                          SimulatedAnnotator(cfg.strategy, cfg.annotator_latency_s),
                          make_constructor(constructor), termination=make_termination(cfg), **kw)
