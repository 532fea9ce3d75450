"""The round scheduler, blocking or pipelined, and the early-termination
policies.

The blocking loop runs select -> annotate -> construct, then commits, and
pays

    t_round = t_select + latency + t_update

per round (latency: the human annotation turnaround). The pipelined loop
overlaps the latency with speculation: while round k's annotators are still
voting it
  1. runs the model constructor on the PREDICTED labels (INFL's suggested
     labels: exactly the votes under strategy 'two', a likely guess under
     'one' and 'three'), and
  2. prefetches round k+1's selection against that speculative model,
then checks: if the votes equal the prediction the speculative round is
adopted whole (t_round about max(latency, t_update + t_select)); if not, the
speculation is dropped and the constructor reruns on the real votes.
Speculation is checked against the votes and the constructors repeat bit
for bit, so the pipelined loop gives the blocking loop's selections, labels
and weights bit for bit: timing moves, results do not.

With `ckpt_dir` the session checkpoints every `ckpt_every` committed rounds
through `repro_torch.ckpt.CheckpointManager` (async writes overlap the next
round), so a killed job resumes bit for bit (`CleaningSession.restore`).
The JAX package's `Heartbeat` and `retry_step` hooks wait for the port of
`dist/fault.py` (ROADMAP.md).

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


class _Prefetch(NamedTuple):
    round: int
    selection: RoundSelection
    t_select: float  # compute time spent (hidden inside the latency)


class _Speculation(NamedTuple):
    labels: torch.Tensor
    result: ConstructorResult
    t_update: float
    prefetch: Optional[_Prefetch]


class _RoundOutcome(NamedTuple):
    """Everything round k computed, before any of it is committed."""

    round: int
    selection: RoundSelection
    t_select: float
    result: ConstructorResult
    t_update: float
    spec: Optional[str]  # "hit" | "miss" | None (not pipelined / no prediction)
    prefetch: Optional[_Prefetch]


class RoundScheduler:
    """Drives one `CleaningSession` through select -> annotate -> construct
    rounds, blocking or pipelined (see the module docstring)."""

    def __init__(self, session: CleaningSession, selector: Selector, annotator: Annotator,
                 constructor: Constructor, *, termination: Sequence[TerminationPolicy] = (),
                 pipelined: bool = False, ckpt_dir=None, ckpt_every: int = 1,
                 ckpt_keep: int = 3, verbose: bool = False):
        self.session = session
        self.selector = selector
        self.annotator = annotator
        self.constructor = constructor
        self.termination = tuple(termination)
        self.pipelined = pipelined
        self.verbose = verbose
        self.spec_hits = 0
        self.spec_misses = 0
        self._prefetch: Optional[_Prefetch] = None
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
        scheduler or session state (`self._prefetch` is only read)."""
        s = self.session
        k = s.round
        g_sel, g_vote = s.round_keys(k)
        pf = self._prefetch  # selected inside round k-1's wait
        if pf is not None and pf.round == k:
            selection, t_select = pf.selection, pf.t_select
        else:
            t0 = time.perf_counter()
            selection = self.selector.select(s, s.eligible(), g_sel)
            block_until_ready(selection.idx)
            t_select = time.perf_counter() - t0

        task = self.annotator.annotate(s, selection, g_vote)
        spec: Optional[_Speculation] = None
        if self.pipelined and not task.ready():
            pred = self.annotator.predict(s, selection)
            if pred is not None:
                spec = self._speculate(k, selection, pred)
        labels = task.result()

        # adopt the speculation only where the votes equal its labels (a
        # host sync)
        if spec is not None and torch.equal(labels, spec.labels):
            return _RoundOutcome(k, selection, t_select, spec.result, spec.t_update, "hit",
                                 spec.prefetch)
        t1 = time.perf_counter()
        result = self.constructor.construct(s, selection.idx, labels)
        block_until_ready(result.w)
        t_update = time.perf_counter() - t1
        return _RoundOutcome(k, selection, t_select, result, t_update,
                             "miss" if spec is not None else None, None)

    def _speculate(self, k: int, selection: RoundSelection, pred) -> _Speculation:
        """Run the constructor and the next round's selection on the
        predicted labels while the annotators are still voting. Changes
        nothing of the session: the selection runs on `session.child`, with
        round k+1's generators made afresh by `round_keys`."""
        s = self.session
        t1 = time.perf_counter()
        result = self.constructor.construct(s, selection.idx, pred)
        block_until_ready(result.w)
        t_update = time.perf_counter() - t1
        prefetch = None
        # prefetch round k+1's selection unless the budget already ends the run
        if s.ledger.remaining >= 2 * s.cfg.round_size:
            child = s.child(result.ds, result.w, result.traj, result.sched)
            g_sel_next, _ = s.round_keys(k + 1)
            t0 = time.perf_counter()
            sel_next = self.selector.select(child, child.eligible(), g_sel_next)
            block_until_ready(sel_next.idx)
            prefetch = _Prefetch(k + 1, sel_next, time.perf_counter() - t0)
        return _Speculation(pred, result, t_update, prefetch)

    def _commit(self, o: _RoundOutcome) -> RoundRecord:
        """Apply one computed round: the only state-mutation point."""
        s = self.session
        self._prefetch = o.prefetch
        if o.spec == "hit":
            self.spec_hits += 1
        elif o.spec == "miss":
            self.spec_misses += 1
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
    cfg = session.cfg
    return RoundScheduler(session, make_selector(method, selector),
                          SimulatedAnnotator(cfg.strategy, cfg.annotator_latency_s),
                          make_constructor(constructor), termination=make_termination(cfg),
                          pipelined=pipelined, **kw)
