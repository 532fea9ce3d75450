"""`StreamingCleaningSession` — online CHEF over arriving data (the port of
`repro/stream/session.py`).

Wraps one `cleaning.CleaningSession` and its `RoundScheduler` around a
`WindowStore` fed by a `StreamSource`. Between cleaning rounds the session
ingests a window and either

  * **warm-starts** (`warm_start=True`, the streaming design): ONE
    capacity-wide session lives for the whole stream. The head was trained
    over the capacity (padding rows are weight-0 exact neutrals, so the
    batch schedule drawn over N_cap is, bit for bit, a schedule over the
    rows that have arrived), and a window append is absorbed as a
    DeltaGrad-L correction replay (`core.deltagrad.absorb_rows`: the
    arriving rows go from (padding, weight 0) to (weak labels, weight
    gamma), a label / weight change) plus an O(window) Increm-INFL
    provenance extension (`core.increm.extend_provenance`, at the same w0).
    No retrain, no re-anchoring.

  * **cold-restarts** (`warm_start=False`, the retrain oracle): each ingest
    re-initializes a from-scratch `CleaningSession` on the dense [0, n)
    rows, carrying the label state, budget ledger, round counter and
    history forward. A stream whose windows all arrive before the first
    round is then bit for bit a batch `CleaningSession` on the concatenated
    rows.

Checkpoint / resume is bit for bit: the checkpoint holds the inner
session's `state_tree()` plus the store's capacity arrays and the ingest
cursor, and `restore` fast-forwards the source past the windows already
ingested. The provenance extension's power-method draw comes from
`provenance_generator(seed, k)`, a pure function of the window count, so a
resumed run draws what the uninterrupted one drew (a test hands the port
the JAX package's draw there).

The annotation phase is pluggable: pass `annotator=ModelAnnotator(engine)`
to relabel candidates through a `ServeEngine` instead of the simulated
human vote. In warm mode the scheduler, and a selection it prefetched, live
on across an ingest, as in `repro`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.cleaning.phases import (Annotator, SimulatedAnnotator, make_constructor,
                                         make_selector)
from repro_torch.cleaning.scheduler import RoundScheduler, make_termination
from repro_torch.cleaning.session import CleaningSession
from repro_torch.configs.chef_lr import ChefConfig
from repro_torch.core import lr_head
from repro_torch.core.backend import Backend, get_backend
from repro_torch.core.deltagrad import absorb_rows
from repro_torch.core.increm import extend_provenance
from repro_torch.core.pipeline import ChefResult
from repro_torch.device import resolve_device
from repro_torch.stream.ingest import StreamSource
from repro_torch.stream.window import WindowStore

_STREAM_KEYS = ("stream_X", "stream_y_true", "stream_human", "stream_X_val", "stream_y_val",
                "stream_X_test", "stream_y_test", "stream_n", "stream_windows", "stream_step")


def provenance_generator(seed: int, k: int) -> torch.Generator:
    """The CPU generator of the provenance extension at the k-th window of a
    stream seeded `seed` (`repro` folds k into key(seed + 2))."""
    return torch.Generator().manual_seed(((seed + 2) * 1_000_003 + k) * 2)


class StreamingCleaningSession:
    """Drive CHEF cleaning over a stream of windows on `device` (the card
    unless `device="cpu"`; see the module docstring).

    `capacity` defaults to the source's total row budget; `warm_start`
    selects absorb-by-replay (True) or the from-scratch retrain oracle
    (False). Round phases come from `run_chef`'s vocabulary (`method` /
    `selector` / `constructor`); `annotator` overrides the simulated human
    vote (e.g. a `ModelAnnotator`). `backend` defaults to `cfg.backend`."""

    def __init__(self, source: StreamSource, cfg: ChefConfig, *,
                 backend: "Backend | str | None" = None, warm_start: bool = True,
                 capacity: Optional[int] = None, method: str = "infl",
                 selector: str = "increm", constructor: str = "deltagrad",
                 pipelined: bool = False, annotator: Optional[Annotator] = None,
                 ckpt_dir=None, ckpt_keep: int = 3, device=None):
        if warm_start and constructor != "deltagrad":
            raise ValueError("warm_start streaming absorbs windows by trajectory replay "
                             "and therefore requires constructor='deltagrad'")
        self.source = source
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = get_backend(backend if backend is not None else cfg.backend)
        self.warm_start = bool(warm_start)
        self.opts = dict(method=method, selector=selector, constructor=constructor,
                         pipelined=pipelined)
        self._selector = make_selector(method, selector)
        self._constructor = make_constructor(constructor)
        self._annotator = annotator if annotator is not None else \
            SimulatedAnnotator(cfg.strategy, cfg.annotator_latency_s)
        self._iter = iter(source.windows())
        self.store = WindowStore.create(source, capacity=capacity, device=self.device)
        self.windows_ingested = 0
        self._inner: Optional[CleaningSession] = None
        self._sched: Optional[RoundScheduler] = None
        self._step = 0
        self.ckpt = None
        if ckpt_dir is not None:
            from repro_torch.ckpt import CheckpointManager

            self.ckpt = CheckpointManager(ckpt_dir, keep=ckpt_keep)

    # ------------------------------------------------------------- lifecycle
    @property
    def session(self) -> Optional[CleaningSession]:
        """The inner cleaning session (None before the first ingest)."""
        return self._inner

    def _needs(self) -> dict:
        return dict(need_trajectory=(self.opts["constructor"] == "deltagrad"),
                    need_provenance=self.opts["selector"].startswith("increm"))

    def _make_scheduler(self) -> None:
        self._sched = RoundScheduler(self._inner, self._selector, self._annotator,
                                     self._constructor, termination=make_termination(self.cfg),
                                     pipelined=self.opts["pipelined"])

    def _initialize(self, ds) -> CleaningSession:
        return CleaningSession.initialize(ds, self.cfg, backend=self.backend,
                                          device=self.device, **self._needs())

    def _init_inner(self) -> None:
        """First window: train the head (over the capacity rows when warm,
        padding rows being exact neutrals, or the dense rows when cold) and
        cache the trajectory / provenance the rounds need."""
        sess = self._initialize(self.store.ds if self.warm_start else self.store.dense())
        if self.warm_start:
            sess.eligible_mask = self.store.valid
        self._inner = sess
        self._make_scheduler()

    def _rebuild_cold(self) -> None:
        """Cold ingest: from-scratch re-init on the grown dense rows, label
        state / ledger / round counter / history carried forward — the
        stage-wise retrain oracle."""
        prev = self._inner
        sess = self._initialize(self.store.dense())
        sess.round = prev.round
        sess.ledger = prev.ledger
        sess.history = list(prev.history)
        sess.terminated = prev.terminated
        self._inner = sess
        self._make_scheduler()

    def _absorb(self, ds_pre, idx) -> None:
        """Warm ingest: absorb the arriving rows into the capacity session —
        DeltaGrad-L correction replay for the head and trajectory, O(window)
        provenance extension at the shared w0, validity mask grown. The
        batch schedule and the trajectory's shape stay as they were."""
        s = self._inner
        ds_post = self.store.ds
        s.Xa = s.Xa.index_copy(0, idx, lr_head.augment(ds_post.X[idx]))
        w, traj = absorb_rows(s.traj, s.sched, s.Xa, ds_pre.y_prob, ds_post.y_prob,
                              ds_pre.y_weight, ds_post.y_weight, idx, s.dgc, backend=s.backend)
        s.ds = ds_post
        s.w = w
        s.traj = traj
        if s.prov is not None:
            s.prov = extend_provenance(
                s.prov, s.Xa[idx], power_iters=self.cfg.power_iters,
                generator=provenance_generator(self.cfg.seed, self.windows_ingested), at=idx,
                backend=s.backend)
        s.eligible_mask = self.store.valid

    def ingest(self) -> int:
        """Pull the next window into the store and extend the session to it
        (initialize / absorb / cold rebuild by mode). Returns the number of
        rows ingested — 0 when the stream is exhausted."""
        win = next(self._iter, None)
        if win is None:
            return 0
        if self._inner is not None:
            self.store = self.store.write_labels(self._inner.ds)
        ds_pre = self.store.ds
        self.store, idx = self.store.append(win)
        self.windows_ingested += 1
        if self._inner is None:
            self._init_inner()
        elif self.warm_start:
            self._absorb(ds_pre, idx)
        else:
            self._rebuild_cold()
        self._save()
        return win.m

    def clean(self, max_rounds: Optional[int] = None) -> list:
        """Run up to `max_rounds` cleaning rounds (None = to exhaustion) on
        the data ingested so far, checkpointing after every committed round.
        Returns the new `RoundRecord`s."""
        if self._sched is None:
            raise RuntimeError("no data ingested yet — call ingest() first")
        records = []
        while not self._sched.exhausted and (max_rounds is None or len(records) < max_rounds):
            records.append(self._sched.step())
            self._save()
        return records

    def run(self, rounds_per_window: int = 1) -> ChefResult:
        """The online loop: ingest each arriving window, clean
        `rounds_per_window` rounds between arrivals, then clean to budget
        exhaustion / termination once the stream ends."""
        while self.ingest():
            self.clean(rounds_per_window)
        self.clean(None)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.result()

    def result(self) -> ChefResult:
        """Final `ChefResult` from the inner scheduler."""
        if self._sched is None:
            raise RuntimeError("no data ingested yet — call ingest() first")
        return self._sched.result()

    # --------------------------------------------------------- checkpointing
    def state_tree(self) -> dict:
        """The inner session's leaves plus the stream's: the capacity arrays
        (features, truth, annotator labels), the evaluation splits, the fill
        level, and the ingest cursor the restore fast-forwards the source
        by."""
        t = self._inner.state_tree()
        ds = self.store.ds
        t.update({
            "stream_X": ds.X, "stream_y_true": ds.y_true, "stream_human": ds.human_labels,
            "stream_X_val": ds.X_val, "stream_y_val": ds.y_val,
            "stream_X_test": ds.X_test, "stream_y_test": ds.y_test,
            "stream_n": np.int32(self.store.n),
            "stream_windows": np.int32(self.windows_ingested),
            "stream_step": np.int32(self._step),
        })
        return t

    def _save(self) -> None:
        if self.ckpt is None or self._inner is None:
            return
        self._step += 1
        self.ckpt.save(self._step, self.state_tree(), blocking=False)

    @classmethod
    def restore(cls, ckpt_dir, source: StreamSource, cfg: ChefConfig, *,
                backend: "Backend | str | None" = None, warm_start: bool = True,
                capacity: Optional[int] = None, step: Optional[int] = None, device=None,
                **kw) -> "StreamingCleaningSession":
        """Rebuild a streaming session on `device` (the card unless
        `device="cpu"`) from its latest committed checkpoint, or from `step`:
        the store's arrays and the inner session's state from the
        checkpoint, the source fast-forwarded past the windows already
        ingested. The resumed run repeats the uninterrupted one bit for bit."""
        from repro_torch.ckpt.checkpoint import restore_checkpoint

        keys = CleaningSession.state_template() + _STREAM_KEYS
        state, _ = restore_checkpoint(ckpt_dir, keys, step=step)
        obj = cls(source, cfg, backend=backend, warm_start=warm_start, capacity=capacity,
                  ckpt_dir=ckpt_dir, device=device, **kw)
        obj.store = WindowStore.from_arrays(
            state["stream_X"], state["stream_y_true"], state["stream_human"],
            n=int(state["stream_n"]), gamma=float(source.gamma),
            X_val=state["stream_X_val"], y_val=state["stream_y_val"],
            X_test=state["stream_X_test"], y_test=state["stream_y_test"],
            n_classes=int(source.n_classes), device=obj.device)
        obj.windows_ingested = int(state["stream_windows"])
        obj._step = int(state["stream_step"])
        for _ in range(obj.windows_ingested):  # fast-forward the source
            next(obj._iter)
        ds_view = obj.store.ds if warm_start else obj.store.dense()
        inner = CleaningSession.from_state(state, ds_view, cfg, backend=obj.backend,
                                           device=obj.device)
        if warm_start:
            inner.eligible_mask = obj.store.valid
        obj._inner = inner
        obj._make_scheduler()
        return obj
