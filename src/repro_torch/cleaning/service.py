"""`CleaningService` — a queue of cleaning jobs over one backend and one
device (the port of `repro/cleaning/service.py`).

Many sessions share one card: teams submit cleaning jobs that run to
completion, report progress and can be cancelled. The service owns ONE
resolved `Backend` (`cuda` by default) and one device, and a pool of worker
threads that drain a FIFO queue of jobs:

    svc = CleaningService(workers=2)          # the card; device="cpu" to stay here
    job = svc.submit(ds, cfg, method="infl", selector="increm")
    svc.poll(job)            # -> JobInfo(state, rounds_done, f1_val, ...)
    svc.result(job)          # block until done -> ChefResult
    svc.cancel(job)          # pending: dropped; running: stops at the next
                             # round boundary (sessions stay resumable)
    svc.shutdown()

Cancellation is cooperative at round granularity, the granularity at which
sessions checkpoint, so a cancelled job with a `ckpt_dir` can be submitted
again with `submit(..., resume=True)` (`CleaningSession.restore` on the
worker) and finishes bit for bit like the uninterrupted run.

The workers launch on the calling thread's current stream, the card's
default stream, which they share: their kernels run one after another, so
the cooperative grids of `kernels/csrc/lr_gather.cuh`, which assume that
they have the card to themselves, never meet. The kernels build once at
first use even where two workers' first calls meet (`kernels/build.py`).
A job that raises ends FAILED with its error, and the other jobs go on.
"""
from __future__ import annotations

import itertools
import queue
import threading
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.cleaning.scheduler import RoundScheduler, make_scheduler
from repro_torch.cleaning.session import CleaningSession
from repro_torch.core.backend import Backend, get_backend
from repro_torch.device import resolve_device

PENDING, RUNNING, DONE, FAILED, CANCELLED = (
    "pending", "running", "done", "failed", "cancelled")


def prepare_session(ds, cfg, *, backend: Backend, selector: str = "full",
                    constructor: str = "retrain", ckpt_dir=None, resume: bool = False,
                    device=None) -> CleaningSession:
    """The session a cleaning job runs on, on `device` (the card unless
    `device="cpu"`): the latest committed checkpoint in `ckpt_dir` where
    `resume` and one exists (an empty or absent directory starts afresh),
    else a fresh one with the caches the job needs (the DeltaGrad
    trajectory where the constructor replays, the Increm-INFL provenance
    where the selector prunes)."""
    if resume and ckpt_dir is not None:
        from repro_torch.ckpt.checkpoint import latest_step

        if latest_step(ckpt_dir) is not None:
            return CleaningSession.restore(ckpt_dir, ds, cfg, backend=backend, device=device)
    return CleaningSession.initialize(ds, cfg, backend=backend,
                                      need_trajectory=(constructor == "deltagrad"),
                                      need_provenance=selector.startswith("increm"),
                                      device=device)


@dataclass
class JobInfo:
    """What `poll` returns: a job's progress, without touching its session."""

    job_id: str
    state: str
    rounds_done: int = 0
    n_cleaned: int = 0
    f1_val: Optional[float] = None
    error: Optional[str] = None


@dataclass
class _Job:
    job_id: str
    ds: object
    cfg: object
    opts: dict
    state: str = PENDING
    rounds_done: int = 0
    n_cleaned: int = 0
    f1_val: Optional[float] = None
    error: Optional[str] = None
    result: object = None
    cancel_event: threading.Event = field(default_factory=threading.Event)
    done_event: threading.Event = field(default_factory=threading.Event)


class CleaningService:
    """Submit / poll / cancel cleaning sessions over one shared `Backend` on
    one device. `workers` bounds how many sessions run at once (the rest
    queue); each worker drives its session one round at a time, so progress
    and cancellation have round granularity."""

    def __init__(self, backend: "Backend | str | None" = "cuda", *, workers: int = 1,
                 device=None):
        self.backend = get_backend(backend)
        self.device = resolve_device(device)
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._jobs: dict[str, _Job] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._workers = [threading.Thread(target=self._worker, name=f"cleaning-worker-{i}",
                                          daemon=True)
                         for i in range(max(workers, 1))]
        for t in self._workers:
            t.start()

    def submit(self, ds, cfg, *, method: str = "infl", selector: str = "full",
               constructor: str = "retrain", pipelined: bool = False, ckpt_dir=None,
               resume: bool = False, job_id: Optional[str] = None) -> str:
        """Queue one cleaning job; returns its id. With `resume=True` (which
        needs `ckpt_dir`) the worker restores the latest committed checkpoint
        in `ckpt_dir` instead of starting afresh: a job cancelled at a round
        boundary picks up where it stopped, bit for bit."""
        if resume and ckpt_dir is None:
            raise ValueError("resume=True requires a ckpt_dir")
        with self._lock:
            if job_id is None:
                job_id = f"job-{next(self._ids):04d}"
            if job_id in self._jobs:
                raise ValueError(f"duplicate job id {job_id!r}")
            job = _Job(job_id, ds, cfg, dict(method=method, selector=selector,
                                             constructor=constructor, pipelined=pipelined,
                                             ckpt_dir=ckpt_dir, resume=resume))
            self._jobs[job_id] = job
        self._queue.put(job)
        return job_id

    def poll(self, job_id: str) -> JobInfo:
        """The job's state and progress."""
        job = self._get(job_id)
        with self._lock:
            return JobInfo(job.job_id, job.state, job.rounds_done, job.n_cleaned, job.f1_val,
                           job.error)

    def result(self, job_id: str, timeout: Optional[float] = None):
        """Block until the job has finished, then return its `ChefResult`
        (raises for a failed or cancelled job)."""
        job = self._get(job_id)
        if not job.done_event.wait(timeout):
            raise TimeoutError(f"{job_id} still {job.state} after {timeout}s")
        if job.state == DONE:
            return job.result
        raise RuntimeError(f"{job_id} finished as {job.state}: {job.error}")

    def cancel(self, job_id: str) -> bool:
        """True if the job will give no result (it was pending, or stops at
        the next round boundary); False if it had already finished."""
        job = self._get(job_id)
        with self._lock:
            if job.state in (DONE, FAILED, CANCELLED):
                return False
            job.cancel_event.set()
            if job.state == PENDING:  # the worker sees the event and skips it
                job.state = CANCELLED
                job.done_event.set()
        return True

    def jobs(self) -> list:
        """Every job's `JobInfo`."""
        with self._lock:
            ids = list(self._jobs)
        return [self.poll(j) for j in ids]

    def join(self) -> None:
        """Wait until every submitted job has finished."""
        for job in list(self._jobs.values()):
            job.done_event.wait()

    def shutdown(self, wait: bool = True) -> None:
        """Stop the workers once the queue ahead of them is drained."""
        for _ in self._workers:
            self._queue.put(None)
        if wait:
            for t in self._workers:
                t.join()

    def _get(self, job_id: str) -> _Job:
        try:
            return self._jobs[job_id]
        except KeyError:
            raise KeyError(f"unknown job {job_id!r}") from None

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._run_job(job)
            except Exception as e:  # noqa: BLE001 — job isolation: the job fails, not the service
                with self._lock:
                    job.state = FAILED
                    job.error = f"{type(e).__name__}: {e}"
            finally:
                job.done_event.set()

    def _run_job(self, job: _Job) -> None:
        opts = job.opts
        with self._lock:
            # cancelled while pending: cancel() set the final state already
            if job.cancel_event.is_set():
                return
            job.state = RUNNING
        session = prepare_session(job.ds, job.cfg, backend=self.backend,
                                  selector=opts["selector"], constructor=opts["constructor"],
                                  ckpt_dir=opts["ckpt_dir"], resume=opts["resume"],
                                  device=self.device)
        sched: RoundScheduler = make_scheduler(session, method=opts["method"],
                                               selector=opts["selector"],
                                               constructor=opts["constructor"],
                                               pipelined=opts["pipelined"],
                                               ckpt_dir=opts["ckpt_dir"])
        while not sched.exhausted:
            if job.cancel_event.is_set():
                if sched.ckpt is not None:
                    # every committed round is on disk before the slot frees
                    sched.ckpt.wait()
                with self._lock:
                    job.state = CANCELLED
                return
            record = sched.step()
            with self._lock:
                job.rounds_done = session.round
                job.n_cleaned = record.n_cleaned_total
                job.f1_val = record.f1_val
        if sched.ckpt is not None:
            sched.ckpt.wait()
        result = sched.result()
        with self._lock:
            # a cancel() that returned True during the last round wins: it
            # promised that no result would come
            if job.cancel_event.is_set():
                job.state = CANCELLED
                return
            job.result = result
            job.state = DONE
