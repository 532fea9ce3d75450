"""The port's pipelined cleaning loop, `ModelAnnotator` and `CleaningService`,
on the CPU, against the port's blocking loop and against the JAX package.

Datasets are built with `repro` and carried across with `convert`; where the
two packages' loops are compared, the port's random draws are monkeypatched
to return `repro`'s (as in tests/test_torch_pipeline.py). The pipelined
loop must give the blocking loop's rows, labels and weights bit for bit,
whether its speculation hits (strategy 'two') or may miss ('three'), and
the same speculation counts as `repro`'s. `ModelAnnotator` at
`reduced(olmo-1b)` on `repro`'s weights must give `repro`'s labels, with
logits within 1e-4 x (1 + |ref|). The service must give what the scheduler
gives when called directly, a cancelled job must resume bit for bit, and a
failing job must fail alone.
"""
import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cleaning as j_cleaning
import repro.cleaning.phases as j_phases
import repro.core.lr_head as j_lr_head
import repro_torch.cleaning.phases as t_phases
import repro_torch.cleaning.session as t_session
import repro_torch.core.annotation as t_annotation
import repro_torch.core.lr_head as t_lr_head
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.chef_lr import ChefConfig as JChefConfig
from repro.core.backend import get_backend as j_get_backend
from repro.data import make_dataset as j_make_dataset
from repro.models import Model as JModel
from repro.serving import engine as j_engine
from repro.stream import ModelAnnotator as JModelAnnotator
from repro_torch import convert
from repro_torch.cleaning import (CleaningService, CleaningSession, RoundScheduler,
                                  make_constructor, make_scheduler, make_selector,
                                  prepare_session)
from repro_torch.configs import ChefConfig, get_config, reduced
from repro_torch.data.synth import ChefDataset
from repro_torch.models import Model
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.stream import ModelAnnotator

CFG = ChefConfig(budget=30, round_size=10, n_epochs=6, batch_size=100, lr=0.05, l2=0.05)
TIE = 1e-5  # a row only one package picked lies this close to the b-th priority
LOGIT_TOL = 1e-4  # ModelAnnotator logits: |port - repro| <= LOGIT_TOL * (1 + |repro|)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """Release the JAX executables this module compiled when it is done (see
    tests/test_torch_serving.py)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def jds():
    return j_make_dataset(jax.random.key(7), n_train=300, n_val=64, n_test=64, feature_dim=24)


def _to_port(jds) -> ChefDataset:
    return convert.dataset_from_numpy(**{
        f: getattr(jds, f) if f in ("name", "n_classes") else np.asarray(getattr(jds, f))
        for f in ChefDataset.__dataclass_fields__})


def _jax_cfg(cfg: ChefConfig) -> JChefConfig:
    return JChefConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k != "backend"})


def _hand_port_the_jax_draws(monkeypatch):
    monkeypatch.setattr(t_lr_head, "batch_schedule", lambda seed, n, bs, epochs: torch.from_numpy(
        np.asarray(j_lr_head.batch_schedule(seed, n, bs, epochs), np.int64)))
    monkeypatch.setattr(t_lr_head, "power_init", lambda n, c, generator, device: torch.from_numpy(
        np.array(jax.random.normal(jax.random.key(0), (n, c), jnp.float32))).to(device))
    monkeypatch.setattr(t_session, "round_generators", lambda seed, k: tuple(
        jax.random.split(jax.random.fold_in(jax.random.key(seed), k), 2)))
    monkeypatch.setattr(t_annotation, "tie_noise", lambda shape, key, device: torch.from_numpy(
        np.array(jax.random.uniform(key, tuple(shape)))).to(device))


def _run(ds, cfg, *, pipelined=False, selector="increm_tight", constructor="deltagrad"):
    session = CleaningSession.initialize(ds, cfg, need_trajectory=(constructor == "deltagrad"),
                                         need_provenance=selector.startswith("increm"),
                                         device="cpu")
    sched = make_scheduler(session, selector=selector, constructor=constructor,
                           pipelined=pipelined)
    return sched.run(), sched


@pytest.mark.parametrize("strategy,latency", [("two", 0.15), ("three", 0.1)])
def test_pipelined_matches_blocking_bit_for_bit(strategy, latency, jds):
    """Strategy 'two': the votes are INFL's suggestions, every speculation
    hits. 'three': human votes may override them, so speculation may miss.
    Either way the pipelined run's cleaned rows, labels and weights equal
    the blocking run's bit for bit. Round k's generators are made afresh on
    every call, so the prefetch's draws leave round k+1's untouched."""
    ds = _to_port(jds)
    cfg = dataclasses.replace(CFG, strategy=strategy, annotator_latency_s=latency)
    res_b, _ = _run(ds, cfg)
    res_p, sched = _run(ds, cfg, pipelined=True)
    if strategy == "two":
        assert sched.spec_hits >= 2 and sched.spec_misses == 0
    else:
        assert sched.spec_hits + sched.spec_misses >= 2
    assert torch.equal(res_b.dataset.cleaned, res_p.dataset.cleaned)
    assert torch.equal(res_b.dataset.y_prob.argmax(-1), res_p.dataset.y_prob.argmax(-1))
    assert torch.equal(res_b.w, res_p.w)
    assert [r.f1_val for r in res_b.history] == [r.f1_val for r in res_p.history]
    used, _ = sched.session.round_keys(1)
    torch.rand(4, generator=used)  # a prefetch's draws...
    again, _ = sched.session.round_keys(1)  # ...leave the round's own untouched
    fresh, _ = t_session.round_generators(sched.session.key, 1)
    assert again is not used
    assert torch.equal(torch.rand(4, generator=again), torch.rand(4, generator=fresh))


@pytest.mark.parametrize("strategy", ["one", "two", "three"])
def test_annotator_predicts_what_is_known_before_the_vote(strategy, jds):
    """`SimulatedAnnotator.predict` gives the selector's suggested labels of
    the selected rows as int64, which are the vote under strategy 'two'; it
    gives None where the selector suggests none, and the vote then falls to
    the humans alone (strategy 'one')."""
    ds = _to_port(jds)
    session = SimpleNamespace(ds=ds)
    idx = torch.arange(3, 13)
    suggested = ((ds.y_true + 1) % ds.n_classes).to(torch.int32)
    sel = t_phases.RoundSelection(idx, torch.zeros(ds.n), suggested, ds.n)
    annotator = t_phases.SimulatedAnnotator(strategy)
    pred = annotator.predict(session, sel)
    assert pred.dtype == torch.int64 and torch.equal(pred, suggested[idx].to(torch.int64))
    votes = annotator.annotate(session, sel, torch.Generator().manual_seed(0)).result()
    assert torch.equal(votes, pred) == (strategy == "two")
    blind = sel._replace(suggested=None)
    assert annotator.predict(session, blind) is None
    humans = annotator.annotate(session, blind, torch.Generator().manual_seed(1)).result()
    assert torch.equal(humans, t_annotation.cleaned_labels(
        "one", ds.human_labels[idx], torch.zeros_like(idx), ds.n_classes,
        generator=torch.Generator().manual_seed(1)))


def test_pipelined_without_a_prediction_never_speculates(jds):
    """A selector that suggests no labels (the loss baseline) leaves the
    pipelined loop nothing to speculate on: no hit, no miss, and the
    blocking loop's result bit for bit."""
    ds = _to_port(jds)
    cfg = dataclasses.replace(CFG, budget=20, annotator_latency_s=0.05)
    runs = []
    for pipelined in (False, True):
        session = CleaningSession.initialize(ds, cfg, need_trajectory=False,
                                             need_provenance=False, device="cpu")
        sched = make_scheduler(session, method="loss", selector="full", constructor="retrain",
                               pipelined=pipelined)
        runs.append((sched.run(), sched))
    (res_b, _), (res_p, sched) = runs
    assert (sched.spec_hits, sched.spec_misses) == (0, 0) and len(res_p.history) == 2
    assert _same(res_b, res_p)


def _record(monkeypatch, phases, log, ready_seen):
    """Append (selected rows, priorities, voted labels) of each round as its
    annotator is asked, and every answer of AnnotationTask.ready()."""
    annotate, ready = phases.SimulatedAnnotator.annotate, phases.AnnotationTask.ready

    def recording_annotate(self, session, selection, key):
        task = annotate(self, session, selection, key)
        log.append((np.asarray(selection.idx), np.asarray(selection.priority),
                    np.asarray(task._labels)))
        return task

    def recording_ready(self):
        ready_seen.append(ready(self))
        return ready_seen[-1]

    monkeypatch.setattr(phases.SimulatedAnnotator, "annotate", recording_annotate)
    monkeypatch.setattr(phases.AnnotationTask, "ready", recording_ready)


def test_pipelined_matches_jax_pipelined(jds, monkeypatch):
    """The port's pipelined DeltaGrad-L run against `repro`'s on the same
    draws and the same latency, at strategy 'three': each round the same
    rows (or a priority tie, after which the label states part) and labels,
    equal F1 and equal speculation hits and misses. The latency outlasts
    every ready() check (asserted), so both speculate every round they can."""
    cfg = dataclasses.replace(CFG, budget=20, strategy="three", annotator_latency_s=0.3)
    _hand_port_the_jax_draws(monkeypatch)
    j_log, t_log, j_ready, t_ready = [], [], [], []
    _record(monkeypatch, j_phases, j_log, j_ready)
    _record(monkeypatch, t_phases, t_log, t_ready)
    j_session = j_cleaning.CleaningSession.initialize(jds, _jax_cfg(cfg), need_provenance=False)
    j_sched = j_cleaning.make_scheduler(j_session, selector="full", pipelined=True)
    want = j_sched.run()
    session = CleaningSession.initialize(_to_port(jds), cfg, need_provenance=False, device="cpu")
    t_sched = make_scheduler(session, selector="full", pipelined=True)
    got = t_sched.run()
    assert len(j_log) == len(t_log) == 2 and not any(j_ready) and not any(t_ready)
    assert len(j_ready) == len(t_ready) == 2
    for k, ((j_idx, j_prio, j_lab), (t_idx, t_prio, t_lab)) in enumerate(zip(j_log, t_log)):
        if set(j_idx.tolist()) != set(t_idx.tolist()):
            pb = [float(p[i[-1]]) for p, i in ((j_prio, j_idx), (t_prio, t_idx))]
            only = set(j_idx.tolist()) ^ set(t_idx.tolist())
            assert all(any(abs(float(p[i]) - b) <= TIE * max(1.0, abs(b))
                           for p, b in zip((j_prio, t_prio), pb)) for i in only), (
                f"round {k}: selections differ beyond a priority tie")
            return  # the two loops' label states part here
        assert dict(zip(j_idx.tolist(), j_lab.tolist())) == dict(zip(t_idx.tolist(),
                                                                     t_lab.tolist()))
        assert got.history[k].f1_val == pytest.approx(want.history[k].f1_val, abs=1e-6)
    assert (t_sched.spec_hits, t_sched.spec_misses) == (j_sched.spec_hits, j_sched.spec_misses)
    assert t_sched.spec_hits + t_sched.spec_misses == 2
    np.testing.assert_array_equal(got.dataset.y_prob.numpy(), np.asarray(want.dataset.y_prob))


def test_model_annotator_matches_jax(jds, monkeypatch):
    """`ModelAnnotator` at reduced(olmo-1b) on `repro`'s weights, through a
    blocking RoundScheduler (INFL, full selection, retrain) on both packages:
    per round the same rows and labels, the labelled rows' logits within
    LOGIT_TOL x (1 + |ref|); one prefill a row and no decode round. Its
    construction checks raise as `repro`'s do."""
    _hand_port_the_jax_draws(monkeypatch)
    jm = JModel(j_reduced(j_get_config("olmo-1b")))
    jp = jm.init(jax.random.key(0))
    mcfg = reduced(get_config("olmo-1b"))
    m = Model(mcfg, device="cpu")
    p = convert.model_params_from_numpy(mcfg, jax.tree.map(np.asarray, jp), "cpu")
    j_eng = j_engine.ServeEngine(jm, jp, backend=j_get_backend("reference"),
                                 config=j_engine.ServeConfig(batch_size=4, max_len=64,
                                                             trace_logits=True))
    eng = ServeEngine(m, p, backend="reference", device="cpu",
                      config=ServeConfig(batch_size=4, max_len=64, trace_logits=True))
    runs = {}
    cfg = dataclasses.replace(CFG, budget=20)
    for name, eng_, annotator_cls, pkg, ds, c in (
            ("jax", j_eng, JModelAnnotator, j_cleaning, jds, _jax_cfg(cfg)),
            ("port", eng, ModelAnnotator, None, _to_port(jds), cfg)):
        served = []
        run = eng_.run

        def recording_run(reqs, run=run, served=served):
            done = run(reqs)
            served.append(sorted(((r.uid, np.asarray(r.logits[0])) for r in done),
                                 key=lambda x: x[0]))
            return done

        eng_.run = recording_run
        annotator = annotator_cls(eng_)
        labels = []
        if pkg is not None:
            session = pkg.CleaningSession.initialize(ds, c, need_trajectory=False,
                                                     need_provenance=False)
            sched = pkg.RoundScheduler(session, j_phases.make_selector("infl", "full"),
                                       annotator, j_phases.make_constructor("retrain"))
        else:
            session = CleaningSession.initialize(ds, c, need_trajectory=False,
                                                 need_provenance=False, device="cpu")
            sched = RoundScheduler(session, make_selector("infl", "full"), annotator,
                                   make_constructor("retrain"))
        annotate = annotator.annotate

        def recording_annotate(s, selection, key, annotate=annotate, labels=labels):
            task = annotate(s, selection, key)
            labels.append(dict(zip(np.asarray(selection.idx).tolist(),
                                   np.asarray(task._labels).tolist())))
            return task

        annotator.annotate = recording_annotate
        res = sched.run()
        runs[name] = (labels, served, res, dict(eng_.stats))
    (j_labels, j_served, j_res, j_stats), (t_labels, t_served, t_res, t_stats) = (
        runs["jax"], runs["port"])
    assert len(t_labels) == len(j_labels) == 2 and t_labels == j_labels
    for j_round, t_round in zip(j_served, t_served):
        assert [u for u, _ in t_round] == [u for u, _ in j_round] and len(t_round) == 10
        for (_, a), (_, b) in zip(t_round, j_round):
            assert np.abs(a - b).max() <= LOGIT_TOL * (1 + np.abs(b)).min()
    assert [r.f1_val for r in t_res.history] == pytest.approx(
        [r.f1_val for r in j_res.history], abs=1e-6)
    assert t_stats["decode_rounds"] == j_stats["decode_rounds"] == 0
    assert t_stats["prefix_hits"] == j_stats["prefix_hits"] > 0
    for make_engine, cls in ((lambda **kw: ServeEngine(m, p, device="cpu", config=ServeConfig(
            **kw)), ModelAnnotator), (lambda **kw: j_engine.ServeEngine(
                jm, jp, config=j_engine.ServeConfig(**kw)), JModelAnnotator)):
        with pytest.raises(ValueError, match="trace_logits"):
            cls(make_engine(trace_logits=False))
        with pytest.raises(ValueError, match="too small"):
            cls(make_engine(trace_logits=True), n_bins=mcfg.vocab_size)
    assert ModelAnnotator(eng).predict(None, None) is None


def _same(a, b) -> bool:
    """Two ChefResults equal bit for bit: rows, labels, weights, F1."""
    return (torch.equal(a.dataset.cleaned, b.dataset.cleaned)
            and torch.equal(a.dataset.y_prob, b.dataset.y_prob) and torch.equal(a.w, b.w)
            and [r.f1_val for r in a.history] == [r.f1_val for r in b.history])


@pytest.mark.parametrize("case", ["two_workers", "cancel_and_resume"])
def test_cleaning_service(case, jds, tmp_path, monkeypatch):
    """two_workers: two jobs (full selection with retrain, Increm-INFL with
    DeltaGrad-L) on two workers each equal the scheduler run directly, bit
    for bit; poll and jobs() report them done; an unknown job raises
    KeyError and resume without a ckpt_dir ValueError.
    cancel_and_resume: on one worker a job cancelled while pending ends
    cancelled; a DeltaGrad-L job cancelled after its first committed round
    (its worker held at that round's end until the cancel is in), then
    resubmitted with resume=True on its ckpt_dir, finishes bit for bit like
    the uninterrupted run."""
    ds = _to_port(jds)
    svc = CleaningService(workers=2 if case == "two_workers" else 1, device="cpu")
    try:
        if case == "two_workers":
            cfg = dataclasses.replace(CFG, budget=20)
            jobs = {svc.submit(ds, cfg, selector=sel, constructor=con): (sel, con)
                    for sel, con in (("full", "retrain"), ("increm_tight", "deltagrad"))}
            for job, (sel, con) in jobs.items():
                direct, _ = _run(ds, cfg, selector=sel, constructor=con)
                assert _same(svc.result(job, timeout=600), direct)
                info = svc.poll(job)
                assert (info.state, info.rounds_done, info.n_cleaned) == ("done", 2, 20)
            assert {i.job_id: i.state for i in svc.jobs()} == dict.fromkeys(jobs, "done")
            with pytest.raises(KeyError, match="unknown job"):
                svc.poll("job-9999")
            with pytest.raises(ValueError, match="ckpt_dir"):
                svc.submit(ds, CFG, resume=True)
            return
        cfg = dataclasses.replace(CFG, budget=20)
        oracle, _ = _run(ds, cfg)
        step, held, release = RoundScheduler.step, threading.Event(), threading.Event()

        def holding_step(self):
            record = step(self)
            if self.ckpt is not None and self.session.round == 1 and not held.is_set():
                held.set()  # the first round is committed; the worker waits for the cancel
                release.wait(60)
            return record

        monkeypatch.setattr(RoundScheduler, "step", holding_step)
        j1 = svc.submit(ds, cfg, selector="increm_tight", constructor="deltagrad",
                        ckpt_dir=tmp_path)
        pending = svc.submit(ds, cfg)
        assert svc.cancel(pending) is True and svc.poll(pending).state == "cancelled"
        assert held.wait(60)
        assert svc.cancel(j1) is True
        release.set()
        with pytest.raises(RuntimeError, match="cancelled"):
            svc.result(j1, timeout=600)
        assert (svc.poll(j1).state, svc.poll(j1).rounds_done) == ("cancelled", 1)
        assert svc.cancel(j1) is False  # already finished
        j2 = svc.submit(ds, cfg, selector="increm_tight", constructor="deltagrad",
                        ckpt_dir=tmp_path, resume=True)
        assert _same(svc.result(j2, timeout=600), oracle)
        assert svc.poll(j2).rounds_done == 2
    finally:
        svc.shutdown()


def test_service_isolates_a_failing_job(jds):
    """A job that raises (an unknown selector) ends failed with its error:
    `result` raises for it and `cancel` returns False. The job queued behind
    it on the same worker gives the scheduler's result, and a duplicate job
    id is refused."""
    ds = _to_port(jds)
    cfg = dataclasses.replace(CFG, budget=10)
    svc = CleaningService(workers=1, device="cpu")
    try:
        bad = svc.submit(ds, cfg, selector="nope")
        good = svc.submit(ds, cfg, job_id="good")
        with pytest.raises(ValueError, match="duplicate job id"):
            svc.submit(ds, cfg, job_id="good")
        with pytest.raises(RuntimeError, match="failed: ValueError: unknown selector"):
            svc.result(bad, timeout=600)
        assert svc.poll(bad).state == "failed" and svc.cancel(bad) is False
        direct, _ = _run(ds, cfg, selector="full", constructor="retrain")
        assert _same(svc.result(good, timeout=600), direct)
        svc.join()
        assert [(i.job_id, i.state) for i in svc.jobs()] == [(bad, "failed"), ("good", "done")]
    finally:
        svc.shutdown()


def test_prepare_session_starts_afresh_without_a_checkpoint(jds, tmp_path):
    """With resume=True and an empty or absent ckpt_dir, `prepare_session`
    gives the fresh session, with the DeltaGrad trajectory and the
    Increm-INFL provenance only where the job's phases need them."""
    ds = _to_port(jds)
    cfg = dataclasses.replace(CFG, budget=10)
    fresh = CleaningSession.initialize(ds, cfg, device="cpu")
    (tmp_path / "empty").mkdir()
    for ckpt_dir, selector, constructor in ((tmp_path / "empty", "increm", "deltagrad"),
                                            (tmp_path / "absent", "full", "retrain")):
        s = prepare_session(ds, cfg, backend=fresh.backend, selector=selector,
                            constructor=constructor, ckpt_dir=ckpt_dir, resume=True,
                            device="cpu")
        assert s.round == 0 and s.ledger.spent == 0 and torch.equal(s.w, fresh.w)
        assert (s.traj is not None) == (constructor == "deltagrad")
        assert (s.prov is not None) == selector.startswith("increm")
    assert not (tmp_path / "absent").exists()
