"""The port's cleaning loop against the JAX package's, on the CPU.

`repro_torch.core.run_chef` and `repro.core.run_chef` run on the same
`repro`-built dataset, with constructor "retrain" and with the default,
DeltaGrad-L. The port's four random draws (batch
schedule, power-method start, per-round generators, vote tie-break noise)
are monkeypatched to return `repro`'s, so the two loops see the same
randomness. Per round they must select the same rows, give them the same
cleaned labels, keep the same Increm-INFL candidate count and reach the same
F1. Where a selection differs, the rows only one package picked must lie
within 1e-5 (relative, floor 1) of that round's b-th priority — a tie that
float32 rounding may break either way — and the comparison stops there,
since the label states part.
"""
import dataclasses
import inspect

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
from repro.configs.chef_lr import ChefConfig as JChefConfig
from repro.core import run_chef as j_run_chef
from repro.data import make_dataset as j_make_dataset
from repro_torch import convert
from repro_torch.cleaning import (BudgetLedger, CleaningSession, MarginalF1PerLabel, Patience,
                                  TargetF1, make_constructor, make_scheduler, make_selector)
from repro_torch.configs import ChefConfig
from repro_torch.core import run_chef
from repro_torch.data.synth import ChefDataset

TIE = 1e-5
CLASS_SEP = {2: 0.3, 3: 0.5}  # weak labels ~79% / ~66% right: cleaning has work to do


@pytest.fixture(scope="module")
def datasets():
    return {C: j_make_dataset(jax.random.key(7 + C), n_train=401, n_val=61, n_test=83,
                              feature_dim=16, n_classes=C, class_sep=CLASS_SEP[C])
            for C in (2, 3)}


def _to_port(jds) -> ChefDataset:
    return convert.dataset_from_numpy(**{
        f: getattr(jds, f) if f in ("name", "n_classes") else np.asarray(getattr(jds, f))
        for f in ChefDataset.__dataclass_fields__})


def _hand_port_the_jax_draws(monkeypatch):
    monkeypatch.setattr(t_lr_head, "batch_schedule", lambda seed, n, bs, epochs: torch.from_numpy(
        np.asarray(j_lr_head.batch_schedule(seed, n, bs, epochs), np.int64)))
    monkeypatch.setattr(t_lr_head, "power_init", lambda n, c, generator, device: torch.from_numpy(
        np.array(jax.random.normal(jax.random.key(0), (n, c), jnp.float32))).to(device))
    monkeypatch.setattr(t_session, "round_generators", lambda seed, k: tuple(
        jax.random.split(jax.random.fold_in(jax.random.key(seed), k), 2)))
    monkeypatch.setattr(t_annotation, "tie_noise", lambda shape, key, device: torch.from_numpy(
        np.array(jax.random.uniform(key, tuple(shape)))).to(device))


def _record_rounds(monkeypatch, phases, log):
    """Append (selected rows, priorities, voted labels) of each round."""
    annotate = phases.SimulatedAnnotator.annotate

    def recording(select):
        def recording_select(self, session, eligible, key):
            sel = select(self, session, eligible, key)
            log.append([np.asarray(sel.idx), np.asarray(sel.priority)])
            return sel
        return recording_select

    def recording_annotate(self, session, selection, key):
        task = annotate(self, session, selection, key)
        log[-1].append(np.asarray(task.result()))
        return task

    for cls in (phases.InflSelector, phases.BaselineSelector):
        monkeypatch.setattr(cls, "select", recording(cls.select))
    monkeypatch.setattr(phases.SimulatedAnnotator, "annotate", recording_annotate)


def _near_bth(idx, prio, row) -> bool:
    pb = float(prio[idx[-1]])
    return abs(float(prio[row]) - pb) <= TIE * max(1.0, abs(pb))


@pytest.mark.parametrize("selector,C,strategy", [("full", 2, "three"), ("increm", 2, "three"),
                                                 ("increm_tight", 2, "three"),
                                                 ("increm", 3, "one")])
def test_run_chef_matches_jax(selector, C, strategy, datasets, monkeypatch):
    jds = datasets[C]
    jcfg = JChefConfig(n_classes=C, feature_dim=16, budget=30, round_size=10, n_epochs=3,
                       batch_size=100, lr=0.1, l2=0.02, strategy=strategy)
    cfg = ChefConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                        if k not in ("backend", "score_chunk")}, backend="cuda")
    _hand_port_the_jax_draws(monkeypatch)
    j_log, t_log = [], []
    _record_rounds(monkeypatch, j_phases, j_log)
    _record_rounds(monkeypatch, t_phases, t_log)
    want = j_run_chef(jds, jcfg, method="infl", selector=selector, constructor="retrain")
    got = run_chef(_to_port(jds), cfg, method="infl", selector=selector, constructor="retrain",
                   device="cpu")
    assert len(j_log) == len(t_log) == len(want.history) == len(got.history) == 3
    for k, ((j_idx, j_prio, j_lab), (t_idx, t_prio, t_lab)) in enumerate(zip(j_log, t_log)):
        if set(j_idx.tolist()) != set(t_idx.tolist()):
            only = set(j_idx.tolist()) ^ set(t_idx.tolist())
            assert all(_near_bth(j_idx, j_prio, i) or _near_bth(t_idx, t_prio, i) for i in only), (
                f"round {k}: selections differ beyond a priority tie")
            return  # the two loops' label states part here
        assert dict(zip(j_idx.tolist(), j_lab.tolist())) == dict(zip(t_idx.tolist(),
                                                                     t_lab.tolist()))
        jr, tr = want.history[k], got.history[k]
        assert tr.n_candidates == jr.n_candidates
        assert tr.n_cleaned_total == jr.n_cleaned_total == 10 * (k + 1)
        assert tr.f1_val == pytest.approx(jr.f1_val, abs=1e-6)
        assert tr.f1_test == pytest.approx(jr.f1_test, abs=1e-6)
    assert np.array_equal(got.dataset.cleaned.numpy(), np.asarray(want.dataset.cleaned))
    np.testing.assert_array_equal(got.dataset.y_prob.numpy(), np.asarray(want.dataset.y_prob))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-4, atol=1e-5)


def _cfgs(C, strategy, n_epochs=3):
    jcfg = JChefConfig(n_classes=C, feature_dim=16, budget=30, round_size=10, n_epochs=n_epochs,
                       batch_size=100, lr=0.1, l2=0.02, strategy=strategy)
    cfg = ChefConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                        if k not in ("backend", "score_chunk")}, backend="cuda")
    return jcfg, cfg


@pytest.mark.parametrize("method,selector,C,strategy", [("infl", "increm", 2, "three"),
                                                        ("infl", "full", 3, "one"),
                                                        ("infl_y", "full", 2, "three")])
def test_run_chef_deltagrad_matches_jax(method, selector, C, strategy, datasets, monkeypatch):
    """The default constructor, DeltaGrad-L, in both packages' loops: per
    round the same rows (or a priority tie, as above), the same labels, the
    same candidate count and F1; then the same label state, and weights
    within rtol 1e-4, atol 1e-5 (three replays of float32 steps)."""
    jds = datasets[C]
    jcfg, cfg = _cfgs(C, strategy)
    _hand_port_the_jax_draws(monkeypatch)
    j_log, t_log = [], []
    _record_rounds(monkeypatch, j_phases, j_log)
    _record_rounds(monkeypatch, t_phases, t_log)
    want = j_run_chef(jds, jcfg, method=method, selector=selector)
    got = run_chef(_to_port(jds), cfg, method=method, selector=selector, device="cpu")
    assert len(j_log) == len(t_log) == len(want.history) == len(got.history) == 3
    for k, ((j_idx, j_prio, j_lab), (t_idx, t_prio, t_lab)) in enumerate(zip(j_log, t_log)):
        if set(j_idx.tolist()) != set(t_idx.tolist()):
            only = set(j_idx.tolist()) ^ set(t_idx.tolist())
            assert all(_near_bth(j_idx, j_prio, i) or _near_bth(t_idx, t_prio, i) for i in only), (
                f"round {k}: selections differ beyond a priority tie")
            return  # the two loops' label states part here
        assert dict(zip(j_idx.tolist(), j_lab.tolist())) == dict(zip(t_idx.tolist(),
                                                                     t_lab.tolist()))
        jr, tr = want.history[k], got.history[k]
        assert tr.n_candidates == jr.n_candidates
        assert tr.n_cleaned_total == jr.n_cleaned_total == 10 * (k + 1)
        assert tr.f1_val == pytest.approx(jr.f1_val, abs=1e-6)
        assert tr.f1_test == pytest.approx(jr.f1_test, abs=1e-6)
    np.testing.assert_array_equal(got.dataset.y_prob.numpy(), np.asarray(want.dataset.y_prob))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-4, atol=1e-5)


def test_kill_and_restore_repeat_the_run_bit_for_bit(datasets, tmp_path):
    """A DeltaGrad session checkpointed after round 1, restored into a fresh
    session and run on: the same rows, labels, weights, trajectory, F1 and
    candidate counts as the uninterrupted run, bit for bit (the port's
    counterpart of tests/test_cleaning.py::test_kill_restore_bitwise_parity)."""
    ds = _to_port(datasets[2])
    _, cfg = _cfgs(2, "three")
    full = make_scheduler(CleaningSession.initialize(ds, cfg, device="cpu"),
                          selector="increm_tight")
    res_full = full.run()
    killed = make_scheduler(CleaningSession.initialize(ds, cfg, device="cpu"),
                            selector="increm_tight", ckpt_dir=tmp_path)
    killed.run(max_rounds=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001"]
    session = CleaningSession.restore(tmp_path, ds, cfg, device="cpu")
    assert session.round == 1 and session.ledger.spent == 10 and len(session.history) == 1
    for name, leaf in killed.session.state_tree().items():
        assert np.array_equal(np.asarray(session.state_tree()[name]), np.asarray(leaf)), name
    res = make_scheduler(session, selector="increm_tight").run()
    assert torch.equal(res.dataset.cleaned, res_full.dataset.cleaned)
    assert torch.equal(res.dataset.y_prob, res_full.dataset.y_prob)
    assert torch.equal(res.w, res_full.w)
    assert all(map(torch.equal, session.traj, full.session.traj))
    assert [r.f1_val for r in res.history] == [r.f1_val for r in res_full.history]
    assert [r.n_candidates for r in res.history] == [r.n_candidates for r in res_full.history]


def test_early_termination_and_ledger():
    """A reachable target F1 stops the loop after one round; the ledger
    charges what was cleaned and refuses to overspend."""
    ds = convert.dataset_from_numpy(
        name="t", X=np.random.default_rng(0).standard_normal((120, 4)),
        y_prob=np.full((120, 2), 0.5), y_weight=np.full(120, 0.8), cleaned=np.zeros(120, bool),
        y_true=np.arange(120) % 2, human_labels=np.stack([np.arange(120) % 2] * 3, 1),
        X_val=np.zeros((10, 4)), y_val=np.eye(2)[np.arange(10) % 2], X_test=np.zeros((10, 4)),
        y_test=np.arange(10) % 2, n_classes=2)
    cfg = ChefConfig(budget=40, round_size=10, n_epochs=1, batch_size=60, target_f1=0.01)
    res = run_chef(ds, cfg, selector="full", device="cpu")
    assert res.terminated_early and len(res.history) == 1
    assert int(res.dataset.cleaned.sum()) == 10
    ledger = BudgetLedger(15)
    ledger.charge(10)
    assert ledger.remaining == 5 and not ledger.can_afford(10)
    with pytest.raises(ValueError, match="budget"):
        ledger.charge(6)


def test_termination_policies():
    """TargetF1, Patience and MarginalF1PerLabel on scripted histories."""
    from repro_torch.core.pipeline import RoundRecord

    def hist(*f1s):
        return [RoundRecord(k, 10 * (k + 1), f, f, 0, 0.0, 0.0, 0.0) for k, f in enumerate(f1s)]

    assert TargetF1(0.8).should_stop(hist(0.5, 0.81)) and not TargetF1(0.8).should_stop(hist(0.5))
    assert Patience(2).should_stop(hist(0.7, 0.6, 0.7))
    assert not Patience(2).should_stop(hist(0.6, 0.6, 0.7))
    assert MarginalF1PerLabel(0.01).should_stop(hist(0.70, 0.75))
    assert not MarginalF1PerLabel(0.001).should_stop(hist(0.70, 0.75))


def test_factories_raise_on_what_is_not_ported():
    """The factories build what is ported, pipelined speculation among it,
    and refuse what they do not know with a clear error."""
    assert make_selector("infl", "increm_tight").mode == "increm_tight"
    assert type(make_selector("random", "full")).__name__ == "BaselineSelector"
    assert type(make_constructor("retrain")).__name__ == "RetrainConstructor"
    assert type(make_constructor("deltagrad")).__name__ == "DeltaGradConstructor"
    with pytest.raises(ValueError, match="unknown constructor"):
        make_constructor("finetune")
    sched = make_scheduler(type("S", (), {"cfg": ChefConfig()})(), pipelined=True)
    assert sched.pipelined and (sched.spec_hits, sched.spec_misses) == (0, 0)
    with pytest.raises(ValueError, match="Increm-INFL"):
        run_chef(None, ChefConfig(), method="loss", selector="increm", device="cpu")


def test_entry_point_defaults_match_jax():
    """run_chef, CleaningSession.initialize and make_scheduler default to
    what the JAX package's do (DeltaGrad-L among them), apart from the
    port's `device`."""
    pairs = [(run_chef, j_run_chef),
             (CleaningSession.initialize, j_cleaning.CleaningSession.initialize),
             (make_scheduler, j_cleaning.make_scheduler)]
    for port_fn, jax_fn in pairs:
        got, want = ({name: p.default for name, p in inspect.signature(fn).parameters.items()
                      if name != "device"} for fn in (port_fn, jax_fn))
        assert got == want, port_fn.__qualname__


def test_port_restores_a_session_the_jax_package_checkpointed(datasets, tmp_path):
    """A `repro` session saved by `repro.ckpt` after a round comes back in
    the port with every leaf equal: w, schedule, trajectory,
    provenance, label state, counters, ledger and history; the key slot
    (JAX key data) becomes the seed it was made from."""
    from repro.ckpt import CheckpointManager
    from repro.core.pipeline import RoundRecord

    jds = datasets[2]
    jcfg, cfg = _cfgs(2, "three")
    j_session = j_cleaning.CleaningSession.initialize(jds, jcfg)
    idx = jnp.arange(0, 40, 4)  # one round's worth of cleaned labels, committed as a round
    j_session.apply_round(jds.clean(idx, jds.y_true[idx]), j_session.w, j_session.traj,
                          j_session.sched, RoundRecord(0, 10, 0.5, 0.25, 401, 0.1, 0.2, 0.75))
    manager = CheckpointManager(tmp_path)
    j_session.save(manager)
    manager.wait()
    session = CleaningSession.restore(tmp_path, _to_port(jds), cfg, device="cpu")
    want, got = j_session.state_tree(), session.state_tree()
    assert set(got) == set(want) == set(CleaningSession.state_template())
    for name in sorted(set(want) - {"key"}):
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), err_msg=name)
    assert session.key == jcfg.seed + 1 and int(got["key"]) == session.key
    assert session.round == 1 and session.ledger.spent == 10
    assert session.traj[0].dtype == torch.float32 and session.sched.dtype == torch.int64
