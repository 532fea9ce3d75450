"""The port's streaming CHEF (`repro_torch.stream`) on the CPU, against its own
batch loop and against `repro.stream`.

Sizes are tests/test_streaming.py's (3 windows of 40 rows, d 16). Both
packages stream the same rows: the port's `make_dataset` draws them once on
the CPU and `repro` is handed them as arrays. Where the port is held against
`repro`, the JAX package's draws are handed across by monkeypatch: the batch
schedule, the power-method start vectors (with the key each call is given),
the per-round keys, the vote's tie noise and the provenance extension's key
(`stream.session.provenance_generator`). Loop-level parity
means equal discrete outcomes: per round the same rows (or a priority tie
within 1e-5 of the b-th, after which the label states part), the same
voted labels and candidate counts, F1 within 1e-6. Within the port the
contracts are bit for bit: weight-0 padding rows move no trained weight, a
cold stream equals the batch session, and a resumed stream equals the
uninterrupted one. Float tolerances are stated where they are used.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cleaning.phases as j_phases
import repro.core.lr_head as j_lr_head
import repro.stream.ingest as j_ingest
import repro_torch.cleaning.phases as t_phases
import repro_torch.cleaning.session as t_session
import repro_torch.core.annotation as t_annotation
import repro_torch.core.lr_head as t_lr_head
import repro_torch.stream.ingest as t_ingest
import repro_torch.stream.session as t_stream_session
from repro.configs.chef_lr import ChefConfig as JChefConfig
from repro.data.synth import ChefDataset as JChefDataset
from repro.stream import StreamingCleaningSession as JStreamingCleaningSession
from repro.stream import SyntheticStream as JSyntheticStream
from repro.stream import generator_source as j_generator_source
from repro.stream import windowed as j_windowed
from repro_torch import convert
from repro_torch.cleaning import CleaningSession, make_scheduler, make_selector
from repro_torch.configs import ChefConfig
from repro_torch.core.increm import build_provenance, extend_provenance
from repro_torch.data.synth import ChefDataset, make_dataset
from repro_torch.launch import stream as t_launch
from repro_torch.stream import (StreamingCleaningSession, SyntheticStream, WindowStore,
                                generator_source, windowed)

TIE = 1e-5  # a row only one package picked lies this close to the b-th priority
P0_TOL = dict(rtol=1e-6, atol=1e-7)  # p0 of the extended rows against a full rebuild (f32)
PROV_TOL = dict(rtol=1e-5, atol=1e-6)  # the port's extended p0 / hnorm against repro's (f32)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """Release the JAX executables this module compiled when it is done (see
    tests/test_torch_serving.py)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def jsrc():
    """`repro`'s stream over one dataset of 3 windows of 40 rows, d 16. The
    port's `make_dataset` draws it on the CPU (seed 3) and `repro` is handed
    the arrays, so no JAX draw is compiled."""
    tds = make_dataset(torch.Generator().manual_seed(3), n_train=120, n_val=64, n_test=64,
                       feature_dim=16, device="cpu")
    jds = JChefDataset(**{
        f: getattr(tds, f) if f in ("name", "n_classes") else jnp.asarray(
            getattr(tds, f).numpy().astype(np.int32) if not getattr(tds, f).is_floating_point()
            and getattr(tds, f).dtype != torch.bool else getattr(tds, f).numpy())
        for f in ChefDataset.__dataclass_fields__})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ingest, "make_dataset", lambda key, **kw: jds)
        return JSyntheticStream(None, window_size=40, n_windows=3, n_val=64, n_test=64,
                                feature_dim=16)


def _to_port(jds) -> ChefDataset:
    return convert.dataset_from_numpy(**{
        f: getattr(jds, f) if f in ("name", "n_classes") else np.asarray(getattr(jds, f))
        for f in ChefDataset.__dataclass_fields__})


def _t_src(monkeypatch, jsrc) -> SyntheticStream:
    """The port's stream over `repro`'s one dataset draw."""
    jds = jsrc._ds
    monkeypatch.setattr(t_ingest, "make_dataset", lambda generator, **kw: _to_port(jds))
    return SyntheticStream(None, window_size=jsrc.window_size, n_windows=jsrc.n_windows,
                           feature_dim=int(jds.X.shape[1]), device="cpu")


def _cfgs(budget=30, strategy="two"):
    jcfg = JChefConfig(budget=budget, round_size=10, n_epochs=6, batch_size=120, lr=0.05,
                       l2=0.05, strategy=strategy)
    cfg = ChefConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                        if k not in ("backend", "score_chunk")}, backend="cuda")
    return jcfg, cfg


def _hand_port_the_jax_draws(monkeypatch):
    monkeypatch.setattr(t_lr_head, "batch_schedule", lambda seed, n, bs, epochs: torch.from_numpy(
        np.asarray(j_lr_head.batch_schedule(seed, n, bs, epochs), np.int64)))
    monkeypatch.setattr(t_lr_head, "power_init", lambda n, c, generator, device: torch.from_numpy(
        np.array(jax.random.normal(generator if generator is not None else jax.random.key(0),
                                   (n, c), jnp.float32))).to(device))
    monkeypatch.setattr(t_session, "round_generators", lambda seed, k: tuple(
        jax.random.split(jax.random.fold_in(jax.random.key(seed), k), 2)))
    monkeypatch.setattr(t_annotation, "tie_noise", lambda shape, key, device: torch.from_numpy(
        np.array(jax.random.uniform(key, tuple(shape)))).to(device))
    monkeypatch.setattr(t_stream_session, "provenance_generator",
                        lambda seed, k: jax.random.fold_in(jax.random.key(seed + 2), k))


def _record_rounds(monkeypatch, phases, log):
    """Append [selected rows, priorities, voted labels] of each round."""
    select, annotate = phases.InflSelector.select, phases.SimulatedAnnotator.annotate

    def recording_select(self, session, eligible, key):
        sel = select(self, session, eligible, key)
        log.append([np.asarray(sel.idx), np.asarray(sel.priority)])
        return sel

    def recording_annotate(self, session, selection, key):
        task = annotate(self, session, selection, key)
        log[-1].append(np.asarray(task.result()))
        return task

    monkeypatch.setattr(phases.InflSelector, "select", recording_select)
    monkeypatch.setattr(phases.SimulatedAnnotator, "annotate", recording_annotate)


def _near_bth(idx, prio, row) -> bool:
    pb = float(prio[idx[-1]])
    return abs(float(prio[row]) - pb) <= TIE * max(1.0, abs(pb))


def _same_discrete_outcomes(j_log, t_log, want, got, rounds):
    assert len(j_log) == len(t_log) == len(want.history) == len(got.history) == rounds
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
    np.testing.assert_array_equal(got.dataset.cleaned.numpy(), np.asarray(want.dataset.cleaned))


def _rows(win):
    return tuple(np.asarray(f) for f in win)


def test_padding_is_neutral_never_selected_and_never_aliased(jsrc, monkeypatch):
    """(1) The head trained over the capacity is bit for bit the same whatever
    finite garbage the weight-0 tail rows hold. (2) A warm stream with twice
    the capacity it needs never offers the selector a padding row, never
    selects one, and leaves the tail uncleaned at weight 0. (3) Each
    absorb's replay sees the labels and weights as they were before the
    append (padding: all zero) beside the appended ones: the store builds
    new tensors and never writes into the session's."""
    src = _t_src(monkeypatch, jsrc)
    _, cfg = _cfgs()
    store = WindowStore.create(src, device="cpu")
    store, _ = store.append(next(iter(src.windows())))
    assert store.n == 40 and store.capacity == 120
    poisoned = replace(store.ds, X=store.ds.X.index_fill(0, torch.arange(40, 120), 7.5),
                       y_prob=store.ds.y_prob.index_fill(0, torch.arange(40, 120), 0.3))
    w_clean, w_poison = (CleaningSession.initialize(ds, cfg, need_trajectory=False,
                                                    need_provenance=False, device="cpu").w
                         for ds in (store.ds, poisoned))
    assert torch.equal(w_clean, w_poison)

    absorbed = []
    absorb = t_stream_session.absorb_rows

    def recording_absorb(traj, sched, Xa, Y_old, Y_new, w_old, w_new, idx, *a, **kw):
        absorbed.append([t.clone() for t in (Y_old, Y_new, w_old, w_new, idx)])
        return absorb(traj, sched, Xa, Y_old, Y_new, w_old, w_new, idx, *a, **kw)

    monkeypatch.setattr(t_stream_session, "absorb_rows", recording_absorb)
    s = StreamingCleaningSession(src, cfg, capacity=2 * src.total_rows, device="cpu")
    seen = []
    inner_select = s._selector.select

    class Recording:
        def select(self, sess, eligible, generator):
            sel = inner_select(sess, eligible, generator)
            seen.append((int(sel.idx.max()), s.store.n, bool(eligible[s.store.n:].any())))
            return sel

    s._selector = Recording()  # before the first ingest
    res = s.run(rounds_per_window=1)
    assert len(seen) == 3 and all(top < n and not pad for top, n, pad in seen)
    assert not res.dataset.cleaned[120:].any() and float(res.dataset.y_weight[120:].max()) == 0.0
    assert len(absorbed) == 2
    wins = list(src.windows())
    for k, (Y_old, Y_new, w_old, w_new, idx) in enumerate(absorbed, start=1):
        assert torch.equal(idx, torch.arange(40 * k, 40 * (k + 1)))
        assert float(w_old[idx].abs().max()) == 0.0 and float(Y_old[idx].abs().max()) == 0.0
        assert torch.all(w_new[idx] == cfg.gamma) and torch.equal(Y_new[idx], wins[k].y_prob)
        rest = torch.ones(Y_old.shape[0], dtype=torch.bool)
        rest[idx] = False
        assert torch.equal(Y_old[rest], Y_new[rest]) and torch.equal(w_old[rest], w_new[rest])


def test_windowed_rechunks_as_jax_does(jsrc, monkeypatch):
    """`windowed` over 17-row chunks of the 120 rows: the first 40-row window
    pulls exactly 3 upstream chunks; the windows are, bit for bit, the
    stream's rows and `repro`'s windows; 50-row windows leave a short tail of
    20 that `drop_last` drops; a window size of 0 raises, as in `repro`."""
    src = _t_src(monkeypatch, jsrc)
    pulled = []

    def counted():
        for i, chunk in enumerate(generator_source(src, 17)):
            pulled.append(i)
            yield chunk

    wins = windowed(counted(), 40)
    first = next(wins)
    assert first.m == 40 and len(pulled) == 3
    got = [first] + list(wins)
    want = list(j_windowed(j_generator_source(jsrc, 17), 40))
    assert [w.m for w in got] == [w.m for w in want] == [40, 40, 40]
    for g, w in zip(got, want):
        for a, b in zip(_rows(g), _rows(w)):
            assert np.array_equal(a, b)
    cat = [torch.cat(fs) for fs in zip(*got)]
    ds = src.batch_dataset()
    for a, b in zip(cat, (ds.X, ds.y_prob, ds.y_true, ds.human_labels)):
        assert torch.equal(a, b)
    for drop_last, sizes in ((False, [50, 50, 20]), (True, [50, 50])):
        got = list(windowed(generator_source(src, 40), 50, drop_last=drop_last))
        want = list(j_windowed(j_generator_source(jsrc, 40), 50, drop_last=drop_last))
        assert [w.m for w in got] == [w.m for w in want] == sizes
        assert all(np.array_equal(a, b) for g, w in zip(got, want)
                   for a, b in zip(_rows(g), _rows(w)))
    with pytest.raises(ValueError):
        list(windowed(generator_source(src, 40), 0))
    with pytest.raises(ValueError):
        list(j_windowed(j_generator_source(jsrc, 40), 0))


def test_warm_and_cold_streams_match_jax(jsrc, monkeypatch):
    """The warm stream (a round a window) and the cold stream (every window
    ingested before the first round) give `repro`'s discrete outcomes, under
    strategy 'three'. The warm stream's provenance, extended at each absorb,
    has `repro`'s p0 and hnorm (f32: rtol 1e-5, atol 1e-6). One item runs
    both of `repro`'s streams, so one worker compiles what they share."""
    src = _t_src(monkeypatch, jsrc)
    jcfg, cfg = _cfgs(strategy="three")
    _hand_port_the_jax_draws(monkeypatch)
    sessions = []

    def online(stream):
        stream.ingest()
        sessions.append(stream.session)
        stream.clean(1)
        while stream.ingest():
            assert stream.session is sessions[-1]  # absorbed, not rebuilt
            stream.clean(1)
        stream.clean(None)
        return stream.result()

    def drain(stream):
        while stream.ingest():
            pass
        stream.clean(None)
        return stream.result()

    j_log, t_log = [], []
    _record_rounds(monkeypatch, j_phases, j_log)
    _record_rounds(monkeypatch, t_phases, t_log)
    for warm, loop in ((True, online), (False, drain)):
        want = loop(JStreamingCleaningSession(jsrc, jcfg, warm_start=warm))
        got = loop(StreamingCleaningSession(src, cfg, warm_start=warm, device="cpu"))
        _same_discrete_outcomes(j_log, t_log, want, got, rounds=3)
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-4, atol=1e-5)
        j_log.clear()
        t_log.clear()
    j_prov, prov = sessions[0].prov, sessions[1].prov
    np.testing.assert_allclose(prov.p0.numpy(), np.asarray(j_prov.p0), **PROV_TOL)
    np.testing.assert_allclose(prov.hnorm.numpy(), np.asarray(j_prov.hnorm), **PROV_TOL)


def test_cold_stream_equals_batch_and_warm_extends_provenance(jsrc, monkeypatch):
    """Within the port. Cold: ingest every window, then clean to the budget
    on the retrain oracle (warm_start=False); that is bit for bit the batch
    session on the concatenated rows (labels, weights, head, per-round F1).
    Warm: it needs DeltaGrad-L; its provenance, extended at each absorb,
    keeps the w0 anchor and the first window's p0 rows, and its p0 equals a
    full rebuild's (f32: rtol 1e-6, atol 1e-7); an extension repeats its
    hnorm given the generator; and Increm-INFL's top-b over it equals Full
    INFL's."""
    src = _t_src(monkeypatch, jsrc)
    _, cfg = _cfgs()
    cold = StreamingCleaningSession(src, cfg, warm_start=False, device="cpu")
    while cold.ingest():
        pass
    cold.clean(None)
    got = cold.result()
    batch = make_scheduler(CleaningSession.initialize(src.batch_dataset(), cfg,
                                                      device="cpu")).run()
    assert len(got.history) == len(batch.history) == 3
    assert torch.equal(got.dataset.y_prob, batch.dataset.y_prob)
    assert torch.equal(got.dataset.y_weight, batch.dataset.y_weight)
    assert torch.equal(got.w, batch.w)
    assert [r.f1_val for r in got.history] == [r.f1_val for r in batch.history]

    with pytest.raises(ValueError, match="deltagrad"):
        StreamingCleaningSession(src, cfg, constructor="retrain", device="cpu")
    warm = StreamingCleaningSession(src, cfg, device="cpu")
    warm.ingest()
    inner = warm.session
    anchor = [inner.prov.w0, inner.prov.p0[:40].clone()]
    warm.clean(1)
    while warm.ingest():
        assert warm.session is inner  # absorbed, not rebuilt
        warm.clean(1)
    prov = inner.prov
    assert prov.w0 is anchor[0] and torch.equal(prov.p0[:40], anchor[1])
    full = build_provenance(prov.w0, inner.Xa, power_iters=cfg.power_iters,
                            backend=inner.backend)
    np.testing.assert_allclose(prov.p0.numpy(), full.p0.numpy(), **P0_TOL)
    idx = torch.arange(40, 80)
    twice = [extend_provenance(full, inner.Xa[idx], at=idx, backend=inner.backend,
                               generator=t_stream_session.provenance_generator(cfg.seed, 1))
             for _ in range(2)]
    assert torch.equal(twice[0].hnorm, twice[1].hnorm)
    g_sel, _ = inner.round_keys(inner.round)
    eligible = inner.eligible()
    sel_inc = make_selector("infl", "increm").select(inner, eligible, g_sel)
    sel_full = make_selector("infl", "full").select(inner, eligible, g_sel)
    assert set(sel_inc.idx.tolist()) == set(sel_full.idx.tolist())
    assert sel_inc.n_candidates <= int(eligible.sum())


def test_cli_resumes_a_killed_stream_bit_for_bit(tmp_path, monkeypatch):
    """`repro_torch.launch.stream` with `--ckpt_dir`, killed in its third
    round after the third window was absorbed and checkpointed, then run
    again with `--resume`: it restores at 3 windows and ends bit for bit
    where an uninterrupted run ends (labels, weights, head, per-round F1)."""
    results, restored = [], []
    run, restore, clean = (StreamingCleaningSession.run, StreamingCleaningSession.restore.__func__,
                           StreamingCleaningSession.clean)

    def recording_run(self, rounds_per_window=1):
        results.append(run(self, rounds_per_window))
        return results[-1]

    def recording_restore(cls, *a, **kw):
        obj = restore(cls, *a, **kw)
        restored.append((obj.windows_ingested, len(obj.session.history)))
        return obj

    class Killed(Exception):
        pass

    calls = []

    def dying_clean(self, max_rounds=None):
        calls.append(max_rounds)
        if len(calls) == 3 and self.ckpt is not None:
            self.ckpt.wait()
            raise Killed
        return clean(self, max_rounds)

    monkeypatch.setattr(StreamingCleaningSession, "run", recording_run)
    monkeypatch.setattr(StreamingCleaningSession, "restore", classmethod(recording_restore))
    monkeypatch.setattr(StreamingCleaningSession, "clean", dying_clean)
    argv = ["--windows", "3", "--window_size", "40", "--feature_dim", "16", "--budget", "30",
            "--backend", "cuda", "--device", "cpu"]
    summary = t_launch.main(argv)
    assert summary["windows"] == 3 and summary["rounds"] == 3
    d = str(tmp_path / "ck")
    calls.clear()
    with pytest.raises(Killed):
        t_launch.main(argv + ["--ckpt_dir", d])
    calls.clear()
    resumed = t_launch.main(argv + ["--ckpt_dir", d, "--resume"])
    assert restored == [(3, 2)]
    ref, res = results[0], results[-1]
    assert resumed["rounds"] == 3 and resumed["f1_test"] == summary["f1_test"]
    assert torch.equal(res.dataset.y_prob, ref.dataset.y_prob)
    assert torch.equal(res.dataset.y_weight, ref.dataset.y_weight)
    assert torch.equal(res.w, ref.w)
    assert [r.f1_val for r in res.history] == [r.f1_val for r in ref.history]
