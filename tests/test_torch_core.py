"""The port's core modules against the JAX package's, on the CPU.

`lr_head`, `cg`, `influence`, `increm`, `annotation` and `metrics` of
`repro_torch` are held against their `repro` counterparts on the same numpy
inputs (float32; each tolerance is stated where it is used). Where the JAX
function draws random numbers, the port is handed the same draws by
monkeypatching the port's one drawing function.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annotation as j_annotation
from repro.core import cg as j_cg
from repro.core import increm as j_increm
from repro.core import influence as j_influence
from repro.core import lr_head as j_lr_head
from repro.core import metrics as j_metrics
from repro_torch import convert
from repro_torch.core import annotation, cg, increm, influence, lr_head, metrics
from repro_torch.core.backend import Backend

RTOL, ATOL = 1e-5, 1e-6
SRC = Path(__file__).resolve().parents[1] / "src"


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _problem(N=203, D=13, C=3, seed=0):
    """A small weighted LR problem as numpy float32 arrays."""
    r = np.random.default_rng(seed)
    Xa = r.standard_normal((N, D)).astype(np.float32)
    Xa[:, -1] = 1.0
    return dict(
        Xa=Xa, Y=_softmax(2 * r.standard_normal((N, C))).astype(np.float32),
        gw=r.uniform(0.5, 1.0, N).astype(np.float32),
        w=(0.3 * r.standard_normal((C, D))).astype(np.float32),
        v=(0.3 * r.standard_normal((C, D))).astype(np.float32),
        Xv=np.concatenate([r.standard_normal((31, D - 1)), np.ones((31, 1))], 1).astype(np.float32),
        Yv=np.eye(C, dtype=np.float32)[r.integers(0, C, 31)],
    )


def _t(a):
    return {k: torch.from_numpy(x) for k, x in a.items()}


def _j(a):
    return {k: jnp.asarray(x) for k, x in a.items()}


# ------------------------------------------------------------------ lr_head


def test_head_closed_forms_match_jax():
    """augment, probs, loss, per_sample_loss, grad and hvp == repro's."""
    a = _problem()
    t, j = _t(a), _j(a)
    pairs = [
        (lr_head.augment(t["Xa"]), j_lr_head.augment(j["Xa"])),
        (lr_head.probs(t["w"], t["Xa"]), j_lr_head.probs(j["w"], j["Xa"])),
        (lr_head.loss(t["w"], t["Xa"], t["Y"], t["gw"], 0.05),
         j_lr_head.loss(j["w"], j["Xa"], j["Y"], j["gw"], 0.05)),
        (lr_head.per_sample_loss(t["w"], t["Xa"], t["Y"]),
         j_lr_head.per_sample_loss(j["w"], j["Xa"], j["Y"])),
        (lr_head.grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.05, backend=Backend("cuda")),
         j_lr_head.grad(j["w"], j["Xa"], j["Y"], j["gw"], 0.05)),
        (lr_head.hvp(t["w"], t["v"], t["Xa"], t["gw"], 0.05),
         j_lr_head.hvp(j["w"], j["v"], j["Xa"], j["gw"], 0.05)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(lr_head.init_head(None, 3, 12), torch.zeros(3, 13))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_sgd_train_matches_jax_on_its_schedule(momentum, backend):
    """sgd_train on repro's batch schedule: final weights and the cached
    trajectory agree with repro's (rtol 1e-4, atol 1e-6: 12 steps of float32
    sums taken in another order)."""
    a = _problem()
    t, j = _t(a), _j(a)
    sched = j_lr_head.batch_schedule(5, 203, 50, 3)
    w_j, (ws_j, gs_j) = j_lr_head.sgd_train(jnp.zeros((3, 13)), j["Xa"], j["Y"], j["gw"], sched,
                                            l2=0.02, lr=0.1, momentum=momentum)
    w_t, (ws_t, gs_t) = lr_head.sgd_train(
        torch.zeros(3, 13), t["Xa"], t["Y"], t["gw"], convert.schedule_from_numpy(sched),
        l2=0.02, lr=0.1, momentum=momentum, backend=Backend(backend))
    assert ws_t.shape == (12, 3, 13)
    for got, want in ((w_t, w_j), (ws_t, ws_j), (gs_t, gs_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    w_n, traj = lr_head.sgd_train(torch.zeros(3, 13), t["Xa"], t["Y"], t["gw"],
                                  convert.schedule_from_numpy(sched), l2=0.02, lr=0.1,
                                  momentum=momentum, cache_trajectory=False)
    assert traj is None and torch.equal(w_n, w_t)


def test_sgd_train_rejects_a_schedule_outside_the_rows():
    """A schedule row id outside [0, N) raises before any step runs."""
    a = _t(_problem())
    with pytest.raises(ValueError, match="outside"):
        lr_head.sgd_train(torch.zeros(3, 13), a["Xa"], a["Y"], a["gw"],
                          torch.tensor([[0, 203]]), l2=0.0, lr=0.1)


def test_batch_schedule_is_a_seeded_permutation_per_epoch():
    """[E * (n // bs), bs] rows; each epoch's rows are distinct; the seed
    fixes the schedule."""
    s = lr_head.batch_schedule(3, 101, 25, 4)
    assert s.shape == (16, 25) and s.dtype == torch.int64
    for e in range(4):
        rows = s[4 * e: 4 * e + 4].reshape(-1)
        assert rows.unique().numel() == 100 and int(rows.max()) < 101
    assert torch.equal(s, lr_head.batch_schedule(3, 101, 25, 4))
    assert not torch.equal(s, lr_head.batch_schedule(4, 101, 25, 4))


def test_hessian_norm_matches_jax_on_its_draw(monkeypatch):
    """per_sample_hessian_norm (power method) and build_provenance == repro's
    when the port is handed repro's start vectors."""
    a = _problem()
    t, j = _t(a), _j(a)
    monkeypatch.setattr(lr_head, "power_init", lambda n, c, generator, device: torch.from_numpy(
        np.array(jax.random.normal(jax.random.key(0), (n, c), jnp.float32))))
    got = increm.build_provenance(t["w"], t["Xa"], power_iters=12, backend=Backend("cuda"))
    want = j_increm.build_provenance(j["w"], j["Xa"], power_iters=12)
    for g, w in ((got.p0, want.p0), (got.hnorm, want.hnorm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert bool((got.hnorm > 0).all())


# ------------------------------------------------------------ cg, influence


@pytest.mark.parametrize("iters,tol", [(64, 1e-6), (4, 1e-6)])
def test_cg_matches_jax(iters, tol):
    """CG solution within 1e-4 relative of repro's, with equal iteration
    counts (converged and capped)."""
    a = _problem()
    t, j = _t(a), _j(a)
    b_t = lr_head.grad(t["w"], t["Xv"], t["Yv"], torch.ones(31), 0.0)
    b_j = j_lr_head.grad(j["w"], j["Xv"], j["Yv"], jnp.ones(31), 0.0)
    x_t, st_t = cg.cg_solve(lambda v: lr_head.hvp(t["w"], v, t["Xa"], t["gw"], 0.05), b_t,
                            iters=iters, tol=tol)
    x_j, st_j = j_cg.cg_solve(lambda v: j_lr_head.hvp(j["w"], v, j["Xa"], j["gw"], 0.05), b_j,
                              iters=iters, tol=tol)
    assert st_t["iters"] == int(st_j["iters"])
    assert 0 < st_t["iters"] <= iters
    x_j = np.asarray(x_j)
    assert np.linalg.norm(x_t.numpy() - x_j) <= 1e-4 * np.linalg.norm(x_j)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_influence_and_infl_match_jax(backend):
    """influence_vector and infl (priority, suggested, scores) == repro's."""
    a = _problem()
    t, j = _t(a), _j(a)
    v_t, st = influence.influence_vector(t["w"], t["Xv"], t["Yv"], t["Xa"], t["gw"], 0.05,
                                         backend=Backend(backend))
    v_j, st_j = j_influence.influence_vector(j["w"], j["Xv"], j["Yv"], j["Xa"], j["gw"], 0.05)
    assert st["iters"] == int(st_j["iters"])
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-4, atol=1e-6)
    got = influence.infl(t["w"], t["v"], t["Xa"], t["Y"], 0.8, backend=Backend(backend))
    want = j_influence.infl(j["w"], j["v"], j["Xa"], j["Y"], 0.8)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.priority.numpy(), np.asarray(want.priority), rtol=RTOL,
                               atol=ATOL)
    assert np.array_equal(got.suggested.numpy(), np.asarray(want.suggested))


def test_top_b_takes_lowest_index_first_among_ties():
    """top_b orders equal priorities lowest index first, as lax.top_k does,
    and never picks an ineligible row."""
    prio = np.array([3.0, 1.0, 1.0, 2.0, 1.0, 0.0, 1.0, 1.0, -1.0], np.float32)
    elig = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0], bool)
    for b in (1, 3, 4, 6):
        got = influence.top_b(torch.from_numpy(prio), torch.from_numpy(elig), b).numpy()
        want = np.asarray(j_influence.top_b(jnp.asarray(prio), jnp.asarray(elig), b))
        assert got.tolist() == want.tolist()
    got = influence.top_b(torch.from_numpy(prio), torch.from_numpy(elig), 4)
    assert got.tolist() == [5, 1, 2, 4]


# ------------------------------------------------------------------- increm


def _bounds_inputs(C=3, seed=1):
    a = _problem(C=C, seed=seed)
    r = np.random.default_rng(seed + 10)
    a["w_k"] = (a["w"] + 0.05 * r.standard_normal(a["w"].shape)).astype(np.float32)
    a["p0"] = _softmax(a["Xa"] @ a["w"].T).astype(np.float32)
    a["hnorm"] = r.uniform(0.0, 0.5, a["Xa"].shape[0]).astype(np.float32)
    a["elig"] = r.uniform(size=a["Xa"].shape[0]) > 0.2
    return a


@pytest.mark.parametrize("tight", [False, True])
def test_theorem1_bounds_and_algorithm1_match_jax(tight):
    """theorem1_bounds allclose to repro's in both modes; algorithm1 on the
    same bounds keeps exactly repro's candidates."""
    a = _bounds_inputs()
    t, j = _t(a), _j(a)
    prov_t = convert.provenance_from_numpy(a["w"], a["p0"], a["hnorm"])
    prov_j = j_increm.Provenance(j["w"], j["p0"], j["hnorm"])
    bt = increm.theorem1_bounds(prov_t, t["w_k"], t["v"], t["Xa"], t["Y"], 0.8, tight=tight,
                                backend=Backend("cuda"))
    bj = j_increm.theorem1_bounds(prov_j, j["w_k"], j["v"], j["Xa"], j["Y"], 0.8, tight=tight)
    for got, want in ((bt.center, bj.center), (bt.lower, bj.lower), (bt.upper, bj.upper)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # Algorithm 1 on one set of bounds, handed to both
    same = increm.Bounds(*(torch.from_numpy(np.array(x)) for x in bj))
    for b in (1, 10, 40):
        pt = increm.algorithm1(same, t["elig"], b)
        pj = j_increm.algorithm1(bj, j["elig"], b)
        assert np.array_equal(pt.candidates.numpy(), np.asarray(pj.candidates))
        assert pt.n_candidates == int(pj.n_candidates)
        assert float(pt.L) == float(pj.L)


def test_algorithm1_ties_match_jax():
    """Equal centres: the top-b and the argmin class both take the lowest
    index first, as repro's do."""
    C, N = 3, 40
    r = np.random.default_rng(4)
    center = np.round(r.standard_normal((N, C)), 0).astype(np.float32)  # many ties
    width = r.uniform(0.0, 0.5, (N, C)).astype(np.float32)
    elig = r.uniform(size=N) > 0.1
    bj = j_increm.Bounds(jnp.asarray(center), jnp.asarray(center - width),
                         jnp.asarray(center + width[:, ::-1]))
    bt = increm.Bounds(*(torch.from_numpy(np.array(x)) for x in bj))
    for b in (1, 5, 12):
        pt = increm.algorithm1(bt, torch.from_numpy(elig), b)
        pj = j_increm.algorithm1(bj, jnp.asarray(elig), b)
        assert np.array_equal(pt.candidates.numpy(), np.asarray(pj.candidates))
        assert float(pt.L) == float(pj.L)


@pytest.mark.parametrize("tight", [False, True])
def test_increm_infl_selects_what_full_infl_selects(tight):
    """Increm-INFL's pruned top-b equals Full INFL's top-b (Theorem 1)."""
    a = _bounds_inputs(seed=2)
    t = _t(a)
    prov = increm.Provenance(t["w"], t["p0"],
                             lr_head.per_sample_hessian_norm(t["w"], t["Xa"], P=t["p0"]))
    pr, sug, pruned = increm.increm_infl(prov, t["w_k"], t["v"], t["Xa"], t["Y"], 0.8, t["elig"],
                                         10, tight=tight)
    full = influence.infl(t["w_k"], t["v"], t["Xa"], t["Y"], 0.8)
    assert (sorted(influence.top_b(pr, t["elig"], 10).tolist())
            == sorted(influence.top_b(full.priority, t["elig"], 10).tolist()))
    assert 10 <= pruned.n_candidates <= int(t["elig"].sum())


# ------------------------------------------------------ annotation, metrics


def test_majority_vote_and_strategies_match_jax(monkeypatch):
    """Without noise ties go to the smallest class; with repro's noise the
    port's vote and every strategy equal repro's."""
    r = np.random.default_rng(5)
    humans = r.integers(0, 3, (64, 3))
    infl_lbl = r.integers(0, 3, 64)
    tied = torch.tensor([[0, 1], [2, 1], [1, 1]])
    assert annotation.majority_vote(tied, 3).tolist() == [0, 1, 1]
    key = jax.random.key(9)
    monkeypatch.setattr(annotation, "tie_noise", lambda shape, generator, device: torch.from_numpy(
        np.array(jax.random.uniform(generator, tuple(shape)))))
    for strategy in ("one", "two", "three"):
        got = annotation.cleaned_labels(strategy, torch.from_numpy(humans),
                                        torch.from_numpy(infl_lbl), 3, generator=key)
        want = j_annotation.cleaned_labels(strategy, jnp.asarray(humans, jnp.int32),
                                           jnp.asarray(infl_lbl, jnp.int32), 3, key=key)
        assert got.tolist() == np.asarray(want).tolist()


def test_simulated_annotators_flip_at_the_error_rate():
    """5% of labels flip, each to another class."""
    y = torch.randint(0, 3, (4000,), generator=torch.Generator().manual_seed(0))
    lab = annotation.simulate_annotators(torch.Generator().manual_seed(1), y, 3, 3, 0.05)
    assert lab.shape == (4000, 3) and lab.dtype == torch.int64
    assert 0.04 < float((lab != y[:, None]).float().mean()) < 0.06
    assert int(lab.max()) < 3 and int(lab.min()) >= 0


@pytest.mark.parametrize("C", [2, 3])
def test_metrics_match_jax(C):
    """f1 (binary or macro) and accuracy == repro's."""
    r = np.random.default_rng(C)
    pred, true = r.integers(0, C, 97), r.integers(0, C, 97)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(true)
    jp, jt = jnp.asarray(pred), jnp.asarray(true)
    assert float(metrics.f1(tp, tt, C)) == pytest.approx(float(j_metrics.f1(jp, jt, C)), abs=1e-7)
    assert float(metrics.accuracy(tp, tt)) == pytest.approx(float(j_metrics.accuracy(jp, jt)),
                                                            abs=1e-7)
    assert float(metrics.f1_macro(tp, tt, C)) == pytest.approx(
        float(j_metrics.f1_macro(jp, jt, C)), abs=1e-7)


# ------------------------------------------------------- data, the package


def test_make_dataset_shapes_and_labels():
    """The port's own generator: shapes, dtypes, weak labels better than a
    coin and worse than the truth, annotators near 5% error; clean() leaves
    the original dataset as it was."""
    from repro_torch.data import make_dataset, make_paper_dataset

    ds = make_dataset(torch.Generator().manual_seed(0), n_train=800, n_val=50, n_test=60,
                      feature_dim=20, n_classes=3, device="cpu")
    assert ds.X.shape == (800, 20) and ds.y_prob.shape == (800, 3) and ds.n == 800
    assert ds.y_val.shape == (50, 3) and ds.y_test.shape == (60,)
    assert ds.human_labels.shape == (800, 3) and ds.y_true.dtype == torch.int64
    assert torch.allclose(ds.y_prob.sum(-1), torch.ones(800), atol=1e-5)
    acc = float((ds.y_prob.argmax(-1) == ds.y_true).float().mean())
    assert 0.4 < acc < 1.0
    idx = torch.tensor([0, 5])
    cleaned = ds.clean(idx, torch.tensor([2, 1]))
    assert cleaned.y_prob[0].tolist() == [0.0, 0.0, 1.0] and bool(cleaned.cleaned[5])
    assert float(cleaned.y_weight[0]) == 1.0 and not bool(ds.cleaned.any())
    tw = make_paper_dataset("twitter", scale=0.01, device="cpu")
    assert tw.X.shape == (512, 768) and tw.X_val.shape == (64, 768)


def test_dataset_from_numpy_carries_every_field():
    """convert.dataset_from_numpy keeps every field of a repro dataset."""
    from repro.data import make_dataset as j_make_dataset
    from repro_torch.data.synth import ChefDataset

    jds = j_make_dataset(jax.random.key(1), n_train=64, n_val=16, n_test=16, feature_dim=8)
    names = [f for f in ChefDataset.__dataclass_fields__]
    ds = convert.dataset_from_numpy(**{f: getattr(jds, f) if f in ("name", "n_classes")
                                       else np.asarray(getattr(jds, f)) for f in names})
    for f in names:
        got, want = getattr(ds, f), getattr(jds, f)
        if isinstance(got, torch.Tensor):
            assert np.array_equal(got.numpy(), np.asarray(want)), f
        else:
            assert got == want
    assert ds.X.dtype == torch.float32 and ds.human_labels.dtype == torch.int64
    assert convert.head_from_numpy(np.zeros((2, 9))).dtype == torch.float32


def test_entry_points_raise_without_a_card():
    """With no device given, the entry points run on the card; where there is
    none they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.cleaning import CleaningSession
    from repro_torch.configs import ChefConfig
    from repro_torch.core import run_chef, train_head
    from repro_torch.data import make_dataset, make_paper_dataset

    ds = make_dataset(n_train=64, n_val=16, n_test=16, feature_dim=4, device="cpu")
    cfg = ChefConfig(budget=10, round_size=10, n_epochs=1, batch_size=32)
    for call in (lambda: run_chef(ds, cfg), lambda: train_head(ds, cfg),
                 lambda: CleaningSession.initialize(ds, cfg), lambda: make_dataset(),
                 lambda: make_paper_dataset("twitter", scale=0.01)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of repro_torch loads neither JAX nor anything
    of repro; importing it turns TF32 off."""
    code = (
        "import pkgutil, sys, importlib, torch, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "assert len(mods) >= 20, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
