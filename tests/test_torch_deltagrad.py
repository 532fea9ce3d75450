"""The port's DeltaGrad-L against the JAX package's, on the CPU.

`repro_torch.core.deltagrad` is held against `repro.core.deltagrad` on the
same numpy inputs (the counterparts of tests/test_deltagrad.py): the
correction schedule must be equal exactly (it fixes the correction's
summation order), the L-BFGS product and the replay within the tolerance
stated at each test. The replay's correction op itself is held against
`repro`'s in tests/test_torch_kernels.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deltagrad as j_dg
from repro.core import lr_head as j_lr_head
from repro_torch import convert
from repro_torch.configs import ChefConfig
from repro_torch.core import deltagrad, lr_head, metrics, train_head
from repro_torch.core.backend import Backend

N, FEAT, BS, EPOCHS = 200, 11, 20, 3  # T = 3 * (200 // 20) = 30 replay steps


@pytest.fixture(scope="module")
def problem():
    """A small weighted LR problem made with numpy, trained by repro's
    sgd_train on repro's batch schedule, and 7 rows cleaned to one-hot
    labels: the same replay inputs for both packages."""
    r = np.random.default_rng(11)
    Xa = np.concatenate([r.standard_normal((N, FEAT)), np.ones((N, 1))], 1).astype(np.float32)
    y_prob = r.dirichlet([2.0, 2.0], N).astype(np.float32)
    y_weight = np.full(N, 0.8, np.float32)
    idx = np.array([3, 17, 40, 41, 99, 150, 199])
    y_new, w_new = y_prob.copy(), y_weight.copy()
    y_new[idx] = np.eye(2, dtype=np.float32)[r.integers(0, 2, idx.size)]
    w_new[idx] = 1.0
    sched = np.asarray(j_lr_head.batch_schedule(4, N, BS, EPOCHS))
    _, (ws, gs) = j_lr_head.sgd_train(jnp.zeros((2, FEAT + 1)), jnp.asarray(Xa),
                                      jnp.asarray(y_prob), jnp.asarray(y_weight),
                                      jnp.asarray(sched), l2=0.05, lr=0.05)
    return dict(Xa=Xa, y_prob=y_prob, y_new=y_new, y_weight=y_weight, w_new=w_new, idx=idx,
                sched=sched, ws=np.asarray(ws), gs=np.asarray(gs))


# --------------------------------------------------------- correction schedule


@pytest.mark.parametrize("n_changed", [0, 1, 13])
def test_correction_schedule_equals_jax_and_the_loop_oracle(n_changed):
    """Same ids, same hit order within each row, same padding and dtypes as
    repro's vectorized function and as the port's own double-loop oracle."""
    r = np.random.default_rng(n_changed)
    sched = r.integers(0, 90, (57, 13))
    changed = r.choice(90, n_changed, replace=False)
    ci, cm = deltagrad.build_correction_schedule(sched, changed)
    for want_ci, want_cm in (j_dg.build_correction_schedule(sched, changed),
                             deltagrad._build_correction_schedule_loop(sched, changed)):
        want_ci, want_cm = np.asarray(want_ci), np.asarray(want_cm)
        assert ci.dtype == want_ci.dtype and cm.dtype == want_cm.dtype
        np.testing.assert_array_equal(ci, want_ci)
        np.testing.assert_array_equal(cm, want_cm)
    hits = [set(ci[t][cm[t] > 0].tolist()) for t in range(57)]
    assert hits == [set(row.tolist()) & set(changed.tolist()) for row in sched]


# ------------------------------------------------------------------ L-BFGS


@pytest.mark.parametrize("n_pairs", [0, 1, 4])
def test_lbfgs_Bv_matches_jax_and_meets_the_secant_equation(n_pairs):
    """B v == repro's (float32 4 x 4 pairs, an 8 x 8 solve: rtol 1e-4,
    atol 1e-5); with all pairs exact on a quadratic, B reproduces the
    newest pair (B s = y, 5e-3 as in tests/test_deltagrad.py) and is
    positive along random directions; with none, B = I."""
    r = np.random.default_rng(n_pairs)
    P, m0 = 6, 4
    M = r.standard_normal((P, P))
    A = (M @ M.T / P + np.eye(P)).astype(np.float32)
    S = r.standard_normal((m0, P)).astype(np.float32)
    Y = (S @ A.T).astype(np.float32)
    vs = r.standard_normal((3, P)).astype(np.float32)
    npairs = torch.tensor(n_pairs)
    j_lbfgs_Bv = jax.jit(j_dg.lbfgs_Bv)  # one compile instead of one per primitive
    for v in (S[-1], *vs):
        got = deltagrad.lbfgs_Bv(torch.from_numpy(S), torch.from_numpy(Y), npairs,
                                 torch.from_numpy(v))
        want = j_lbfgs_Bv(jnp.asarray(S), jnp.asarray(Y), jnp.asarray(n_pairs), jnp.asarray(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        if n_pairs == 0:
            assert torch.equal(got, torch.from_numpy(v))
        else:
            assert float(torch.from_numpy(v) @ got) > 0
    if n_pairs == m0:
        got = deltagrad.lbfgs_Bv(torch.from_numpy(S), torch.from_numpy(Y), npairs,
                                 torch.from_numpy(S[-1]))
        np.testing.assert_allclose(got.numpy(), Y[-1], rtol=5e-3, atol=5e-3)


# ------------------------------------------------------------------ replay


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_replay_matches_jax_on_its_trajectory(problem, backend):
    """deltagrad_replay from repro's cached trajectory: the final weights and
    both replayed trajectory arrays agree with repro's (30 float32 steps,
    20 of them through the L-BFGS solve: rtol 1e-4, atol 1e-5)."""
    p = problem
    dgc = deltagrad.DGConfig(burn_in=10, period=10, history=2, lr=0.05, l2=0.05)
    ci, cm = j_dg.build_correction_schedule(p["sched"], p["idx"])
    j = {k: jnp.asarray(p[k]) for k in ("Xa", "y_prob", "y_new", "y_weight", "w_new")}
    w_j, (ws_j, gs_j) = j_dg.deltagrad_replay(
        jnp.asarray(p["ws"]), jnp.asarray(p["gs"]), jnp.asarray(p["sched"]), j["Xa"],
        j["y_prob"], j["y_new"], j["y_weight"], j["w_new"], ci, cm,
        j_dg.DGConfig(**dataclasses.asdict(dgc)), BS)

    t = {k: torch.from_numpy(p[k]) for k in ("Xa", "y_prob", "y_new", "y_weight", "w_new")}
    w_t, (ws_t, gs_t) = deltagrad.deltagrad_replay(
        *convert.trajectory_from_numpy(p["ws"], p["gs"]), convert.schedule_from_numpy(p["sched"]),
        t["Xa"], t["y_prob"], t["y_new"], t["y_weight"], t["w_new"],
        *deltagrad.build_correction_schedule(p["sched"], p["idx"]), dgc, BS,
        backend=Backend(backend))
    assert ws_t.shape == gs_t.shape == (EPOCHS * N // BS, 2, FEAT + 1)
    for got, want in ((w_t, w_j), (ws_t, ws_j), (gs_t, gs_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_replay_close_to_retrain_and_a_noop_when_nothing_changed():
    """On the port alone: cleaning 7 labels, the replay lands within 5% of
    the retrained weights and predicts the test split within 0.02 F1 (paper
    Exp3, as tests/test_deltagrad.py); with nothing changed it reproduces
    the cached trajectory bit for bit; `absorb_rows` is the replay over the
    schedule of the rows it absorbs."""
    from repro_torch.data import make_dataset

    ds = make_dataset(torch.Generator().manual_seed(5), n_train=N, n_val=40, n_test=60,
                      feature_dim=FEAT, device="cpu")
    cfg = ChefConfig(n_epochs=EPOCHS, batch_size=BS, lr=0.05, l2=0.05)
    dgc = deltagrad.DGConfig(cfg.dg_burn_in, cfg.dg_period, cfg.dg_history, cfg.lr, cfg.l2)
    _, traj, sched = train_head(ds, cfg, cache=True, device="cpu")
    Xa = lr_head.augment(ds.X)

    T = sched.shape[0]
    zeros_i, zeros_f = np.zeros((T, 1), np.int32), np.zeros((T, 1), np.float32)
    w_same, (ws_same, gs_same) = deltagrad.deltagrad_replay(
        traj[0], traj[1], sched, Xa, ds.y_prob, ds.y_prob, ds.y_weight, ds.y_weight, zeros_i,
        zeros_f, dgc, BS)
    w_rt, _, _ = train_head(ds, cfg, cache=False, device="cpu")
    assert torch.equal(ws_same, traj[0]) and torch.equal(gs_same, traj[1])
    assert torch.equal(w_same, w_rt)

    idx = torch.arange(7)
    ds2 = ds.clean(idx, ds.y_true[idx])
    w_dg, traj_dg = deltagrad.absorb_rows(traj, sched, Xa, ds.y_prob, ds2.y_prob, ds.y_weight,
                                          ds2.y_weight, idx, dgc)
    ci, cm = deltagrad.build_correction_schedule(sched.numpy(), idx.numpy())
    w_rp, traj_rp = deltagrad.deltagrad_replay(traj[0], traj[1], sched, Xa, ds.y_prob,
                                               ds2.y_prob, ds.y_weight, ds2.y_weight, ci, cm,
                                               dgc, BS)
    assert torch.equal(w_dg, w_rp) and all(map(torch.equal, traj_dg, traj_rp))
    w_rt2, _, _ = train_head(ds2, cfg, cache=False, device="cpu")
    assert float(torch.linalg.norm(w_dg - w_rt2) / torch.linalg.norm(w_rt2)) < 0.05
    Xa_t = lr_head.augment(ds.X_test)
    f1 = [float(metrics.f1(torch.argmax(lr_head.probs(w, Xa_t), -1), ds.y_test, 2))
          for w in (w_dg, w_rt2)]
    assert abs(f1[0] - f1[1]) < 0.02, f1


def test_replay_rejects_a_correction_schedule_outside_the_rows():
    """A correction id outside [0, N) raises before any step runs: the kernel
    reads the rows it is given without a bounds check."""
    T, C, D = 4, 2, 3
    z = torch.zeros(T, C, D)
    with pytest.raises(ValueError, match="outside"):
        deltagrad.deltagrad_replay(z, z, torch.zeros(T, 2, dtype=torch.int64), torch.zeros(5, D),
                                   torch.zeros(5, C), torch.zeros(5, C), torch.ones(5),
                                   torch.ones(5), np.full((T, 1), 5, np.int32),
                                   np.ones((T, 1), np.float32), deltagrad.DGConfig(), 2)
