"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the `gpu` marker and skips where there is no CUDA
device; whether there is one is decided inside each test, never at import.
This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Tolerance: max|kernel - plain| <= 1e-4 * max|plain| + 1e-6 (float32, sums in
another order than the plain version's).
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import (LAUNCHES, infl_scores, lr_grad, lr_hvp, minibatch_grad,
                                 replay_correction)

pytestmark = pytest.mark.gpu

TOL_REL, TOL_ABS = 1e-4, 1e-6


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(dev, n, d, c, bs, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    Xa = torch.randn(n, d, generator=g, device=dev)
    Xa[:, -1] = 1.0
    w = 0.3 * torch.randn(c, d, generator=g, device=dev)
    return dict(
        Xa=Xa, w=w, v=0.3 * torch.randn(c, d, generator=g, device=dev),
        Y=torch.softmax(torch.randn(n, c, generator=g, device=dev), dim=-1),
        P=torch.softmax(Xa @ w.T, dim=-1),
        gw=0.5 + 0.5 * torch.rand(n, generator=g, device=dev),
        # with repeats: a schedule never repeats a row, the kernel must not care
        idx=torch.randint(0, n, (bs,), generator=g, device=dev),
    )


CASES = {
    "lr_grad": (lambda t: lr_grad.lr_grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.05),
                lambda t: lr_grad.lr_grad_plain(t["w"], t["Xa"], t["Y"], t["gw"], 0.05)),
    "lr_hvp": (lambda t: lr_hvp.lr_hvp(t["w"], t["v"], t["Xa"], t["gw"], 0.05),
               lambda t: lr_hvp.lr_hvp_plain(t["w"], t["v"], t["Xa"], t["gw"], 0.05)),
    "infl_scores": (lambda t: infl_scores.infl_scores(t["v"], t["Xa"], t["P"], t["Y"], 0.8),
                    lambda t: infl_scores.infl_scores_plain(t["v"], t["Xa"], t["P"], t["Y"], 0.8)),
    "minibatch_grad": (
        lambda t: minibatch_grad.minibatch_grad(t["w"], t["Xa"], t["Y"], t["gw"], t["idx"], 0.05),
        lambda t: minibatch_grad.minibatch_grad_plain(t["w"], t["Xa"], t["Y"], t["gw"], t["idx"],
                                                      0.05)),
}


@pytest.mark.parametrize("op", sorted(CASES))
@pytest.mark.parametrize("n,d,c,bs", [(67, 33, 2, 23), (67, 33, 3, 23), (1, 1, 1, 1),
                                      (515, 257, 16, 300), (4099, 2049, 2, 2000)])
def test_kernel_matches_plain(op, n, d, c, bs):
    """Kernel == plain version within the tolerance, repeats bit for bit, and
    counts one launch per call."""
    t = _data(_card(), n, d, c, bs)
    kern, plain = CASES[op]
    before = LAUNCHES[op]
    out = kern(t)
    torch.cuda.synchronize()
    ref = plain(t)
    assert out.shape == ref.shape and out.dtype == torch.float32
    err = float((out - ref).abs().max())
    assert err <= TOL_REL * float(ref.abs().max()) + TOL_ABS
    assert torch.equal(kern(t), out)
    assert LAUNCHES[op] == before + 2


def test_kernel_path_raises_on_what_it_does_not_take():
    """No fallback to the plain version: bad input on the card raises."""
    dev = _card()
    t = _data(dev, 67, 33, 17, 5)
    with pytest.raises(ValueError, match="classes"):
        lr_grad.lr_grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.0)
    t = _data(dev, 67, 33, 2, 5)
    with pytest.raises(ValueError, match="contiguous"):
        lr_hvp.lr_hvp(t["w"], t["v"], t["Xa"].T.contiguous().T, t["gw"], 0.0)
    with pytest.raises(ValueError, match="int64"):
        minibatch_grad.minibatch_grad(t["w"], t["Xa"], t["Y"], t["gw"], t["idx"].int(), 0.0)
    with pytest.raises(ValueError, match="device"):
        infl_scores.infl_scores(t["v"].cpu(), t["Xa"], t["P"], t["Y"], 0.8)


def test_sgd_train_repeats_bit_for_bit():
    """sgd_train on the kernels, twice: equal weights and trajectories."""
    from repro_torch.core import lr_head
    from repro_torch.core.backend import Backend

    dev = _card()
    t = _data(dev, 4099, 129, 3, 1)
    sched = lr_head.batch_schedule(0, 4099, 500, 3).to(dev)
    runs = [lr_head.sgd_train(torch.zeros(3, 129, device=dev), t["Xa"], t["Y"], t["gw"], sched,
                              l2=0.05, lr=0.05, momentum=0.9, backend=Backend("cuda"))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_run_chef_cuda_matches_reference_on_the_card():
    """The loop on backend cuda and on backend reference, on the card: the
    same selections and F1 at a small size."""
    from repro_torch.configs import ChefConfig
    from repro_torch.core import run_chef
    from repro_torch.data import make_dataset

    dev = _card()
    ds = make_dataset(torch.Generator(device=dev).manual_seed(3), n_train=1501, n_val=101,
                      n_test=201, feature_dim=47, class_sep=0.5, device=dev)
    cfg = ChefConfig(budget=30, round_size=10, n_epochs=6, batch_size=250, lr=0.05, l2=0.02)
    res = {b: run_chef(ds, dataclasses.replace(cfg, backend=b), selector="increm")
           for b in ("cuda", "reference")}
    a, b = res["cuda"], res["reference"]
    assert torch.equal(a.dataset.cleaned, b.dataset.cleaned)
    assert [r.f1_test for r in a.history] == pytest.approx([r.f1_test for r in b.history],
                                                           abs=0.005)


def _correction_data(dev, n, d, c, r, seed=0):
    """Inputs of one replay step's correction: r slots, the last third of
    them padded (ci = 0, cm = 0) when r > 1, real ones possibly repeated."""
    t = _data(dev, n, d, c, 1, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    real = r - r // 3 if r > 1 else 1
    ci = torch.zeros(r, dtype=torch.int64, device=dev)
    ci[:real] = torch.randint(0, n, (real,), generator=g, device=dev)
    cm = torch.zeros(r, device=dev)
    cm[:real] = 1.0
    Y_new = torch.nn.functional.one_hot(torch.randint(0, c, (n,), generator=g, device=dev),
                                        c).float()
    return (t["w"], t["Xa"], t["Y"], Y_new, t["gw"], torch.ones(n, device=dev), ci, cm, 2000)


@pytest.mark.parametrize("n,d,c,r", [(67, 33, 2, 1), (67, 33, 3, 5), (1, 1, 1, 1),
                                     (515, 257, 16, 300), (4099, 2049, 2, 3),
                                     (4099, 2049, 3, 2000)])
def test_replay_correction_matches_plain(n, d, c, r):
    """Kernel == plain version within the tolerance, padded slots add
    nothing, the kernel repeats bit for bit and counts one launch a call."""
    args = _correction_data(_card(), n, d, c, r)
    before = LAUNCHES["replay_correction"]
    out = replay_correction.replay_correction(*args)
    torch.cuda.synchronize()
    ref = replay_correction.replay_correction_plain(*args)
    assert out.shape == ref.shape == (c, d) and out.dtype == torch.float32
    err = float((out - ref).abs().max())
    assert err <= TOL_REL * float(ref.abs().max()) + TOL_ABS
    assert torch.equal(replay_correction.replay_correction(*args), out)
    padded = list(args)
    padded[6], padded[7] = torch.zeros_like(args[6]), torch.zeros_like(args[7])
    assert torch.equal(replay_correction.replay_correction(*padded), torch.zeros_like(out))
    assert LAUNCHES["replay_correction"] == before + 3


def test_replay_correction_raises_on_what_it_does_not_take():
    """No fallback to the plain version: bad input on the card raises."""
    dev = _card()
    args = list(_correction_data(dev, 67, 33, 2, 5))
    for i, bad, match in ((6, args[6].int(), "int64"), (7, args[7].cpu(), "device"),
                          (3, args[3][:, :1].contiguous(), "shape"),
                          (1, args[1].T.contiguous().T, "contiguous")):
        with pytest.raises(ValueError, match=match):
            replay_correction.replay_correction(*args[:i], bad, *args[i + 1:])
    t = _data(dev, 67, 33, 17, 5)
    with pytest.raises(ValueError, match="classes"):
        replay_correction.replay_correction(t["w"], t["Xa"], t["Y"], t["Y"], t["gw"], t["gw"],
                                            args[6], args[7], 2000)


def test_deltagrad_replay_repeats_bit_for_bit_and_follows_the_reference():
    """The replay on the kernels, twice from the same cache: equal weights
    and trajectories bit for bit; and within 1e-4 (relative to the weights'
    size) of the replay on the reference backend."""
    from repro_torch.core import deltagrad, lr_head
    from repro_torch.core.backend import Backend

    dev = _card()
    t = _data(dev, 4099, 129, 3, 1)
    sched = lr_head.batch_schedule(0, 4099, 500, 3).to(dev)
    _, (ws, gs) = lr_head.sgd_train(torch.zeros(3, 129, device=dev), t["Xa"], t["Y"], t["gw"],
                                    sched, l2=0.05, lr=0.05, backend=Backend("cuda"))
    changed = sched[0, :40]
    Y_new = t["Y"].clone()
    Y_new[changed] = torch.nn.functional.one_hot(changed % 3, 3).float()
    w_new = t["gw"].clone()
    w_new[changed] = 1.0
    ci, cm = deltagrad.build_correction_schedule(sched.cpu().numpy(), changed.cpu().numpy())
    runs = [deltagrad.deltagrad_replay(ws, gs, sched, t["Xa"], t["Y"], Y_new, t["gw"], w_new, ci,
                                       cm, deltagrad.DGConfig(), 500, backend=Backend(b))
            for b in ("cuda", "cuda", "reference")]
    (w1, traj1), (w2, traj2), (w_ref, _) = runs
    assert torch.equal(w1, w2) and all(map(torch.equal, traj1, traj2))
    assert float((w1 - w_ref).abs().max()) <= 1e-4 * float(w_ref.abs().max())


def test_kill_and_restore_repeat_the_run_bit_for_bit_on_the_card(tmp_path):
    """A DeltaGrad session on the kernels, checkpointed after round 1 and
    restored into a fresh session: the rest of the run is the uninterrupted
    run bit for bit."""
    from repro_torch.cleaning import CleaningSession, make_scheduler
    from repro_torch.configs import ChefConfig
    from repro_torch.data import make_dataset

    dev = _card()
    ds = make_dataset(torch.Generator(device=dev).manual_seed(4), n_train=1501, n_val=101,
                      n_test=201, feature_dim=47, class_sep=0.5, device=dev)
    cfg = ChefConfig(budget=30, round_size=10, n_epochs=6, batch_size=250, lr=0.05, l2=0.02)
    full = make_scheduler(CleaningSession.initialize(ds, cfg)).run()
    make_scheduler(CleaningSession.initialize(ds, cfg), ckpt_dir=tmp_path).run(max_rounds=1)
    session = CleaningSession.restore(tmp_path, ds, cfg)
    assert session.w.is_cuda and session.round == 1
    res = make_scheduler(session).run()
    assert torch.equal(res.dataset.cleaned, full.dataset.cleaned)
    assert torch.equal(res.w, full.w)
    assert [r.f1_test for r in res.history] == [r.f1_test for r in full.history]
