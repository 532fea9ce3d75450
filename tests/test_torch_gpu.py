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

from repro_torch.kernels import LAUNCHES, infl_scores, lr_grad, lr_hvp, minibatch_grad

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
