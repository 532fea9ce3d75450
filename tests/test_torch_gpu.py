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
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (LAUNCHES, common, infl_scores, lr_grad, lr_hvp,
                                 minibatch_grad, replay_correction)

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


def _rows(spec, dev) -> int:
    """A row count: an int, or (k, a) for k times the many-rows kernel's
    largest grid on this card (GATHER_CTAS_PER_SM CTAs an SM) plus a."""
    if isinstance(spec, int):
        return spec
    k, a = spec
    return k * common.GATHER_CTAS_PER_SM * common.n_sms(dev) + a


def _spec_id(spec) -> str:
    return str(spec) if isinstance(spec, int) else f"{spec[0]}ctas{spec[1]:+d}"


# the gathered kernels' regimes (csrc/lr_gather.cuh, common.gather_plan):
# rows below, at and above the many-rows grid and not a multiple of it; the
# few-rows switch on both sides (few_slots: 6 at C 2, 2 at C 16); C 16 at
# D 2049 and D 20,001 (wider than a thread's registers hold: 8 rows and 1
# row at once in shared memory, rows_wide) and at D 20,501 (past rows_wide's
# shared memory: the streamed rows); a batch of 3000 ids over 5 rows (each
# repeated)
GATHER_SHAPES = [(4099, 2049, 2, 100), (4099, 2049, 2, (1, 0)), (4099, 2049, 2, (3, 7)),
                 (300, 2049, 2, 6), (300, 2049, 2, 7), (300, 2049, 16, 2), (300, 2049, 16, 3),
                 (1001, 2049, 16, 500), (600, 20001, 16, 300), (300, 20501, 16, 100),
                 (5, 2049, 2, 3000), (67, 2305, 3, 40)]


# lr_hvp on the many-rows grid (csrc/lr_gather.cuh, kHvp): C 1, 2, 3, 5 and
# 16; one row and fewer rows than the grid; D not a multiple of 4; D within
# a thread's register blocks (rows_staged: 9 at C 1-2, 6 at C 3, 1 at C 16),
# past them (rows_wide: 8 rows at once at D 2049 and 2305, 6 at D 3001) and
# past rows_wide's shared memory (rows_streamed)
HVP_SHAPES = [(1, 2049, 2), (100, 2049, 1), (4099, 2305, 2), (1001, 1535, 3), (4099, 2049, 3),
              (300, 255, 16), (4099, 2049, 16), (200, 3001, 5), (67, 20500, 3)]


@pytest.mark.parametrize("op,n,d,c,bs", [
    pytest.param(op, *shape, id=f"{'-'.join(map(str, shape))}-{op}")
    for op in sorted(CASES) for shape in [(67, 33, 2, 23), (67, 33, 3, 23), (1, 1, 1, 1),
                                          (515, 257, 16, 300), (4099, 2049, 2, 2000)]] + [
    pytest.param("minibatch_grad", n, d, c, bs,
                 id=f"{n}-{d}-{c}-{_spec_id(bs)}-minibatch_grad")
    for n, d, c, bs in GATHER_SHAPES] + [
    pytest.param("lr_hvp", n, d, c, 1, id=f"{n}-{d}-{c}-lr_hvp") for n, d, c in HVP_SHAPES])
def test_kernel_matches_plain(op, n, d, c, bs):
    """Kernel == plain version within the tolerance, repeats bit for bit, and
    counts one launch per call."""
    dev = _card()
    t = _data(dev, n, d, c, _rows(bs, dev))
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


# lr_grad at the kernel phase's shapes (chip_smoke.py: the 579 validation
# rows at D 2049) and three more: sha256 of the output's bytes, recorded on
# an H100 of 132 SMs (the plan depends on the SM count) from the one-launch
# kernel on csrc/lr_gather.cuh; they pin its summation order
LR_GRAD_SHAPES = [(579, 2049, 2), (579, 2049, 16), (4099, 2049, 2), (67, 33, 3)]
LR_GRAD_DIGESTS = {132: {"579-2049-2": "3977453b96fd38b9", "579-2049-16": "57fdfd245474af7b",
                         "4099-2049-2": "a7fc23bccc8c2bf7", "67-33-3": "c12f1ddd00e43ea6"}}
# the validation sets of the paper's Table 3 (twitter, fashion, chexpert,
# fact, mimic, retina: rows, D = features + 1, C), and mimic's at C 16
LR_GRAD_VAL_SHAPES = [(37, 769, 2), (146, 2049, 2), (234, 2049, 2), (255, 769, 2),
                      (579, 2049, 2), (3512, 2049, 2), (579, 2049, 16)]


def _lr_grad_inputs(dev, n, d, c) -> dict:
    """lr_grad's inputs, made with numpy from a fixed seed."""
    r = np.random.default_rng(7)
    Xa = r.standard_normal((n, d)).astype(np.float32)
    Xa[:, -1] = 1.0
    z = r.standard_normal((n, c))
    Y = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    return {k: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev) for k, x in dict(
        Xa=Xa, w=0.01 * r.standard_normal((c, d)), Y=Y, gw=r.uniform(0.5, 1.0, n)).items()}


def _lr_grad_digests(dev) -> dict:
    """sha256 (16 hex digits) of lr_grad's output at each of LR_GRAD_SHAPES."""
    out = {}
    for n, d, c in LR_GRAD_SHAPES:
        t = _lr_grad_inputs(dev, n, d, c)
        res = lr_grad.lr_grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.05)
        out[f"{n}-{d}-{c}"] = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def test_lr_grad_keeps_its_results():
    """lr_grad's results at LR_GRAD_SHAPES equal, bit for bit, those the
    one-launch kernel gave when they were recorded."""
    dev = _card()
    want = LR_GRAD_DIGESTS.get(common.n_sms(dev))
    if want is None:
        pytest.skip(f"digests recorded for {sorted(LR_GRAD_DIGESTS)} SMs, this card has "
                    f"{common.n_sms(dev)}")
    assert _lr_grad_digests(dev) == want


@pytest.mark.parametrize("n,d,c", LR_GRAD_VAL_SHAPES, ids=lambda v: str(v))
def test_lr_grad_matches_plain_at_the_validation_shapes(n, d, c):
    """lr_grad at each Table 3 validation set's shape: the plain version
    within the tolerance, bit for bit on a second call, one launch a call."""
    dev = _card()
    t = _lr_grad_inputs(dev, n, d, c)
    before = LAUNCHES["lr_grad"]
    out = lr_grad.lr_grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.05)
    ref = lr_grad.lr_grad_plain(t["w"], t["Xa"], t["Y"], t["gw"], 0.05)
    err = float((out - ref).abs().max())
    assert err <= TOL_REL * float(ref.abs().max()) + TOL_ABS
    assert torch.equal(lr_grad.lr_grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.05), out)
    assert LAUNCHES["lr_grad"] == before + 2


def test_first_use_from_two_threads(monkeypatch, tmp_path):
    """Two threads whose first calls to lr_grad meet (its library built anew
    into an empty directory): nvcc runs once, both results equal the plain
    version, and LAUNCHES counts both."""
    import threading

    from repro_torch.kernels import build

    dev = _card()
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_ENTRIES", {})
    popen, compiles = build.subprocess.Popen, []

    def counting_popen(cmd, *args, **kw):
        compiles.append(cmd)
        return popen(cmd, *args, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", counting_popen)
    t = _lr_grad_inputs(dev, 579, 2049, 2)
    ref = lr_grad.lr_grad_plain(t["w"], t["Xa"], t["Y"], t["gw"], 0.05)
    before, outs, start = LAUNCHES["lr_grad"], [], threading.Barrier(2)

    def first_call():
        start.wait()
        out = lr_grad.lr_grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.05)
        torch.cuda.current_stream().synchronize()
        outs.append(out)

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(compiles) == 1 and len(outs) == 2
    for out in outs:
        assert float((out - ref).abs().max()) <= TOL_REL * float(ref.abs().max()) + TOL_ABS
    assert torch.equal(outs[0], outs[1])
    assert LAUNCHES["lr_grad"] == before + 2


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


def test_stream_cuda_matches_reference_on_the_card():
    """A 2-window warm stream (the second window absorbed by a DeltaGrad-L
    replay of about 375 changed rows a step) on backend cuda and on backend
    reference, on the card: the same rows cleaned and F1 within 0.005; the
    five CHEF kernels all launch on cuda."""
    from repro_torch.configs import ChefConfig
    from repro_torch.kernels import reset_launches
    from repro_torch.stream import StreamingCleaningSession, SyntheticStream

    dev = _card()
    src = SyntheticStream(torch.Generator(device=dev).manual_seed(3), window_size=1501,
                          n_windows=2, n_val=101, n_test=201, feature_dim=47, class_sep=0.5)
    cfg = ChefConfig(budget=20, round_size=10, n_epochs=6, batch_size=750, lr=0.05, l2=0.02)
    res = {}
    for b in ("cuda", "reference"):
        reset_launches()
        res[b] = StreamingCleaningSession(src, dataclasses.replace(cfg, backend=b)).run()
        if b == "cuda":
            assert all(LAUNCHES[k] > 0 for k in ("lr_grad", "lr_hvp", "minibatch_grad",
                                                 "infl_scores", "replay_correction"))
    a, b = res["cuda"], res["reference"]
    assert len(a.history) == len(b.history) == 2
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


@pytest.mark.parametrize("n,d,c,r", [
    pytest.param(n, d, c, r, id=f"{n}-{d}-{c}-{_spec_id(r)}")
    for n, d, c, r in [(67, 33, 2, 1), (67, 33, 3, 5), (1, 1, 1, 1), (515, 257, 16, 300),
                       (4099, 2049, 2, 3), (4099, 2049, 3, 2000)] + GATHER_SHAPES])
def test_replay_correction_matches_plain(n, d, c, r):
    """Kernel == plain version within the tolerance, padded slots add
    nothing, the kernel repeats bit for bit and counts one launch a call."""
    dev = _card()
    args = _correction_data(dev, n, d, c, _rows(r, dev))
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


# bf16 outputs: each side rounds its float32 result to bfloat16 once, so two
# results within the float32 tolerance may still land one bf16 step apart
# (2^-8 of the value): max|kernel - plain| <= 2^-7 * max|plain|.
BF16_TOL_REL = 2.0**-7

# B, Sq, Skv, Hq, Hkv, D, first q position, window, softcap, dtype
FLASH_CASES = [
    (1, 256, 256, 16, 16, 128, 0, 0, 0.0, torch.float32),  # an olmo-1b prefill
    (1, 32, 256, 16, 16, 128, 64, 0, 0.0, torch.float32),  # a tail prefill
    (2, 77, 77, 4, 2, 64, 0, 16, 30.0, torch.float32),  # GQA + window + softcap, ragged
    (1, 100, 130, 8, 2, 16, 30, 0, 0.0, torch.bfloat16),
    (1, 5, 3, 2, 1, 256, 0, 0, 0.0, torch.float32),
    # the tensor-core tile program's fragment layouts: Sq, Skv not multiples
    # of 16 or 8; D 16, 32, 64, 128, 256 in both types; a window smaller than
    # a tile with rows that see no key (positions below every key); softcap
    # with GQA 12; D not a multiple of 16 bytes (element-wise staging)
    (1, 35, 55, 4, 2, 16, 0, 0, 0.0, torch.float32),
    (1, 70, 45, 4, 4, 32, 20, 0, 0.0, torch.float32),
    (1, 70, 45, 4, 4, 32, 20, 0, 0.0, torch.bfloat16),
    (1, 130, 130, 4, 2, 64, -20, 5, 0.0, torch.float32),
    (1, 130, 130, 4, 2, 64, -20, 5, 0.0, torch.bfloat16),
    (1, 300, 300, 24, 2, 128, 0, 0, 20.0, torch.float32),
    (1, 256, 256, 16, 16, 128, 0, 0, 0.0, torch.bfloat16),
    (2, 90, 200, 4, 1, 256, 110, 0, 0.0, torch.bfloat16),
    (1, 200, 200, 4, 2, 256, 0, 100, 30.0, torch.float32),
    (1, 50, 63, 2, 1, 18, 0, 0, 0.0, torch.float32),
    (1, 50, 63, 2, 1, 20, 0, 0, 0.0, torch.bfloat16),
]


def _tol(dtype, ref):
    rel = BF16_TOL_REL if dtype == torch.bfloat16 else TOL_REL
    return rel * float(ref.float().abs().max()) + TOL_ABS


def test_attention_kernels_match_plain():
    """One item for the two attention kernels (few items after
    tests/test_serving_prop.py keep the xdist schedule; see
    tests/test_torch_attention.py):

    * the flash kernel, through the model-layout adapter, against the plain
      blocked program at each of FLASH_CASES: within the tolerance, bit for
      bit on a repeat, one launch a call; a row with no visible key gives
      zeros;
    * the paged partials kernel against its plain version at each of
      PAGED_CASES: m, l, acc on live pages and the merged output within
      the tolerance, trash and wholly invalid pages exactly (-1e30, 0, 0)
      and unread (NaN there changes no bit), bit for bit on a repeat, one
      launch a call;
    * no fallback: bad input on the card raises."""
    dev = _card()
    for case in FLASH_CASES:
        _flash_case(dev, *case)
    for case in PAGED_CASES:
        _paged_case(dev, *case)
    _attention_kernels_raise(dev)


def _flash_case(dev, B, Sq, Skv, Hq, Hkv, D, off, window, softcap, dtype):
    from repro_torch.kernels import ops
    from repro_torch.models.attention import AttnSpec

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, Sq, Hq, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
    qpos = torch.arange(off, off + Sq, dtype=torch.int32, device=dev)
    kpos = torch.arange(Skv, dtype=torch.int32, device=dev)
    spec = AttnSpec(True, window, softcap)
    before = LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, qpos, kpos, spec)
    torch.cuda.synchronize()
    ref = ops.flash_attention_ref(q, k, v, qpos, kpos, spec)
    assert out.shape == ref.shape == (B, Sq, Hq, D) and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= _tol(dtype, ref)
    assert torch.equal(ops.flash_attention(q, k, v, qpos, kpos, spec), out)
    assert LAUNCHES["flash_attention"] == before + 2
    blind = ops.flash_attention(q, k, v, qpos - 10_000, kpos, spec)  # every key in the future
    assert torch.equal(blind, torch.zeros_like(blind))


# B, Hkv, G, D, P, table pages, pool pages, window, softcap, dtype[, slots]
# (slots: `_paged_inputs`' positions a slot)
PAGED_CASES = [
    (4, 16, 1, 128, 8, 32, 129, 0, 0.0, torch.float32),  # olmo-1b decode, batch 4
    (3, 2, 4, 64, 8, 6, 20, 5, 0.0, torch.float32),
    (2, 2, 2, 32, 16, 4, 9, 0, 20.0, torch.bfloat16),
    # olmo-1b's decode as chip_smoke.py holds it: every slot's 32 pages
    # allocated, most past its position
    (4, 16, 1, 128, 8, 32, 129, 0, 0.0, torch.float32, (217, 100, 37, -1)),
    # starcoder2-3b's decode: G 12, window 4096, pages behind the window
    # retired but for a few still in the table
    (2, 2, 12, 128, 8, 754, 1509, 4096, 0.0, torch.float32, (5031, 6031)),
    # rows that do not start 16-byte aligned (D 34), float32 and bf16
    (3, 2, 3, 34, 8, 6, 40, 12, 0.0, torch.float32),
    (3, 2, 2, 34, 8, 6, 40, 0, 10.0, torch.bfloat16),
    (2, 4, 4, 128, 16, 10, 41, 40, 0.0, torch.float32, (150, 37)),  # P 16
]


def _paged_inputs(dev, B, Hkv, G, D, P, n_table, n_phys, dtype, seed=0, slots=None, window=0):
    """Pools, a block table and positions: slot 0 at a page boundary, slot 1
    with an allocated page past its position, the last slot parked (all
    trash, position 0); pages drawn without repeats from 1..n_phys-1. With
    `slots` (a position a slot, -1 parked) instead: every other slot holds
    all n_table pages, and with a window the pages behind it are retired to
    the trash page but for the last two."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, Hkv * G, D, generator=g, device=dev).to(dtype)
    k_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev).to(dtype)
    v_pages = torch.randn(n_phys, P, Hkv, D, generator=g, device=dev).to(dtype)
    ids = (torch.randperm(n_phys - 1, generator=g, device=dev) + 1).int()
    table = torch.zeros(B, n_table, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    if slots is not None:
        for b, p in enumerate(slots):
            if p >= 0:
                table[b] = ids[b * n_table:(b + 1) * n_table]
                pos[b] = p
                if window:
                    table[b, :max(0, (p - window + 1) // P - 2)] = 0
        return q, k_pages, v_pages, table, pos
    used = 0
    for b in range(B - 1):
        n = min(n_table, (n_phys - 1 - used) // max(B - 1, 1), 2 + 3 * b)
        table[b, :n] = ids[used:used + n]
        used += n
        pos[b] = P * (n - 1) if b == 0 else P * (n - 2) + 1  # slot 1: last page past pos
    return q, k_pages, v_pages, table, pos


def _dead_pages(table, pos, P, window):
    """[B, n_table]: the pages that give the neutral partial, the trash page
    and every page none of whose keys is visible."""
    first = torch.arange(table.shape[1], device=table.device) * P
    dead = (table == 0) | (first[None] > pos[:, None])
    if window:
        dead |= first[None] + P - 1 <= pos[:, None] - window
    return dead


def _check_partials(out, ref, dead):
    """The partials (m, l, acc) against the plain version's on live pages,
    within the tolerance of the plain live values, and exactly (-1e30, 0, 0)
    on dead pages."""
    cells = dead[:, None, :, None].expand(out[0].shape)  # [B, Hkv, n_table, G]
    for x, y in zip(out, ref):
        assert x.shape == y.shape and x.dtype == torch.float32
    m, l, acc = out
    assert torch.equal(m[cells], torch.full_like(m[cells], -1e30))
    assert not l[cells].any() and not acc[cells].any()
    for x, y in zip(out, ref):
        x, y = x[~cells], y[~cells]
        assert float((x - y).abs().max()) <= TOL_REL * float(y.abs().max()) + TOL_ABS


def _unread(call, out, pools, table, dead):
    """Poison what the kernel must not read, the trash page and every table
    page with no visible key (NaN in each of `pools`, indexed by page), and
    call it again: the same bits."""
    ids = torch.cat([table[dead], table.new_zeros(1)]).unique().long()
    for t in pools:
        t[ids] = float("nan")
    assert all(torch.equal(a, b) for a, b in zip(out, call()))


def _paged_case(dev, B, Hkv, G, D, P, n_table, n_phys, window, softcap, dtype, slots=None):
    from repro_torch.kernels import ops, paged_attention

    q, k_pages, v_pages, table, pos = _paged_inputs(dev, B, Hkv, G, D, P, n_table, n_phys, dtype,
                                                    slots=slots, window=window)
    qg = q.reshape(B, Hkv, G, D)
    kw = dict(window=window, softcap=softcap)
    call = lambda: paged_attention.paged_attention_partials(  # noqa: E731
        qg, k_pages, v_pages, table, pos, **kw)
    before = LAUNCHES["paged_attention"]
    out = call()
    torch.cuda.synchronize()
    ref = paged_attention.paged_attention_partials_reference(qg, k_pages, v_pages, table, pos,
                                                             **kw)
    dead = _dead_pages(table, pos, P, window)
    _check_partials(out, ref, dead)
    assert all(torch.equal(a, b) for a, b in zip(out, call()))
    assert LAUNCHES["paged_attention"] == before + 2
    from repro_torch.models.attention import AttnSpec

    spec = AttnSpec(True, window, softcap)
    o = ops.paged_decode_attention(q, k_pages, v_pages, table, pos, spec)
    o_ref = ops.paged_decode_attention_ref(q, k_pages, v_pages, table, pos, spec)
    assert float((o.float() - o_ref.float()).abs().max()) <= _tol(dtype, o_ref)
    _unread(call, out, (k_pages, v_pages), table, dead)


def _attention_kernels_raise(dev):
    from repro_torch.kernels import flash_attention, paged_attention

    q = torch.randn(1, 4, 8, 16, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        flash_attention.flash_attention(q, q, q, pos.long(), pos)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q, q.bfloat16(), q, pos, pos)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention.flash_attention(q, q[:, :3], q[:, :3], pos, pos)
    qg, k_pages, v_pages, table, ppos = _paged_inputs(dev, 2, 2, 2, 16, 8, 3, 9, torch.float32)
    qg = qg.reshape(2, 2, 2, 16)
    with pytest.raises(ValueError, match="device"):
        paged_attention.paged_attention_partials(qg, k_pages, v_pages, table.cpu(), ppos)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention.paged_attention_partials(qg.transpose(2, 3).contiguous().transpose(2, 3),
                                                 k_pages, v_pages, table, ppos)


def test_serve_engine_cuda_matches_reference_on_the_card():
    """ServeEngine on the kernels against ServeEngine on the reference
    backend, on the card at a small width (reduced olmo-1b widened to 4
    layers, d_model 256, GQA 4 / 2 heads of 64): the same finish order,
    tokens and counters, logits within 1e-4 * max|logit| + 1e-5 (float32
    sums in another order in two attention ops a layer), and each kernel
    launched once a layer per prefill and per decode round."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import reset_launches
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    dev = _card()
    cfg = reduced(get_config("olmo-1b"), n_layers=4, d_model=256, n_kv_heads=2, head_dim=64,
                  d_ff=512, vocab_size=512)
    model = Model(cfg, device=dev)
    params = model.init(0)
    r = np.random.default_rng(0)
    shared = r.integers(0, 512, 16)
    prompts = []
    for i, n in enumerate((9, 30, 70, 140, 30, 60)):
        p = r.integers(0, 512, n)
        if i % 2 == 1:
            p[:16] = shared
        prompts.append(p.astype(np.int32))
    runs = {}
    for name in ("cuda", "reference"):
        reset_launches()
        eng = ServeEngine(model, params, backend=name, device=dev,
                          config=ServeConfig(batch_size=3, max_len=160, trace_logits=True))
        done = eng.run([Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
        runs[name] = (done, dict(eng.stats), dict(LAUNCHES))
    (done, stats, launches), (done_ref, stats_ref, _) = runs["cuda"], runs["reference"]
    assert [q.uid for q in done] == [q.uid for q in done_ref]
    assert [q.out for q in done] == [q.out for q in done_ref]
    assert stats == stats_ref and stats["prefix_hits"] >= 1
    for a, b in zip(done, done_ref):
        la, lb = np.stack(a.logits), np.stack(b.logits)
        assert np.abs(la - lb).max() <= 1e-4 * np.abs(lb).max() + 1e-5
    assert launches["flash_attention"] == cfg.n_layers * len(prompts)
    assert launches["paged_attention"] == cfg.n_layers * stats["decode_rounds"]


# B, Sq, Skv, Hq, Hkv, D, first q position, window, softcap, dtype, chunk
WINDOWED_CASES = [
    (1, 300, 300, 24, 2, 128, 0, 96, 0.0, torch.float32, 100),  # starcoder2-3b heads, ragged
    (2, 77, 200, 4, 2, 64, 123, 40, 30.0, torch.float32, 64),  # a tail: GQA, window, softcap
    (1, 200, 200, 8, 2, 16, 0, 0, 0.0, torch.bfloat16, 30),  # mask blocks of 100, bf16
    (1, 130, 130, 4, 4, 32, 0, 50, 0.0, torch.bfloat16, 1000),  # one chunk
    # the tensor-core tile program: GQA 12 with a ragged last chunk (333 keys
    # in chunks of 128); D 256 in both types with a window smaller than a
    # tile or a softcap; rows that see no key; element-wise staging (D 18)
    (1, 200, 333, 24, 2, 128, 150, 40, 0.0, torch.float32, 100),
    (1, 150, 150, 4, 1, 256, 0, 7, 0.0, torch.float32, 100),
    (1, 150, 150, 4, 1, 256, 0, 0, 25.0, torch.bfloat16, 64),
    (1, 99, 99, 4, 2, 32, -10, 30, 0.0, torch.float32, 64),
    (1, 64, 64, 2, 2, 64, 0, 3, 10.0, torch.bfloat16, 50),
    (1, 90, 90, 2, 1, 18, 0, 20, 0.0, torch.float32, 64),
]


def test_windowed_kernels_and_engine_on_the_card():
    """One item for the banded, block-sparse and chunked-prefill kernels and
    the windowed engine (few items after tests/test_serving_prop.py keep the
    xdist schedule; see tests/test_torch_attention.py). At each of
    WINDOWED_CASES:

    * local_attention against its plain version, and bit for bit the flash
      kernel for the same spec;
    * block_sparse_attention with an all-ones mask bit for bit flash, with
      the band's own block mask bit for bit local, with a seeded random mask
      (about half the blocks) against its plain version; rows whose blocks
      are all disabled give zeros;
    * the chunked partials against the plain partials, and chunked plus the
      merge bit for bit flash, in ceil(Skv / chunk_blocks(chunk, 64))
      launches;
    * each kernel bit for bit on a repeat, one launch a call;

    then ServeEngine at reduced(starcoder2-3b) widened (4 layers, d_model
    256, 12 query heads over 2 kv heads of 64, window 48) on backend cuda,
    unchunked and with prefill_chunk 32, against reference: the same tokens,
    finish order and counters (pages retired), logits within 1e-4 *
    max|logit| + 1e-5, and the launches the schedule predicts."""
    dev = _card()
    for case in WINDOWED_CASES:
        _windowed_case(dev, *case)
    _windowed_kernels_raise(dev)
    _windowed_engine(dev)


def _windowed_case(dev, B, Sq, Skv, Hq, Hkv, D, off, window, softcap, dtype, chunk):
    from repro_torch.kernels import chunked_prefill, local_attention, ops
    from repro_torch.models.attention import AttnSpec

    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, Sq, Hq, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
    qpos = torch.arange(off, off + Sq, dtype=torch.int32, device=dev)
    kpos = torch.arange(Skv, dtype=torch.int32, device=dev)
    spec = AttnSpec(True, window, softcap)
    a = (q, k, v, qpos, kpos)
    flash = ops.flash_attention(*a, spec)
    n = dict(LAUNCHES)
    local = ops.local_attention(*a, spec)
    torch.cuda.synchronize()
    ref = ops.local_attention_ref(*a, spec)
    assert local.shape == ref.shape == (B, Sq, Hq, D) and local.dtype == dtype
    assert float((local.float() - ref.float()).abs().max()) <= _tol(dtype, ref)
    assert torch.equal(local, flash)
    assert torch.equal(ops.local_attention(*a, spec), local)
    assert LAUNCHES["local_attention"] == n["local_attention"] + 2

    nq, nk = ops.attn_block_mask_shape(Sq, Skv)
    bq, bk = Sq // nq, Skv // nk
    band = local_attention.band_live(qpos.cpu().reshape(nq, bq), kpos.cpu().reshape(nk, bk),
                                     causal=True, window=window)
    for mask, want in ((torch.ones(nq, nk), flash), (torch.from_numpy(band), local)):
        got = ops.block_sparse_attention(*a, mask.to(device=dev, dtype=torch.int32), spec)
        assert torch.equal(got, want)
    mask = (torch.rand(nq, nk, generator=g, device=dev) < 0.5).int()
    mask[0] = 0  # the first q block attends nothing
    sparse = ops.block_sparse_attention(*a, mask, spec)
    torch.cuda.synchronize()
    sparse_ref = ops.block_sparse_attention_ref(*a, mask, spec)
    assert float((sparse.float() - sparse_ref.float()).abs().max()) <= _tol(dtype, sparse_ref)
    assert not sparse[:, :bq].any()
    assert torch.equal(ops.block_sparse_attention(*a, mask, spec), sparse)
    assert LAUNCHES["block_sparse_attention"] == n["block_sparse_attention"] + 4

    parts = ops.chunked_prefill_partials(*a, spec, chunk)
    torch.cuda.synchronize()
    parts_ref = ops.chunked_prefill_partials_ref(*a, spec, chunk)
    for x, y in zip(parts, parts_ref):
        assert x.shape == y.shape and x.dtype == torch.float32
        assert float((x - y).abs().max()) <= TOL_REL * float(y.abs().max()) + TOL_ABS
    assert all(torch.equal(x, y) for x, y in zip(ops.chunked_prefill_partials(*a, spec, chunk),
                                                 parts))
    assert torch.equal(ops.chunked_prefill_finish(*parts, q), flash)
    launches = -(-Skv // chunked_prefill.chunk_blocks(chunk, chunked_prefill.KV_TILE))
    assert LAUNCHES["chunked_prefill"] == n["chunked_prefill"] + 2 * launches


def _windowed_kernels_raise(dev):
    from repro_torch.kernels import chunked_prefill, local_attention

    q = torch.randn(1, 4, 8, 16, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        local_attention.local_attention(q, q, q, pos.long(), pos)
    with pytest.raises(ValueError, match="kv heads"):
        chunked_prefill.chunked_prefill_partials(q, q[:, :3], q[:, :3], pos, pos, chunk=64)
    with pytest.raises(ValueError, match="block_mask"):
        local_attention.block_sparse_attention(q, q, q, pos, pos, block_q=8, block_k=8,
                                               block_mask=torch.ones(1, 1, device=dev))


def _windowed_engine(dev):
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import reset_launches
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    cfg = reduced(get_config("starcoder2-3b"), n_layers=4, d_model=256, n_heads=12, head_dim=64,
                  d_ff=512, vocab_size=512, sliding_window=48)
    model = Model(cfg, device=dev)
    params = model.init(0)
    r = np.random.default_rng(0)
    shared = r.integers(0, 512, 16)
    prompts = []
    for i, n in enumerate((9, 100, 70, 140, 30, 60)):
        p = r.integers(0, 512, n)
        if i % 2 == 1:
            p[:16] = shared
        prompts.append(p.astype(np.int32))
    runs = {}
    for name, chunk in (("cuda", 0), ("cuda", 32), ("reference", 0)):
        reset_launches()
        eng = ServeEngine(model, params, backend=name, device=dev,
                          config=ServeConfig(batch_size=3, max_len=160, trace_logits=True,
                                             prefill_chunk=chunk))
        done = eng.run([Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
        runs[name, chunk] = (done, dict(eng.stats), dict(LAUNCHES))
    done_ref, stats_ref, _ = runs["reference", 0]
    assert stats_ref["pages_retired"] > 0 and stats_ref["prefix_hits"] >= 1
    for chunk in (0, 32):
        done, stats, launches = runs["cuda", chunk]
        assert [q.uid for q in done] == [q.uid for q in done_ref]
        assert [q.out for q in done] == [q.out for q in done_ref]
        assert stats == stats_ref
        for x, y in zip(done, done_ref):
            la, lb = np.stack(x.logits), np.stack(y.logits)
            assert np.abs(la - lb).max() <= 1e-4 * np.abs(lb).max() + 1e-5
        # each prefill is one launch a layer: chunked where its kv span
        # (the prompt's bucket) exceeds the chunk, else banded
        kv = [1 << max(3, (len(p) - 1).bit_length()) for p in prompts]
        n_chunked = sum(-(-w // 64) for w in kv if chunk and w > chunk)
        n_local = sum(1 for w in kv if not (chunk and w > chunk))
        assert launches["chunked_prefill"] == cfg.n_layers * n_chunked
        assert launches["local_attention"] == cfg.n_layers * n_local
        assert launches["flash_attention"] == 0
        assert launches["paged_attention"] == cfg.n_layers * stats["decode_rounds"]


# B, Hkv, G, D, W, decode position, window, softcap, dtype, K rows 16-byte
# aligned (else K is a view one element into a wider row: rows 4-byte
# aligned in float32, 2-byte in bf16)
DECODE_CASES = [
    (2, 1, 16, 256, 2048, 3030, 2048, 0.0, torch.float32, True),  # recurrentgemma-9b, wrapped
    (4, 16, 1, 128, 256, 100, 0, 0.0, torch.float32, True),  # olmo-1b on a ring, not full yet
    (3, 2, 4, 64, 80, 201, 50, 30.0, torch.float32, True),  # a ragged last chunk, softcap
    (2, 2, 8, 128, 96, 140, 0, 0.0, torch.bfloat16, True),
    (2, 1, 16, 256, 1000, 1500, 0, 0.0, torch.float32, True),  # W not a multiple of the chunk
    (3, 2, 1, 128, 333, 400, 0, 0.0, torch.float32, False),  # G 1, ragged, unaligned rows
    (2, 2, 16, 128, 200, 250, 100, 30.0, torch.bfloat16, False),  # bf16 with softcap, unaligned
    (64, 8, 4, 128, 512, 600, 0, 0.0, torch.float32, True),  # more chunks than the grid holds
]


# B, Hkv, G, D, W, bf16: RecurrentGemma-9B's ring decode, OLMo-1B's ring
# (bf16), a ragged ring of 100, and a batch whose chunks outnumber what the
# card holds at once (D 512)
@pytest.mark.parametrize("B,Hkv,G,D,W,bf16", [(2, 1, 16, 256, 2048, False),
                                              (4, 16, 1, 128, 256, True),
                                              (3, 2, 4, 64, 100, False),
                                              (64, 16, 16, 512, 8192, False)])
def test_decode_plan_covers_the_ring_and_fits_a_cooperative_grid(B, Hkv, G, D, W, bf16):
    """The decode kernel's plan (csrc/decode_attention.cu) takes every ring
    slot of a cell exactly once, in chunks of at most 128 slots, a multiple
    of 8; it repeats; the grid is at least one CTA and at most one a work
    item and two an SM; the scratch holds m, l and acc of every item."""
    from repro_torch.kernels import decode_attention

    dev = _card()
    plan = decode_attention.decode_plan(B, Hkv, G, D, W, bf16, dev.index or 0)
    decode_attention.decode_plan.cache_clear()
    assert plan == decode_attention.decode_plan(B, Hkv, G, D, W, bf16, dev.index or 0)
    chunk, n_split = plan["chunk"], plan["n_split"]
    assert chunk % 8 == 0 and 8 <= chunk <= 128
    slots = [t for c in range(n_split) for t in range(c * chunk, min(W, (c + 1) * chunk))]
    assert slots == list(range(W)) and (n_split - 1) * chunk < W
    items = B * Hkv * n_split
    assert 1 <= plan["grid"] <= min(items, 2 * common.n_sms(dev))
    assert plan["scratch"] == items * G * (D + 2)
    if B * Hkv * -(-W // 128) <= common.n_sms(dev):  # room to split: the chunks fill the card
        assert items >= min(common.n_sms(dev), B * Hkv * -(-W // 32)) // 2


def test_decode_attention_kernel_matches_plain():
    """The ring decode kernel against its plain version at each of
    DECODE_CASES (valid from ring_valid at the case's position): within the
    tolerance (bf16 outputs 2^-7), bit for bit on a repeat, one launch a
    call, the ring read through a strided view of a wider tensor (with rows
    not 16-byte aligned in two cases), zeros when no slot is valid; bad
    input raises. Then the banded kernel at
    RecurrentGemma-9B's head shape (16 query heads over 1 kv head of 256,
    the DMAX 256 instance) against its plain version and bit for bit
    flash."""
    from repro_torch.kernels import decode_attention, ops
    from repro_torch.models.attention import AttnSpec, ring_valid

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    for B, Hkv, G, D, W, pos, window, softcap, dtype, aligned in DECODE_CASES:
        q = torch.randn(B, 1, Hkv * G, D, generator=g, device=dev).to(dtype)
        # a strided view: the kernel reads through strides; unaligned, each
        # row starts one element into a wider row, so most rows are not
        # 16-byte aligned
        wide = torch.randn(B, W, Hkv + 1, D + (not aligned), generator=g, device=dev).to(dtype)
        k = wide[:, :, 1:, 1 - aligned:]
        assert (k.data_ptr() % 16 == 0) == aligned
        v = torch.randn(B, W, Hkv, D, generator=g, device=dev).to(dtype)
        spec = AttnSpec(True, window, softcap)
        valid = ring_valid(torch.tensor(pos, device=dev), W, spec)
        before = LAUNCHES["decode_attention"]
        out = ops.decode_attention(q, k, v, valid, spec)
        torch.cuda.synchronize()
        ref = ops.decode_attention_ref(q, k, v, valid, spec)
        assert out.shape == ref.shape == (B, 1, Hkv * G, D) and out.dtype == dtype
        assert float((out.float() - ref.float()).abs().max()) <= _tol(dtype, ref)
        assert torch.equal(ops.decode_attention(q, k, v, valid, spec), out)
        blind = ops.decode_attention(q, k, v, torch.zeros_like(valid), spec)
        assert not blind.any()
        assert LAUNCHES["decode_attention"] == before + 3
    qg = torch.randn(1, 1, 2, 16, device=dev)
    kv = torch.randn(1, 8, 1, 16, device=dev)
    with pytest.raises(ValueError, match="bool"):
        decode_attention.decode_attention(qg, kv, kv, torch.ones(8, device=dev))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        decode_attention.decode_attention(qg, kv.bfloat16(), kv, torch.ones(8, dtype=torch.bool,
                                                                             device=dev))
    # the banded kernel at D = 256 (its prefills on RecurrentGemma-9B)
    S, window = 300, 128
    q = torch.randn(2, S, 16, 256, generator=g, device=dev)
    k = torch.randn(2, S, 1, 256, generator=g, device=dev)
    v = torch.randn(2, S, 1, 256, generator=g, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    spec = AttnSpec(True, window, 0.0)
    local = ops.local_attention(q, k, v, pos, pos, spec)
    torch.cuda.synchronize()
    ref = ops.local_attention_ref(q, k, v, pos, pos, spec)
    assert float((local - ref).abs().max()) <= _tol(torch.float32, ref)
    assert torch.equal(local, ops.flash_attention(q, k, v, pos, pos, spec))


# B, Hkv, G, D, P, table pages, pool pages, window, softcap, q dtype[, slots]
QUANT_CASES = [
    (4, 16, 1, 128, 8, 32, 129, 0, 0.0, torch.float32),  # olmo-1b decode, batch 4
    (2, 2, 12, 128, 8, 20, 41, 64, 0.0, torch.float32),  # starcoder2-like GQA with a window
    (3, 1, 16, 256, 8, 6, 20, 0, 20.0, torch.float32),  # D = 256, softcap
    (2, 2, 2, 32, 16, 4, 9, 0, 0.0, torch.bfloat16),
    # olmo-1b's and starcoder2-3b's decode as chip_smoke.py holds them (see
    # PAGED_CASES), rows of 34 codes (not 16-byte aligned), P 16
    (4, 16, 1, 128, 8, 32, 129, 0, 0.0, torch.float32, (217, 100, 37, -1)),
    (2, 2, 12, 128, 8, 754, 1509, 4096, 0.0, torch.float32, (5031, 6031)),
    (3, 2, 2, 34, 8, 6, 40, 12, 0.0, torch.float32),
    (2, 2, 4, 128, 16, 10, 41, 40, 0.0, torch.bfloat16, (150, 37)),
]


def test_quant_paged_kernel_matches_plain():
    """The int8 paged partials kernel against its plain version at each of
    QUANT_CASES (int8 pools with positive per-(page, head) scales, a parked
    slot, pages past a slot's position or behind its window): m, l, acc on
    live pages and the merged output within the tolerance, trash and wholly
    invalid pages exactly (-1e30, 0, 0) and unread (NaN scales there change
    no bit), bit for bit on a repeat, one launch a call; float pools
    raise."""
    from repro_torch.kernels import ops, paged_attention
    from repro_torch.models.attention import AttnSpec

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    for B, Hkv, G, D, P, n_table, n_phys, window, softcap, dtype, *slots in QUANT_CASES:
        q, k_pages, v_pages, table, pos = _paged_inputs(
            dev, B, Hkv, G, D, P, n_table, n_phys, torch.float32, seed=4,
            slots=slots[0] if slots else None, window=window)
        q = q.to(dtype)
        kq = torch.randint(-127, 128, k_pages.shape, generator=g, device=dev).to(torch.int8)
        vq = torch.randint(-127, 128, v_pages.shape, generator=g, device=dev).to(torch.int8)
        ks = 0.01 + 0.04 * torch.rand(n_phys, Hkv, generator=g, device=dev)
        vs = 0.01 + 0.04 * torch.rand(n_phys, Hkv, generator=g, device=dev)
        qg = q.reshape(B, Hkv, G, D)
        kw = dict(window=window, softcap=softcap)
        a = (qg, kq, vq, ks, vs, table, pos)
        call = lambda a=a, kw=kw: paged_attention.paged_attention_partials_quant(  # noqa: E731
            *a, **kw)
        before = LAUNCHES["paged_attention_quant"]
        out = call()
        torch.cuda.synchronize()
        ref = paged_attention.paged_attention_partials_quant_reference(*a, **kw)
        dead = _dead_pages(table, pos, P, window)
        _check_partials(out, ref, dead)
        assert all(torch.equal(x, y) for x, y in zip(out, call()))
        assert LAUNCHES["paged_attention_quant"] == before + 2
        spec = AttnSpec(True, window, softcap)
        o = ops.quant_paged_decode_attention(q, kq, vq, ks, vs, table, pos, spec)
        o_ref = ops.quant_paged_decode_attention_ref(q, kq, vq, ks, vs, table, pos, spec)
        assert float((o.float() - o_ref.float()).abs().max()) <= _tol(dtype, o_ref)
        _unread(call, out, (ks, vs), table, dead)
    with pytest.raises(ValueError, match="int8"):
        paged_attention.paged_attention_partials_quant(qg, k_pages.to(dtype), vq, ks, vs, table,
                                                       pos)
