"""The port's four kernel ops against the JAX package, on the CPU.

Each kernel module of `repro_torch.kernels` holds a plain PyTorch version of
its kernel; its wrapper computes that version for CPU tensors. Both are held
against `repro`'s `Backend("reference")` and `Backend("pallas")` (Pallas in
interpret mode) on the same numpy inputs: odd N = 67, D = 33, C in {2, 3};
float32, rtol 1e-5, atol 1e-6. The kernels themselves run only on the card:
tests/test_torch_gpu.py holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import Backend as JBackend
from repro_torch.kernels import (LAUNCHES, build, common, infl_scores, lr_grad, lr_hvp,
                                 minibatch_grad)

RTOL, ATOL = 1e-5, 1e-6
N, D, BS = 67, 33, 23


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _op_data(C, seed=0):
    r = np.random.default_rng(seed)
    Xa = r.standard_normal((N, D)).astype(np.float32)
    Xa[:, -1] = 1.0
    w = (0.3 * r.standard_normal((C, D))).astype(np.float32)
    return dict(
        Xa=Xa, w=w,
        v=(0.3 * r.standard_normal((C, D))).astype(np.float32),
        Y=_softmax(r.standard_normal((N, C))).astype(np.float32),
        P=_softmax(Xa @ w.T).astype(np.float32),
        gw=r.uniform(0.5, 1.0, N).astype(np.float32),
        idx=r.permutation(N)[:BS].astype(np.int64),
    )


def _ops(a, lib):
    """(plain version of the port, wrapper of the port, JAX op) per op name."""
    return {
        "lr_grad": (lambda t: lr_grad.lr_grad_plain(t["w"], t["Xa"], t["Y"], t["gw"], 0.05),
                    lambda t: lr_grad.lr_grad(t["w"], t["Xa"], t["Y"], t["gw"], 0.05),
                    lambda j: lib.lr_grad(j["w"], j["Xa"], j["Y"], j["gw"], 0.05)),
        "lr_hvp": (lambda t: lr_hvp.lr_hvp_plain(t["w"], t["v"], t["Xa"], t["gw"], 0.05),
                   lambda t: lr_hvp.lr_hvp(t["w"], t["v"], t["Xa"], t["gw"], 0.05),
                   lambda j: lib.lr_hvp(j["w"], j["v"], j["Xa"], j["gw"], 0.05)),
        "infl_scores": (
            lambda t: infl_scores.infl_scores_plain(t["v"], t["Xa"], t["P"], t["Y"], 0.8),
            lambda t: infl_scores.infl_scores(t["v"], t["Xa"], t["P"], t["Y"], 0.8),
            lambda j: lib.infl_scores(j["v"], j["Xa"], j["P"], j["Y"], 0.8)),
        "minibatch_grad": (
            lambda t: minibatch_grad.minibatch_grad_plain(t["w"], t["Xa"], t["Y"], t["gw"],
                                                          t["idx"], 0.05),
            lambda t: minibatch_grad.minibatch_grad(t["w"], t["Xa"], t["Y"], t["gw"], t["idx"],
                                                    0.05),
            lambda j: lib.minibatch_grad(j["w"], j["Xa"], j["Y"], j["gw"],
                                         j["idx"].astype(jnp.int32), 0.05)),
    }


@pytest.mark.parametrize("op", ["lr_grad", "lr_hvp", "infl_scores", "minibatch_grad"])
@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
def test_plain_version_matches_jax(op, C, jax_backend):
    """Port's plain version == repro's reference and interpret-mode Pallas
    forms; the port's wrapper on CPU tensors is the plain version exactly and
    launches nothing."""
    a = _op_data(C, seed=C)
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    j = {k: jnp.asarray(x) for k, x in a.items()}
    plain, wrapper, jop = _ops(a, JBackend(jax_backend))[op]
    before = dict(LAUNCHES)
    got = plain(t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jop(j)), rtol=RTOL, atol=ATOL)
    assert torch.equal(wrapper(t), got)
    assert LAUNCHES == before


def test_hvp_plain_with_precomputed_probs():
    """lr_hvp_plain(P=probs) is the reference backend's CG shortcut: the same
    product as recomputing the probs."""
    a = _op_data(3)
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    P = torch.softmax(t["Xa"] @ t["w"].T, dim=-1)
    np.testing.assert_allclose(
        lr_hvp.lr_hvp_plain(t["w"], t["v"], t["Xa"], t["gw"], 0.05, P=P).numpy(),
        lr_hvp.lr_hvp_plain(t["w"], t["v"], t["Xa"], t["gw"], 0.05).numpy(),
        rtol=RTOL, atol=ATOL)


def test_check_rejects_what_the_kernel_does_not_take():
    """The kernel path raises on a CPU tensor and on more than 16 classes."""
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="classes"):
        common.check("lr_grad", common.MAX_CLASSES + 1, Xa=(x, (4, 3)))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        common.check("lr_grad", 2, Xa=(x, (4, 3)))


@pytest.mark.parametrize("n_rows,d,sms", [(78_487, 2049, 132), (2000, 2049, 132),
                                          (579, 2049, 132), (67, 33, 132), (1, 1, 1),
                                          (5, 700, 16)])
def test_chunking_covers_rows_and_fills_the_card(n_rows, d, sms):
    """The column pass's chunks cover every row exactly once, fit the grid,
    and aim at BLOCKS_PER_SM blocks for each SM."""
    rows, chunks = common.chunk_rows(n_rows, d, sms)
    assert rows >= 1 and (chunks - 1) * rows < n_rows <= chunks * rows
    assert chunks <= 65535
    want = -(-common.BLOCKS_PER_SM * sms // -(-d // common.COL_THREADS))
    assert min(n_rows, want) / 2 <= chunks <= want


def test_build_command_and_hash(monkeypatch):
    """Each source builds alone, for sm_90a, with -Xptxas -v; the build
    directory is keyed by the sources and flags."""
    monkeypatch.setattr(build.shutil, "which", lambda _: "/toolkit/bin/nvcc")
    for name in build.SOURCES:
        cmd = build.nvcc_command(name, build.Path("/x/lib.so"))
        assert cmd[0] == "/toolkit/bin/nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd and ["-Xptxas", "-v"] == cmd[-5:-3]
        assert cmd[-1].endswith(f"csrc/{name}.cu")
    assert build.build_dir().name == build.source_hash() == build.source_hash()


def test_no_nvcc_means_no_build(monkeypatch, tmp_path):
    """Where the toolkit is missing, building raises and writes nothing; a
    wrapper never falls back to the plain version."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "b")
    monkeypatch.setattr(build, "CUDA_NVCC", tmp_path / "missing")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all(("lr_grad",))
    assert not (tmp_path / "b").exists()


def test_sources_and_wrappers_agree_on_constants():
    """The constants the wrappers size scratch and checks with are the ones
    in the CUDA header."""
    hdr = (build.CSRC / "lr_rowcol.cuh").read_text()
    assert f"kColThreads = {common.COL_THREADS};" in hdr
    assert f"kMaxClasses = {common.MAX_CLASSES};" in hdr
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert f'"chef_{name}"' in (build.CSRC.parent / f"{name}.py").read_text()
