"""The port's five kernel ops against the JAX package, on the CPU.

Each kernel module of `repro_torch.kernels` holds a plain PyTorch version of
its kernel; its wrapper computes that version for CPU tensors. Both are held
against `repro`'s `Backend("reference")` and `Backend("pallas")` (Pallas in
interpret mode) on the same numpy inputs: odd N = 67, D = 33, C in {2, 3};
float32, rtol 1e-5, atol 1e-6. The ring decode's plain version is held
against `repro.kernels.ops.decode_attention_ref` at the kinds of the
card-only decode cases (bf16 outputs within 2^-7 of the largest). The
kernels themselves run only on the card: tests/test_torch_gpu.py holds them
against these plain versions there.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import Backend as JBackend
from repro.kernels import ops as j_ops
from repro.models import attention as j_attn
from repro_torch.kernels import (LAUNCHES, build, common, infl_scores, lr_grad, lr_hvp,
                                 minibatch_grad, ops, replay_correction)
from repro_torch.models.attention import AttnSpec, ring_valid

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


@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
def test_replay_correction_plain_matches_jax(r, C, jax_backend):
    """replay_correction_plain == repro's reference and interpret-mode Pallas
    correction, with the last slots padded (ci = 0, cm = 0) when r = 5; the
    wrapper on CPU tensors is the plain version exactly and launches
    nothing; an all-padded slot list adds exactly zero."""
    a = _op_data(C, seed=10 + C)
    rng = np.random.default_rng(r)
    a["Y_new"] = np.eye(C, dtype=np.float32)[rng.integers(0, C, N)]
    a["w_new"] = np.ones(N, np.float32)
    real = min(r, 3)
    a["ci"] = np.concatenate([rng.choice(N, real, replace=False), np.zeros(r - real)]).astype(
        np.int64)
    a["cm"] = np.concatenate([np.ones(real), np.zeros(r - real)]).astype(np.float32)
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    args = lambda d: (d["w"], d["Xa"], d["Y"], d["Y_new"], d["gw"], d["w_new"])  # noqa: E731
    before = dict(LAUNCHES)
    got = replay_correction.replay_correction_plain(*args(t), t["ci"], t["cm"], BS)
    jop = jax.jit(JBackend(jax_backend).replay_correction, static_argnums=8)  # one compile
    want = jop(*args({k: jnp.asarray(x) for k, x in a.items()}), jnp.asarray(a["ci"], jnp.int32),
               jnp.asarray(a["cm"]), BS)
    assert got.shape == (C, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(replay_correction.replay_correction(*args(t), t["ci"], t["cm"], BS), got)
    padded = replay_correction.replay_correction(*args(t), torch.zeros(r, dtype=torch.int64),
                                                 torch.zeros(r), BS)
    assert torch.equal(padded, torch.zeros(C, D))
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
                                          (5, 700, 16),
                                          # the gathered kernels' plan: slots around
                                          # the few-rows switch, the grid, wide rows
                                          (3, 2049, 132), (6, 2049, 132), (7, 2049, 132),
                                          (264, 2049, 132), (271, 2049, 132),
                                          (300, 20_001, 132), (2, 40_000, 132)])
def test_chunking_covers_rows_and_fills_the_card(n_rows, d, sms):
    """The column pass's chunks cover every row exactly once, fit the grid,
    and aim at BLOCKS_PER_SM blocks for each SM. The gathered kernels' plan
    depends on the shapes and the SM count only: few rows go to one CTA per
    block of columns that each take every row and fit shared memory; more
    go to a grid the card holds at once, at most one CTA a row, whose
    contiguous ranges take every row exactly once and whose partials fit
    the scratch cap."""
    rows, chunks = common.chunk_rows(n_rows, d, sms)
    assert rows >= 1 and (chunks - 1) * rows < n_rows <= chunks * rows
    assert chunks <= 65535
    want = -(-common.BLOCKS_PER_SM * sms // -(-d // common.COL_THREADS))
    assert min(n_rows, want) / 2 <= chunks <= want
    for c in (1, 2, 3, 16):
        few, grid = common.gather_plan(n_rows, d, c, sms)
        assert (few, grid) == common.gather_plan(n_rows, d, c, sms)
        if few:
            assert n_rows <= common.few_slots(c) and c * common.few_slots(c) <= 32
            assert (n_rows + c) * common.row_pitch(d) <= common.FEW_MAX_FLOATS
            assert (grid - 1) * common.GATHER_THREADS < d <= grid * common.GATHER_THREADS
            continue
        assert 1 <= grid <= min(n_rows, common.GATHER_CTAS_PER_SM * sms)
        assert grid * c * d <= max(common.GATHER_SCRATCH_FLOATS, c * d)
        taken = [i for b in range(grid) for i in range(*common.gather_rows(b, grid, n_rows))]
        assert taken == list(range(n_rows))
        # lr_hvp: always the many-rows grid, even where few rows would fit
        assert common.gather_plan(n_rows, d, c, sms, few_ok=False) == (
            False, min(n_rows, common.GATHER_CTAS_PER_SM * sms,
                       max(1, common.GATHER_SCRATCH_FLOATS // (c * d))))


# B, Hkv, G, D, W, ring position, window, softcap, dtype, K and V a view one
# element into wider rows (rows not 16-byte aligned): the kinds of the
# card-only DECODE_CASES at CPU widths
@pytest.mark.parametrize("B,Hkv,G,D,W,pos,window,softcap,dtype,shifted", [
    (2, 1, 16, 64, 48, 70, 48, 0.0, torch.float32, False),  # RecurrentGemma's grouping, wrapped
    (3, 2, 1, 32, 37, 50, 0, 0.0, torch.float32, True),  # G 1, W not a multiple of 8
    (2, 2, 16, 32, 40, 45, 20, 30.0, torch.bfloat16, True),  # bf16 with softcap and a window
    (2, 2, 4, 16, 24, 10, 0, 0.0, torch.float32, False),  # a ring not full yet
])
def test_decode_attention_plain_matches_jax(B, Hkv, G, D, W, pos, window, softcap, dtype,
                                            shifted):
    """The ring decode's plain version (and the wrapper, which computes it
    for CPU tensors, with no launch) against the JAX package's reference on
    the same inputs."""
    r = np.random.default_rng(W)
    q = r.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    k, v = (r.standard_normal((B, W, Hkv, D + shifted)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    spec, jspec = AttnSpec(True, window, softcap), j_attn.AttnSpec(True, window, softcap)
    valid = ring_valid(torch.tensor(pos), W, spec)
    want = np.asarray(j_ops.decode_attention_ref(
        *(jnp.asarray(x).astype(jdt) for x in (q, k[..., shifted:], v[..., shifted:])),
        jnp.asarray(valid.numpy()), jspec).astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    kt, vt = kt[..., shifted:], vt[..., shifted:]  # views with a last stride of 1
    before = dict(LAUNCHES)
    got = ops.decode_attention_ref(qt, kt, vt, valid, spec)
    assert torch.equal(ops.decode_attention(qt, kt, vt, valid, spec), got)
    assert LAUNCHES == before and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert np.abs(got.float().numpy() - want).max() <= 2**-7 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=2e-6)


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


def _header_function(src: str, name: str):
    """A `constexpr int name(int v) { return ...; }` of a CUDA header as a
    Python function of v, over the header's integer constants."""
    arg, body = re.search(rf"constexpr int {name}\(int (\w+)\) \{{\s*return (.+?);\s*\}}",
                          src).groups()
    cond = re.fullmatch(r"(.+) \? (.+) : (.+)", body)
    if cond:
        body = f"({cond[2]}) if ({cond[1]}) else ({cond[3]})"
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    code = compile(body.replace("/", "//"), name, "eval")
    return lambda v: eval(code, dict(consts), {arg: v})


def test_sources_and_wrappers_agree_on_constants():
    """The constants and the plan's helpers the wrappers size scratch and
    checks with are the ones in the CUDA headers."""
    hdr = (build.CSRC / "lr_rowcol.cuh").read_text()
    assert f"kColThreads = {common.COL_THREADS};" in hdr
    assert f"kMaxClasses = {common.MAX_CLASSES};" in hdr
    gather = (build.CSRC / "lr_gather.cuh").read_text()
    assert f"kThreads = {common.GATHER_THREADS};" in gather
    assert f"kCtasPerSm = {common.GATHER_CTAS_PER_SM};" in gather
    assert f"kFewMaxFloats = {common.FEW_MAX_FLOATS};" in gather
    few_slots = _header_function(gather, "few_slots")
    assert [few_slots(c) for c in range(1, common.MAX_CLASSES + 1)] == [
        common.few_slots(c) for c in range(1, common.MAX_CLASSES + 1)]
    row_pitch = _header_function(gather, "row_pitch")
    assert [row_pitch(n) for n in range(1, 4100)] == [common.row_pitch(n) for n in range(1, 4100)]
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert f'"chef_{name}"' in (build.CSRC.parent / f"{name}.py").read_text()
