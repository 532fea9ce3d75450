"""The port's sliding-window serving path against the JAX package, on the CPU.

Op level: the port's plain banded, block-sparse and chunked-prefill programs
(`ops.local_attention_ref`, `ops.block_sparse_attention_ref`,
`ops.chunked_prefill_ref` and its partials; the kernel wrappers compute them
for CPU tensors) against `repro.kernels.ops`' reference forms (the pure-jnp
mirrors), on the same numpy inputs: ragged Sq (blocks of 100 at Sq = 200),
GQA 4 / 2, window and softcap, a random block mask, chunks that do and do
not divide Skv. Tolerance: float32, |port - repro| <= 2e-6 + 1e-5 |repro|
for an op (sums in another order than XLA's), and <= 2e-6 + 1e-5 max|repro|
for the chunked partials m, l and acc, which are unnormalised sums over up
to Skv keys.

Engine level: `reduced(starcoder2-3b)` (window 32, GQA, qkv biases,
LayerNorm, GELU, an untied head) with `repro`'s weights carried across, the
port's `ServeEngine(device="cpu")` against `repro`'s on `reference`, with
`trace_logits`: prompts of 8 to 100 tokens, half of them sharing a
page-aligned prefix, page retirement on, with `prefill_chunk` 0 and 16 and
on a shrunk pool. Equal tokens, finish order, entry widths and counters
(`pages_retired` among them), logits within |port - repro| <= 1e-5 +
1e-4 |repro| (2 layers). These hold the port against `repro`'s runs, not
against `repro`'s join-versus-solo contract, which fails in `repro` itself.

The checks run as two test items on purpose; see the note in
tests/test_torch_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as j_engine
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.backend import get_backend as j_get_backend
from repro.kernels import chunked_prefill as j_chunked
from repro.kernels import local_attention as j_local
from repro.kernels import ops as j_ops
from repro.models import Model as JModel
from repro.models import attention as j_attn
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.backend import Backend
from repro_torch.kernels import LAUNCHES, chunked_prefill, local_attention, ops
from repro_torch.models import Model
from repro_torch.models.attention import AttnSpec
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine

OP_TOL = dict(rtol=1e-5, atol=2e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """Release the JAX executables this module compiled when it is done: XLA
    keeps each in memory maps of its own, and a test worker that runs many
    JAX tests can exhaust the kernel's per-process map limit."""
    yield
    jax.clear_caches()


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _inputs(Sq, Skv, off, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    return q, k, v, (off + np.arange(Sq)).astype(np.int32), np.arange(Skv).astype(np.int32)


# Sq, Skv, first q position, window, softcap
BANDED_CASES = {
    "ragged_window": (200, 200, 0, 64, 0.0),  # blocks of 100
    "window_softcap": (128, 256, 128, 40, 5.0),  # a tail: queries at 128.. over 256 keys
}
# Sq, Skv, window, softcap, chunk
CHUNK_CASES = (
    (128, 384, 0, 0.0, 100),  # chunk -> 128 keys, three chunks
    (128, 384, 48, 3.0, 256),  # chunk -> 256: chunks of 256 and 128, not dividing Skv
)


def _check_banded_ops():
    """local and block-sparse at each of BANDED_CASES == repro's reference
    forms; the CPU wrappers compute the plain version and count no launch;
    an all-ones mask gives local (and flash), the band's own block mask
    gives local bit for bit; a random mask == repro's."""
    for case in sorted(BANDED_CASES):
        Sq, Skv, off, window, softcap = BANDED_CASES[case]
        q, k, v, qpos, kpos = _inputs(Sq, Skv, off)
        spec = AttnSpec(True, window, softcap)
        jspec = j_attn.AttnSpec(True, window, softcap)
        args = _t(q, k, v, qpos, kpos)
        before = dict(LAUNCHES)
        got = ops.local_attention_ref(*args, spec)
        assert torch.equal(ops.local_attention(*args, spec), got)
        want = np.asarray(j_ops.local_attention_ref(*_j(q, k, v, qpos, kpos), jspec))
        np.testing.assert_allclose(got.numpy(), want, **OP_TOL)
        np.testing.assert_allclose(got.numpy(), ops.flash_attention_ref(*args, spec).numpy(),
                                   **OP_TOL)
        nq, nk = ops.attn_block_mask_shape(Sq, Skv)
        assert (nq, nk) == j_ops.attn_block_mask_shape(Sq, Skv)
        bq, bk = Sq // nq, Skv // nk
        band = local_attention.band_live(qpos.reshape(nq, bq), kpos.reshape(nk, bk),
                                         causal=True, window=window)
        for i in range(nq):
            for j in range(nk):
                assert band[i, j] == bool(j_local._band_live(
                    jnp.asarray(qpos.reshape(nq, bq)[i]), jnp.asarray(kpos.reshape(nk, bk)[j]),
                    causal=True, window=window))
        for mask in (np.ones((nq, nk), np.int32), band.astype(np.int32)):
            assert torch.equal(ops.block_sparse_attention_ref(*args, torch.from_numpy(mask),
                                                              spec), got)
        mask = (np.random.default_rng(1).random((nq, nk)) < 0.5).astype(np.int32)
        mask[0, 0] = 1
        got_sparse = ops.block_sparse_attention_ref(*args, torch.from_numpy(mask), spec)
        assert torch.equal(ops.block_sparse_attention(*args, torch.from_numpy(mask), spec),
                           got_sparse)
        want_sparse = np.asarray(j_ops.block_sparse_attention_ref(
            *_j(q, k, v, qpos, kpos), jnp.asarray(mask), jspec))
        np.testing.assert_allclose(got_sparse.numpy(), want_sparse, **OP_TOL)
        assert LAUNCHES == before


def _check_chunked_ops():
    """chunk_blocks == repro's; the chunked partials and the finished op at
    each of CHUNK_CASES == repro's reference forms and flash attention; the
    CPU wrapper computes the plain version and counts no launch."""
    for chunk in (1, 64, 100, 128, 129, 1000):
        for bk in (64, 100, 128):
            assert chunked_prefill.chunk_blocks(chunk, bk) == j_chunked.chunk_blocks(chunk, bk)
    for Sq, Skv, window, softcap, chunk in CHUNK_CASES:
        q, k, v, qpos, kpos = _inputs(Sq, Skv, Skv - Sq, seed=2)
        spec = AttnSpec(True, window, softcap)
        jspec = j_attn.AttnSpec(True, window, softcap)
        args = _t(q, k, v, qpos, kpos)
        before = dict(LAUNCHES)
        parts = ops.chunked_prefill_partials_ref(*args, spec, chunk)
        for a, b in zip(ops.chunked_prefill_partials(*args, spec, chunk), parts):
            assert torch.equal(a, b)
        want = j_ops.chunked_prefill_partials_ref(*_j(q, k, v, qpos, kpos), jspec, chunk)
        for a, b in zip(parts, want):
            assert a.shape == b.shape and a.dtype == torch.float32
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=OP_TOL["atol"] + OP_TOL["rtol"] * np.abs(b).max())
        got = ops.chunked_prefill_ref(*args, spec, chunk)
        assert torch.equal(ops.chunked_prefill(*args, spec, chunk), got)
        assert torch.equal(Backend("reference").chunked_prefill(*args, spec, chunk), got)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(j_ops.chunked_prefill_ref(*_j(q, k, v, qpos, kpos), jspec,
                                                              chunk)), **OP_TOL)
        np.testing.assert_allclose(got.numpy(), ops.flash_attention_ref(*args, spec).numpy(),
                                   **OP_TOL)
        assert LAUNCHES == before


def test_windowed_ops_match_jax():
    """The banded, block-sparse and chunked-prefill ops against repro's
    reference forms, in one test item (see the module note)."""
    _check_banded_ops()
    _check_chunked_ops()


# ----------------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------------

COUNTERS = ("prompt_tokens", "prefill_tokens", "prefix_hit_tokens", "prefix_hits", "cow_copies",
            "pages_retired", "decode_rounds", "slot_rounds", "prefix_evictions")
LENGTHS = (100, 8, 60, 50, 90)  # buckets 128, 8, 64, 64, 128
SHARED = 24  # a 3-page prefix on the even-numbered requests
CASES = {
    "unchunked": dict(batch_size=3, max_len=112),
    "chunked": dict(batch_size=3, max_len=112, prefill_chunk=16),
    # 25 usable pages for three slots of up to 14: admission waits for pages
    # that finishing and retiring slots free
    "shrunk_pool": dict(batch_size=3, max_len=112, num_pages=26),
}


def _prompts(seed=3):
    r = np.random.default_rng(seed)
    shared = r.integers(0, 256, SHARED)
    out = []
    for i, L in enumerate(LENGTHS):
        p = r.integers(0, 256, L)
        if i % 2 == 0 and L > SHARED:
            p[:SHARED] = shared
        out.append(p.astype(np.int32))
    return out


def _serve_both(case):
    """Both engines on one request list: {"jax"|"port": (done, stats)}."""
    jm = JModel(j_reduced(j_get_config("starcoder2-3b")))
    leaves, tree = jax.tree.flatten(jm.init(jax.random.key(0)))
    r = np.random.default_rng(7)  # move biases and norms off their zeros and ones
    jp = jax.tree.unflatten(tree, [x + jnp.asarray(0.05 * r.standard_normal(x.shape), x.dtype)
                                   for x in leaves])
    cfg = reduced(get_config("starcoder2-3b"))
    m = Model(cfg, device="cpu")
    p = convert.model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    ecfg = CASES[case]
    engines = {
        "jax": (j_engine.ServeEngine(jm, jp, backend=j_get_backend("reference"),
                                     config=j_engine.ServeConfig(trace_logits=True, **ecfg)),
                j_engine.Request),
        "port": (ServeEngine(m, p, backend="reference", device="cpu",
                             config=ServeConfig(trace_logits=True, **ecfg)), Request),
    }
    out = {}
    for name, (eng, make) in engines.items():
        done = eng.run([make(uid=i, prompt=q, max_new=6 + i % 3)
                        for i, q in enumerate(_prompts())])
        out[name] = (done, dict(eng.stats))
    return out


def _check_engine(case):
    runs = _serve_both(case)
    (done_j, want), (done_t, got) = runs["jax"], runs["port"]
    assert len(done_t) == len(done_j) == len(LENGTHS)
    for j, t in zip(done_j, done_t):
        assert (t.uid, t.out, t.entry_width, t.done) == (j.uid, j.out, j.entry_width, j.done)
        assert len(t.logits) == len(t.out) == len(j.logits)
        np.testing.assert_allclose(np.stack(t.logits), np.stack(j.logits), **LOGIT_TOL)
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert set(got) == set(want)
    assert got["pages_retired"] > 0 and got["prefix_hits"] >= 1
    return got


def test_windowed_engine_matches_jax():
    """For each of CASES: the same finish order, tokens, entry widths,
    counters and logits as repro's engine; every case retires pages and hits
    the prefix index."""
    stats = {case: _check_engine(case) for case in sorted(CASES)}
    # chunking changes how a prefill is computed, not what is scheduled
    assert stats["chunked"] == stats["unchunked"]
