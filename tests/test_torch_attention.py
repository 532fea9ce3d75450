"""The port's attention ops and serving model against the JAX package, on the
CPU.

Op level: the port's plain flash program (`ops.flash_attention_ref`, and the
kernel wrapper, which computes it for CPU tensors) against `repro`'s
reference form and its Pallas kernel in interpret mode, at GQA (Hq 4,
Hkv 2, D 16); the port's paged partials, `combine_pages` and decode op
against `repro`'s reference forms. Model level: `reduced(olmo-1b)`, the same with n_kv_heads 2, and
two variants that take the other norm, MLP, bias and head options, with
`repro`'s parameters carried across by `convert.model_params_from_numpy`:
prefill logits, the committed pages, and 4 paged decode steps.

Tolerance: float32, |port - repro| <= 2e-6 + 1e-5 |repro| for an op, and
<= 1e-5 + 1e-4 |repro| for logits and pages (the sums run in another order
than XLA's; the model compounds them over 2 layers).

The checks run as one test item on purpose: under `pytest -n 6 --dist load`
every item collected after `tests/test_serving_prop.py` enlarges the chunk
of consecutive tests xdist hands one worker, and a worker that receives
most of that hypothesis file runs alone for many minutes and can pass the
kernel's per-process memory-map limit (XLA's JIT then segfaults). With few
items after it, the schedule stays as it was before this file existed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.backend import get_backend as j_get_backend
from repro.kernels import ops as j_ops
from repro.kernels import paged_attention as j_paged
from repro.models import Model as JModel
from repro.models import attention as j_attn
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.backend import Backend
from repro_torch.kernels import LAUNCHES, ops, paged_attention
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models.attention import AttnSpec

OP_TOL = dict(rtol=1e-5, atol=2e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


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


# Sq, Skv, first q position, window, softcap
FLASH_CASES = {
    "square": (32, 32, 0, 0, 0.0),
    "tail": (16, 48, 32, 0, 0.0),  # Sq < Skv, queries at offset positions
    "window": (32, 32, 0, 8, 0.0),
    "softcap": (32, 32, 0, 0, 5.0),
    "odd_length": (24, 24, 0, 0, 0.0),  # not a power of two: blocks of 24
}


def _check_flash_attention():
    """At each of FLASH_CASES: port reference and CPU wrapper == repro's
    reference and interpret-mode kernel, on the same inputs; the CPU
    wrapper counts no launch."""
    for case in sorted(FLASH_CASES):
        _flash_case(*FLASH_CASES[case])


def _flash_case(Sq, Skv, off, window, softcap):
    r = np.random.default_rng(0)
    q = r.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    qpos = (off + np.arange(Sq)).astype(np.int32)
    kpos = np.arange(Skv).astype(np.int32)
    spec = AttnSpec(True, window, softcap)
    jspec = j_attn.AttnSpec(True, window, softcap)
    want_ref = np.asarray(j_ops.flash_attention_ref(*_j(q, k, v, qpos, kpos), jspec))
    want_kernel = np.asarray(j_ops.flash_attention(*_j(q, k, v, qpos, kpos), jspec))
    before = dict(LAUNCHES)
    got_ref = ops.flash_attention_ref(*_t(q, k, v, qpos, kpos), spec).numpy()
    got_wrapper = ops.flash_attention(*_t(q, k, v, qpos, kpos), spec).numpy()
    assert LAUNCHES == before
    assert got_ref.shape == (2, Sq, 4, 16)
    np.testing.assert_array_equal(got_wrapper, got_ref)
    np.testing.assert_allclose(got_ref, want_ref, **OP_TOL)
    np.testing.assert_allclose(got_ref, want_kernel, **OP_TOL)


def _check_attn_blocks():
    for Sq, Skv in ((256, 256), (32, 256), (24, 48), (37, 130), (1, 1)):
        assert ops._attn_blocks(Sq, Skv) == j_ops._attn_blocks(Sq, Skv)


def _paged_case(G, seed=0):
    """Pools, a block table and positions covering: a parked slot (all
    trash), slots at different positions, one with an allocated page past
    its position, one ending exactly on a page boundary."""
    r = np.random.default_rng(seed)
    B, Hkv, D, P, n_phys = 4, 2, 16, 4, 14
    q = r.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    k_pages = r.standard_normal((n_phys, P, Hkv, D)).astype(np.float32)
    v_pages = r.standard_normal((n_phys, P, Hkv, D)).astype(np.float32)
    table = np.array([[3, 7, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0], [2, 5, 8, 9, 11, 0],
                      [4, 6, 0, 0, 0, 0]], np.int32)
    pos = np.array([9, 0, 13, 4], np.int32)  # slot 2: page 4 lies past pos 13
    return q, k_pages, v_pages, table, pos


def _check_paged_decode_attention():
    """At G 1 and 2, with a window and with a softcap: partials (m, l, acc),
    the merge and the decode op == repro's reference forms; trash entries
    and pages past pos give exactly the neutral partial."""
    for G, window, softcap in ((1, 0, 0.0), (2, 0, 0.0), (2, 6, 0.0), (2, 0, 3.0)):
        _paged_check(G, window, softcap)


def _paged_check(G, window, softcap):
    q, k_pages, v_pages, table, pos = _paged_case(G)
    B, Hkv, D = q.shape[0], k_pages.shape[2], q.shape[-1]
    spec = AttnSpec(True, window, softcap)
    jspec = j_attn.AttnSpec(True, window, softcap)
    qg = q.reshape(B, Hkv, G, D)
    kw = dict(window=window, softcap=softcap)
    want = j_paged.paged_attention_partials_reference(*_j(qg, k_pages, v_pages, table, pos), **kw)
    got = paged_attention.paged_attention_partials(*_t(qg, k_pages, v_pages, table, pos), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OP_TOL)
    m, l, acc = (x.numpy() for x in got)
    dead = (table == 0) | (np.arange(table.shape[1])[None] * k_pages.shape[1] > pos[:, None])
    assert (m.transpose(0, 2, 1, 3)[dead] == -1e30).all()
    assert not l.transpose(0, 2, 1, 3)[dead].any() and not acc.transpose(0, 2, 1, 3, 4)[dead].any()
    merged = paged_attention.combine_pages(*got).numpy()
    np.testing.assert_allclose(merged, np.asarray(j_paged.combine_pages(*want)), **OP_TOL)
    want_ref = np.asarray(j_ops.paged_decode_attention_ref(*_j(q, k_pages, v_pages, table, pos),
                                                           jspec))
    for form in (ops.paged_decode_attention_ref, ops.paged_decode_attention):
        out = form(*_t(q, k_pages, v_pages, table, pos), spec).numpy()
        assert out.shape == q.shape
        np.testing.assert_allclose(out, want_ref, **OP_TOL)
    assert not np.abs(out[1]).any()  # the parked slot attends nothing


# ----------------------------------------------------------------------------
# layers and configs
# ----------------------------------------------------------------------------


def _check_layers():
    """apply_norm (nonparam_ln, layernorm, rmsnorm), apply_mlp (swiglu,
    gelu) and apply_rope (positions [S] and per slot [B, 1]) == repro's,
    eagerly on the same numpy inputs."""
    for norm_kind, mlp_kind in (("nonparam_ln", "swiglu"), ("layernorm", "gelu"),
                                ("rmsnorm", "swiglu")):
        _layers_case(norm_kind, mlp_kind)


def _layers_case(norm_kind, mlp_kind):
    from repro.models import layers as j_layers
    from repro_torch.models import layers

    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), norm_kind=norm_kind,
                              mlp_kind=mlp_kind)
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    norm = {"scale": r.standard_normal(64).astype(np.float32),
            "bias": r.standard_normal(64).astype(np.float32)}
    mlp = {k: (0.1 * r.standard_normal(shape)).astype(np.float32)
           for k, shape in (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    tn = {k: torch.from_numpy(v) for k, v in norm.items()}
    np.testing.assert_allclose(layers.apply_norm(cfg, tn, torch.from_numpy(x)).numpy(),
                               np.asarray(j_layers.apply_norm(cfg, norm, jnp.asarray(x))),
                               **OP_TOL)
    np.testing.assert_allclose(
        layers.apply_mlp(cfg, {k: torch.from_numpy(v) for k, v in mlp.items()},
                         torch.from_numpy(x)).numpy(),
        np.asarray(j_layers.apply_mlp(cfg, mlp, jnp.asarray(x))), **OP_TOL)
    h = r.standard_normal((2, 5, 4, 16)).astype(np.float32)
    for pos in (np.arange(3, 8), np.array([[9], [40]])):
        hh = h if pos.ndim == 1 else h[:, :1]
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(hh), torch.from_numpy(pos), 1e4).numpy(),
            np.asarray(j_layers.apply_rope(jnp.asarray(hh), jnp.asarray(pos), 1e4)), **OP_TOL)


def _check_configs():
    """olmo-1b and starcoder2-3b and their reduced forms carry every field of
    repro's; an arch the port cannot run yet raises and names ROADMAP.md."""
    for arch in ("olmo-1b", "starcoder2-3b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
        assert dataclasses.asdict(reduced(get_config(arch))) == \
            dataclasses.asdict(j_reduced(j_get_config(arch)))
    assert dataclasses.asdict(reduced(get_config("olmo-1b"), n_kv_heads=2)) == \
        dataclasses.asdict(j_reduced(j_get_config("olmo-1b"), n_kv_heads=2))
    cfg = get_config("olmo-1b")
    assert (cfg.padded_vocab, cfg.resolved_head_dim) == (50_432, 128)
    cfg = get_config("starcoder2-3b")
    assert (cfg.sliding_window, cfg.n_heads // cfg.n_kv_heads, cfg.padded_vocab) == (4096, 12,
                                                                                      49_152)
    assert reduced(cfg).sliding_window == 32
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_config("mamba2-370m")


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------


MODEL_VARIANTS = {
    "mha": {},  # reduced(olmo-1b): 4 heads, 4 kv heads
    "gqa": dict(n_kv_heads=2),
    # the other block options qkv_proj, apply_mlp and lm_logits take (rmsnorm:
    # test_layers_match_jax)
    "layernorm_gelu_bias_untied": dict(norm_kind="layernorm", mlp_kind="gelu", qkv_bias=True,
                                       tie_embeddings=False),
}


def _models(variant):
    """(repro model, repro params, port model, port params) for a variant of
    reduced(olmo-1b); every leaf of repro's init is moved by noise of scale
    0.05, so that biases and norm scales are not the zeros and ones they
    start from."""
    kw = MODEL_VARIANTS[variant]
    jm = JModel(j_reduced(j_get_config("olmo-1b"), **kw))
    leaves, tree = jax.tree.flatten(jm.init(jax.random.key(0)))
    r = np.random.default_rng(7)
    jp = jax.tree.unflatten(tree, [x + jnp.asarray(0.05 * r.standard_normal(x.shape), x.dtype)
                                   for x in leaves])
    cfg = reduced(get_config("olmo-1b"), **kw)
    m = Model(cfg, device="cpu")
    return jm, jp, m, convert.model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _check_model(variant):
    """The converted parameters are repro's leaf for leaf and the port's own
    init draws the same tree (other numbers, the same scales); then two
    slots prefilled alone at bucket 32 (right-padded), committed into the
    pages, and 4 batched paged decode steps at different positions give
    repro's logits and page contents."""
    models = _models(variant)
    _check_params(models)
    _check_prefill_commit_and_decode(models)


def _check_params(models):
    jm, jp, m, p = models
    own = m.init(0)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node_p, node_own = p, own
        for key in path:
            k = key.key if hasattr(key, "key") else key.idx
            node_p, node_own = node_p[k], node_own[k]
        np.testing.assert_array_equal(node_p.numpy(), np.asarray(leaf))
        assert node_own.shape == node_p.shape and node_own.dtype == torch.float32
    std = float(own["blocks"][0]["attn"]["wq"].std())
    assert abs(std - m.cfg.d_model**-0.5) < 0.1 * m.cfg.d_model**-0.5
    if m.cfg.qkv_bias:
        assert not own["blocks"][0]["attn"]["bq"].any()
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(
            m.cfg, jax.tree.map(lambda x: np.asarray(x)[..., :1], jp), "cpu")


def _check_prefill_commit_and_decode(models):
    jm, jp, m, p = models
    jbk, bk = j_get_backend("reference"), Backend("reference")
    # jitted, as repro's engine runs them (eager JAX compiles every primitive)
    j_prefill = jax.jit(functools.partial(jm.prefill, cache_len=32, backend=jbk,
                                          full_cache=True))
    j_decode = jax.jit(functools.partial(jm.decode_step, backend=jbk))
    j_commit = jax.jit(j_attn.paged_commit, static_argnums=4)
    r = np.random.default_rng(1)
    P, n_table, n_phys = 8, 6, 13
    jcache = jm.init_paged_cache(2, n_phys, P, n_table)
    cache = m.init_paged_cache(2, n_phys, P, n_table)
    rows = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 0, 0, 0]], np.int32)
    nxt = np.zeros((2, 1), np.int32)
    for slot, L in enumerate((21, 13)):
        W = 32  # one bucket for both: one prefill trace on the JAX side
        toks = np.zeros((1, W), np.int32)
        toks[0, :L] = r.integers(0, m.cfg.vocab_size, L)
        jl, jd = j_prefill(jp, {"tokens": jnp.asarray(toks)}, last_pos=jnp.asarray([L - 1]))
        tl, td = m.prefill(p, {"tokens": torch.from_numpy(toks)}, cache_len=W, backend=bk,
                           last_pos=torch.tensor([L - 1]), full_cache=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        jcache["blocks"] = ({"kv": j_commit(jcache["blocks"][0]["kv"], jd["blocks"][0]["kv"],
                                            jnp.asarray(rows[slot]), L, W)},)
        attn.paged_commit(cache["blocks"][0]["kv"], td["blocks"][0]["kv"],
                          torch.from_numpy(rows[slot]), L, W)
        nxt[slot, 0] = int(np.argmax(np.asarray(jl)[0, -1]))
    jcache.update(pages=jnp.asarray(rows), pos=jnp.asarray([21, 13], jnp.int32))
    cache["pages"][:] = torch.from_numpy(rows)
    cache["pos"][:] = torch.tensor([21, 13])
    for step in range(4):
        jl, jcache = j_decode(jp, jcache, {"tokens": jnp.asarray(nxt)})
        tl, cache = m.decode_step(p, cache, {"tokens": torch.from_numpy(nxt)}, backend=bk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
        assert torch.equal(cache["pos"], torch.tensor([22 + step, 14 + step], dtype=torch.int32))
    for name in ("k", "v"):  # every page a slot owns; the trash page is junk by design
        got = getattr(cache["blocks"][0]["kv"], name).numpy()[:, 1:]
        want = np.asarray(getattr(jcache["blocks"][0]["kv"], name))[:, 1:]
        np.testing.assert_allclose(got, want, **MODEL_TOL)


def _check_model_entry_points_need_the_card_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():  # with a card, the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(reduced(get_config("olmo-1b")))


def _check_windowed_and_chunked_prefill_routes():
    """repro's route: a chunked prefill where prefill_chunk > 0 and the KV
    span exceeds it, local_attention for a windowed multi-token query, flash
    otherwise; each gives flash attention's result, and a one-token query or
    a span within the chunk stays on flash."""
    r = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    pos = torch.arange(16)
    bk = Backend("reference")
    calls = []

    class Recording(Backend):
        def __getattribute__(self, name):
            if name in ("flash_attention", "local_attention", "chunked_prefill"):
                calls.append(name)
            return super().__getattribute__(name)

    rec = Recording("reference")
    for spec, chunk, want in ((AttnSpec(True, 4, 0.0), 0, "local_attention"),
                              (AttnSpec(True, 4, 0.0), 8, "chunked_prefill"),
                              (AttnSpec(), 8, "chunked_prefill"),
                              (AttnSpec(), 16, "flash_attention"),
                              (AttnSpec(), 0, "flash_attention")):
        calls.clear()
        out = attn.attention(q, k, v, pos, pos, spec, rec, chunk)
        assert calls == [want]
        np.testing.assert_allclose(out.numpy(), bk.flash_attention(q, k, v, pos, pos,
                                                                   spec).numpy(), **OP_TOL)
    calls.clear()
    attn.attention(q[:, :1], k, v, pos[:1] + 15, pos, AttnSpec(True, 4, 0.0), rec, 8)
    assert calls == ["flash_attention"]


def test_attention_ops_layers_and_model_match_jax():
    """Every check of this module, in one test item (see the module note):
    the flash and paged ops, the layers, the configs, the model variants,
    the device rule and the prefill routes."""
    _check_flash_attention()
    _check_attn_blocks()
    _check_paged_decode_attention()
    _check_layers()
    _check_configs()
    for variant in sorted(MODEL_VARIANTS):
        _check_model(variant)
    _check_model_entry_points_need_the_card_unless_asked_for_the_cpu()
    _check_windowed_and_chunked_prefill_routes()
