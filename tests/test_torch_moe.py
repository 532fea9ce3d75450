"""The mixture-of-experts layer, the four architectures that came with it,
and speculative decode: the port against the JAX package, on the CPU.

* The MoE op (`repro_torch.models.moe.apply_moe` against
  `repro.models.moe.apply_moe`) on numpy inputs from a seed: SwiGLU and
  GELU experts, more than one chunk (MOE_CHUNK patched small in both
  packages), real capacity drops (capacity_factor lowered in both, drops
  asserted), and router logits that tie exactly (dyadic inputs: every sum
  is exact, so both frameworks see the same ties). The routes (expert ids
  in pick order) and the keep masks are equal; outputs and aux within
  |port - repro| <= 1e-5 + 1e-5 |repro| (float32 sums in another order).
* Paged engines on `repro`'s parameters (numpy draws carried to both):
  reduced qwen3-moe-30b-a3b with and without prefix sharing, reduced
  mixtral-8x22b (window 32) retiring pages, reduced qwen2-72b (qkv biases
  drawn nonzero); tokens, finish order, counters, logits within the serving
  tests' tolerance (|port - repro| <= 1e-5 + 1e-4 |repro|).
* Speculative decode against `repro`'s spec runs (`repro`'s own "spec ==
  plain" contract fails in `repro`, so the port is held to its spec runs)
  at reduced olmo-1b and reduced qwen3-moe-30b-a3b, spec_k 2 and 4, on the
  shared-prefix requests of tests/test_serving.py; and `_draft` on the
  same contexts.
* The four configs and their reduced forms carry every field of `repro`'s.

Few items, each well under 10 s on one worker (see the suite note in
tests/test_torch_attention.py); JAX's executables are freed at module end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as j_moe
import repro.serving.engine as j_engine
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.backend import get_backend as j_get_backend
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import NOT_PORTED
from repro_torch.models import moe
from repro_torch.serving import engine
from test_torch_recurrent import _models

OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("granite-8b", "qwen2-72b", "qwen3-moe-30b-a3b", "mixtral-8x22b")
COUNTERS = ("prompt_tokens", "prefill_tokens", "prefix_hit_tokens", "prefix_hits",
            "spec_proposed", "spec_accepted", "cow_copies", "pages_retired", "decode_rounds",
            "slot_rounds", "prefix_evictions")


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """Release the JAX executables this module compiled (see
    tests/test_torch_serving.py)."""
    yield
    jax.clear_caches()


def test_configs_match_jax():
    """The four configs and their reduced forms (4 experts, top 2, expert
    d_ff 32 for the MoEs) equal repro's field for field; only mamba2-370m,
    qwen2-vl-72b and whisper-tiny are left unported."""
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
        assert dataclasses.asdict(reduced(get_config(arch))) == \
            dataclasses.asdict(j_reduced(j_get_config(arch)))
    m = reduced(get_config("qwen3-moe-30b-a3b")).moe
    assert (m.n_experts, m.top_k, m.d_ff, m.parallelism) == (4, 2, 32, "ep")
    assert sorted(NOT_PORTED) == ["mamba2-370m", "qwen2-vl-72b", "whisper-tiny"]


# ----------------------------------------------------------------------------
# the op
# ----------------------------------------------------------------------------


def _keep(idx: np.ndarray, E: int, cap: int) -> np.ndarray:
    """The keep mask of picks idx [T, Sc, K]: each pick's place in its
    expert's buffer, counted over the flattened (token, pick) order."""
    T, Sc, K = idx.shape
    seen = np.zeros((T, E), np.int64)
    keep = np.zeros(idx.shape, bool)
    for s in range(Sc):
        for k in range(K):
            e = idx[:, s, k]
            keep[:, s, k] = seen[np.arange(T), e] < cap
            seen[np.arange(T), e] += 1
    return keep


OP_CASES = {
    # name: (mlp_kind, B, S, chunk, capacity_factor, dyadic ties)
    "swiglu": ("swiglu", 2, 16, 4096, 1.25, False),
    "gelu_chunks_drops": ("gelu", 2, 24, 8, 0.5, False),
    "swiglu_ties_drops": ("swiglu", 1, 32, 16, 0.5, True),
}


def _op_case(monkeypatch, name):
    """One case through both ops; the routes come from wrapping each
    package's top-k (jax.lax.top_k, moe.route) from the outside."""
    mlp_kind, B, S, chunk, cf, ties = OP_CASES[name]
    cfg = reduced(get_config("qwen3-moe-30b-a3b"), mlp_kind=mlp_kind)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jcfg = j_reduced(j_get_config("qwen3-moe-30b-a3b"), mlp_kind=mlp_kind)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    E, K, d = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    r = np.random.default_rng(len(name))
    p = moe.init_moe(lambda shape, axes=None, fan_in=None, mode="normal": torch.from_numpy(
        (r.standard_normal(shape) * fan_in**-0.5).astype(np.float32)), cfg, 1)
    p = {k: v[0].numpy() for k, v in p.items()}
    x = r.standard_normal((B, S, d)).astype(np.float32)
    if ties:  # small dyadic values: every router logit exact, experts 1, 2 and 3 alike
        x = (r.integers(-4, 5, (B, S, d)) / 4).astype(np.float32)
        router = (r.integers(-2, 3, (d, E)) / 8).astype(np.float32)
        router[:, 2] = router[:, 3] = router[:, 1]
        p["router"] = router
    monkeypatch.setattr(moe, "MOE_CHUNK", chunk)
    monkeypatch.setattr(j_moe, "MOE_CHUNK", chunk)
    routes = {}
    top_k = jax.lax.top_k

    def j_top_k(probs, k):
        out = top_k(probs, k)
        routes["jax"] = (np.asarray(probs), np.asarray(out[1]))
        return out

    def t_route(probs, k, plain=moe.route):
        out = plain(probs, k)
        routes["port"] = (probs.numpy(), out[1].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", j_top_k)
    monkeypatch.setattr(moe, "route", t_route)
    want, want_aux = j_moe.apply_moe(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x))
    got, got_aux = moe.apply_moe(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x))
    monkeypatch.undo()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **OP_TOL)
    Sc = min(S, chunk)
    cap = moe._capacity(cfg, Sc)
    assert cap == j_moe._capacity(jcfg, Sc)
    idx_j = routes["jax"][1].reshape(B * (S // Sc), Sc, K)
    idx_t = routes["port"][1].reshape(B * (S // Sc), Sc, K)
    np.testing.assert_array_equal(idx_t, idx_j)  # the picks, in pick order
    keep = _keep(idx_t, E, cap)
    np.testing.assert_array_equal(keep, _keep(idx_j, E, cap))
    return routes["jax"][0].reshape(-1, E), keep, S // Sc


def test_moe_op_matches_jax(monkeypatch):
    """Each of OP_CASES: output and aux within OP_TOL, the routes and keep
    masks equal; the chunked case runs 3 chunks a sequence, the lowered
    capacity factor really drops picks, and the dyadic case really has
    exact ties at the k-th pick (broken lowest expert first in both)."""
    for name in OP_CASES:
        probs, keep, n_chunks = _op_case(monkeypatch, name)
        if "chunks" in name:
            assert n_chunks == 3
        if "drops" in name:
            assert (~keep).sum() > 0, name
        if "ties" in name:
            top = -np.sort(-probs, axis=-1)
            assert (top[:, 1] == top[:, 2]).all()  # every 2nd pick is a tie with the 3rd
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3]])  # three-way tie for two picks
    gates, idx = moe.route(probs, 2)
    assert idx.tolist() == [[1, 2]] and torch.allclose(gates, torch.tensor([[0.5, 0.5]]))
    for n in (1, 7, 16, 100, 4096):
        assert moe._capacity(cfg, n) == j_moe._capacity(j_reduced(
            j_get_config("qwen3-moe-30b-a3b")), n)


# ----------------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------------


def _shared_prefix_requests(make, vocab, seed=11, prefix_len=16, tails=(4, 12, 24),
                            budgets=(3, 6, 5)):
    """tests/test_serving.py's requests: prompts extending one common
    prefix by tails of scattered lengths."""
    r = np.random.default_rng(seed)
    pref = r.integers(1, vocab, prefix_len)
    return [make(u, np.concatenate([pref, r.integers(1, vocab, t)]).astype(np.int32), b)
            for u, (t, b) in enumerate(zip(tails, budgets))]


def _serve_both(arch, ecfg, requests, **overrides):
    """repro's engine and the port's on the same parameters -> {"jax" |
    "port": (done, stats)}."""
    jm, jp, m, p = _models(arch, **overrides)
    out = {}
    for name, eng, make in (
            ("jax", j_engine.ServeEngine(jm, jp, backend=j_get_backend("reference"),
                                         config=j_engine.ServeConfig(trace_logits=True, **ecfg)),
             j_engine.Request),
            ("port", engine.ServeEngine(m, p, backend="reference", device="cpu",
                                        config=engine.ServeConfig(trace_logits=True, **ecfg)),
             engine.Request)):
        done = eng.run(requests(make, m.cfg.vocab_size))
        out[name] = (done, dict(eng.stats))
    return out


def _check_same(runs, what):
    (done_j, stats_j), (done_t, stats_t) = runs["jax"], runs["port"]
    assert [q.uid for q in done_t] == [q.uid for q in done_j], what
    for j, t in zip(done_j, done_t):
        assert (t.out, t.entry_width) == (j.out, j.entry_width), (what, t.uid)
        assert len(t.logits) == len(t.out)
        np.testing.assert_allclose(np.stack(t.logits), np.stack(j.logits), **LOGIT_TOL,
                                   err_msg=f"{what} uid {t.uid}")
    assert {k: stats_t[k] for k in COUNTERS} == {k: stats_j[k] for k in COUNTERS}, what
    return stats_t


def _long_requests(make, vocab):
    """Prompts of 20-60 tokens (buckets 32 and 64), 6 new tokens each; the
    first two share a 24-token prefix."""
    r = np.random.default_rng(3)
    shared = r.integers(1, vocab, 24)
    out = []
    for u, n in enumerate((44, 60, 20, 37)):
        p = r.integers(1, vocab, n)
        if u < 2:
            p[:24] = shared
        out.append(make(u, p.astype(np.int32), 6))
    return out


ENGINE_CASES = {
    # name: arch, engine config, requests
    "qwen3_moe_shared": ("qwen3-moe-30b-a3b", dict(batch_size=2, max_len=72), _long_requests),
    "qwen3_moe_unshared": ("qwen3-moe-30b-a3b", dict(batch_size=2, max_len=72,
                                                     share_prefix=False), _long_requests),
    "mixtral_window_retire": ("mixtral-8x22b", dict(batch_size=2, max_len=72), _long_requests),
    "qwen2_qkv_bias": ("qwen2-72b", dict(batch_size=2, max_len=72), _long_requests),
}


@pytest.mark.parametrize("cases", [("qwen3_moe_shared", "qwen3_moe_unshared"),
                                   ("mixtral_window_retire", "qwen2_qkv_bias")],
                         ids=["qwen3_moe", "mixtral_qwen2"])
def test_engines_match_jax(cases):
    """ENGINE_CASES, two a test item: the same finish order, tokens, entry
    widths and counters, logits within LOGIT_TOL; the shared run has prefix
    hits, the windowed one retires pages."""
    for name in cases:
        arch, ecfg, requests = ENGINE_CASES[name]
        stats = _check_same(_serve_both(arch, ecfg, requests), name)
        assert stats["decode_rounds"] > 0
        if name == "qwen3_moe_shared":
            assert stats["prefix_hits"] >= 1
        if name == "mixtral_window_retire":
            assert stats["pages_retired"] > 0


SPEC_BASE = dict(batch_size=2, max_len=48, cache="paged", page_size=8)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b"])
def test_spec_decode_matches_jax(arch):
    """spec_k 2 and 4 on tests/test_serving.py's shared-prefix requests and
    engine config: tokens, finish order, counters (spec_proposed > 0) and
    logits equal repro's spec runs. At olmo-1b also: `_draft` equals repro's
    on contexts with and without an earlier occurrence of the last token, and
    a spec engine still refuses int8 pools and the ring."""
    for k in (2, 4):
        stats = _check_same(_serve_both(arch, dict(SPEC_BASE, spec_k=k),
                                        _shared_prefix_requests), f"{arch} spec_k {k}")
        assert stats["spec_proposed"] > 0
    if arch != "olmo-1b":
        return
    jm, jp, m, p = _models(arch)
    config = dict(SPEC_BASE, spec_k=4)
    j_eng = j_engine.ServeEngine(jm, jp, config=j_engine.ServeConfig(**config))
    t_eng = engine.ServeEngine(m, p, device="cpu", config=engine.ServeConfig(**config))
    ctx = np.random.default_rng(0).integers(0, 5, 40).astype(np.int32)
    for n_out in range(0, 30, 3):
        for n in (0, 1, 3, 6):
            j_req = j_engine.Request(0, ctx[:10], 30, out=list(ctx[10:10 + n_out]))
            t_req = engine.Request(0, ctx[:10], 30, out=list(ctx[10:10 + n_out]))
            np.testing.assert_array_equal(t_eng._draft(t_req, n), j_eng._draft(j_req, n))
    unique = engine.Request(0, np.arange(5, dtype=np.int32), 3)  # no earlier occurrence
    assert t_eng._draft(unique, 3).tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="paged"):
        engine.ServeEngine(m, p, device="cpu", config=engine.ServeConfig(cache="ring", spec_k=2))
    m.kv_dtype = torch.int8
    with pytest.raises(ValueError, match="int8"):
        engine.ServeEngine(m, p, device="cpu", config=engine.ServeConfig(spec_k=2))


def _chip_smoke():
    """chip_smoke.py (repo root) as a module; importing it runs nothing."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_route_check_on_the_cpu():
    """chip_smoke.py's MoE route check on reduced qwen3-moe-30b-a3b (one
    layer): its recorder keys every routed prompt and decode token of a
    plain and a spec_k 4 run by (request, position, layer), none ambiguous,
    the same keys in all three runs, as many as the runs route (prompt
    tokens not served from the prefix index, then each new token but the
    last); the two backends agree with no flip; `_route_flips` takes a flip
    at a gap under ROUTE_MARGIN, with what it reaches, and fails one above
    it."""
    from repro_torch.models import Model

    cs = _chip_smoke()
    cfg = reduced(get_config("qwen3-moe-30b-a3b"), n_layers=1)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    rec = cs._RouteRecorder(torch, model, 8)
    rec.install()
    runs = {}
    try:
        for spec_k, backend in ((0, "cuda"), (0, "reference"), (4, "cuda")):
            reqs = _long_requests(engine.Request, cfg.vocab_size)
            eng = engine.ServeEngine(model, params, backend=backend, device="cpu",
                                     config=engine.ServeConfig(batch_size=2, max_len=72,
                                                               trace_logits=True, spec_k=spec_k))
            rec.watch(reqs)
            done = eng.run(reqs)
            assert rec.ambiguous == 0
            runs[(spec_k, backend)] = (done, dict(eng.stats), rec.table())
    finally:
        rec.uninstall()
    assert moe.route is rec.plain[0] and model.decode_step == rec.plain[3]
    (done, stats, table), (done_ref, _, table_ref) = runs[(0, "cuda")], runs[(0, "reference")]
    routed = sum(len(q.prompt) + q.max_new - 1 for q in done) - stats["prefix_hit_tokens"]
    assert stats["prefix_hits"] >= 1 and runs[(4, "cuda")][1]["spec_proposed"] > 0
    assert len(table) == cfg.n_layers * routed
    assert set(table) == set(table_ref) == set(runs[(4, "cuda")][2])
    out = cs._compare_routed(np, "cpu", done, done_ref, table, table_ref, 6, {0, 1}, 24)
    assert out["routes"]["roots"] == [] and out["routes"]["missing_keys"] == 0

    top = np.array([0.3, 0.2, 0.2 - 5e-6])  # k = 2: a gap of 5e-6 under the margin
    rec_a = {(u, p, l): (np.array([0, 1]), top) for u in (0, 1) for p in range(10)
             for l in range(3)}
    rec_b = dict(rec_a)
    rec_b[(0, 4, 1)] = (np.array([0, 2]), top)  # a root
    rec_b[(0, 6, 2)] = (np.array([2, 3]), top + 0.1)  # reached by it
    flips = cs._route_flips(np, rec_a, rec_b, {}, {0, 1}, 2)
    assert [r[:3] for r in flips["roots"]] == [[0, 4, 1]]
    assert flips["consequent_flips"] == 1 and flips["affected_from"] == {0: 4}
    wide = np.array([0.3, 0.25, 0.1])
    rec_b = dict(rec_a)
    rec_b[(1, 3, 0)] = (np.array([0, 3]), wide)
    rec_a[(1, 3, 0)] = (np.array([0, 1]), wide)
    with pytest.raises(SystemExit):
        cs._route_flips(np, rec_a, rec_b, {}, {0, 1}, 2)
