"""The port's ring-cache serving path and RG-LRU blocks against the JAX
package, on the CPU.

Parameters and inputs are drawn with numpy (`numpy_params`) and handed to
both packages, so that no JAX program is compiled but the functions held.

Block level: `models.rglru.apply_rglru_seq` (the doubling scan) and
`apply_rglru_step` against `repro.models.rglru` on the same numpy inputs,
at `reduced(recurrentgemma-9b)` (LRU width 64) from zero state and at a
256-wide block from a carried state. Tolerance: float32,
|port - repro| <= 1e-5 + 1e-4 |repro|: the scan sums in another order than
`jax.lax.associative_scan`, and the gates go through two matmuls.

Model level: ring prefill plus 8 decode steps with `repro`'s parameters
carried across (perturbed off their zeros and ones), at
`reduced(recurrentgemma-9b)` widened to 5 layers (a super-block of rglru,
rglru, local and the two remainder rglru layers of `params["tail"]`; window
32, a 40-token prompt: the ring roll and its wrap both run) and at
`reduced(olmo-1b)` on a ring of 44 slots (full attention, wrapping after 4
decode steps). Logits and every cache leaf (the position, the RG-LRU
states, the ring's K/V) within |port - repro| <= 1e-5 + 1e-4 |repro|.
With `kv_dtype` bf16 the prefill's cache is bf16 in both packages (its
values one bf16 step apart at most: 2^-7 |repro|). The int8 ring runs in
tests/test_torch_int8.py.

Engine level: `ServeEngine(cache="auto")` at `reduced(recurrentgemma-9b)`
resolves to the ring in both packages; a wave of two requests past the
window and one that joins a freed slot mid-stream give `repro`'s tokens,
finish order, entry widths and prefill widths, logits within the float
tolerance above; `cache="paged"` raises ValueError in both.

The checks run as three test items on purpose; see the note in
tests/test_torch_attention.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as j_engine
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.backend import get_backend as j_get_backend
from repro.models import Model as JModel
from repro.models import rglru as j_rglru
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import LAUNCHES
from repro_torch.models import Model, rglru
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """Release the JAX executables this module compiled when it is done: XLA
    keeps each in memory maps of its own, and a test worker that runs many
    JAX tests can exhaust the kernel's per-process map limit."""
    yield
    jax.clear_caches()


def numpy_params(cfg, seed: int) -> dict:
    """Parameters for `cfg` as a numpy tree in `repro`'s layout (the port's
    `init_params` walks it in `repro`'s order and shapes), drawn with numpy:
    fan-in-scaled normals, and the zeros and ones of biases, norm scales and
    the RG-LRU's lambda moved by 0.05 x N(0, 1) noise. Both packages take
    them (`jnp.asarray`, `convert.model_params_from_numpy`); no JAX program
    is compiled to make them."""
    r = np.random.default_rng(seed)

    def create(shape, axes=None, fan_in=None, mode="normal"):
        if mode == "normal":
            x = r.standard_normal(shape) * (0.02 if fan_in is None else fan_in**-0.5)
        else:
            x = (1.0 if mode == "ones" else 0.0) + 0.05 * r.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32))

    return jax.tree.map(lambda t: t.numpy(), T.init_params(cfg, create))


def _models(arch, seed=0, **overrides):
    """repro's model and parameters, and the port's with the same parameters
    carried across."""
    cfg = reduced(get_config(arch), **overrides)
    tree = numpy_params(cfg, seed)
    jm = JModel(j_reduced(j_get_config(arch), **overrides))
    m = Model(cfg, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, tree), m,
            convert.model_params_from_numpy(cfg, tree, "cpu"))


# ----------------------------------------------------------------------------
# the RG-LRU block
# ----------------------------------------------------------------------------


def _rglru_case(width, S, seed, carried: bool):
    """One block's prefill, from zero or from a carried state, then a decode
    step from the state it leaves."""
    cfg = dataclasses.replace(
        j_reduced(j_get_config("recurrentgemma-9b")),
        rglru=dataclasses.replace(j_get_config("recurrentgemma-9b").rglru, lru_width=width))
    tree = numpy_params(dataclasses.replace(reduced(get_config("recurrentgemma-9b")),
                                            rglru=cfg.rglru), seed)["blocks"][0]["rglru"]
    p = {k: jnp.asarray(v[0]) for k, v in tree.items()}
    pt = {k: torch.from_numpy(v[0]) for k, v in tree.items()}
    r = np.random.default_rng(seed)
    u = r.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    u1 = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = j_rglru.RGLRUState(
        jnp.asarray(r.standard_normal((2, width)).astype(np.float32)),
        jnp.asarray(r.standard_normal((2, 3, width)).astype(np.float32))) if carried else None
    seq = jax.jit(lambda p, u, st: j_rglru.apply_rglru_seq(cfg, p, u, st))
    step = jax.jit(lambda p, u, st: j_rglru.apply_rglru_step(cfg, p, u, st))
    t_state = None if state is None else rglru.RGLRUState(
        *(torch.from_numpy(np.array(x)) for x in state))
    want, w_st = seq(p, jnp.asarray(u), state)
    got, g_st = rglru.apply_rglru_seq(cfg, pt, torch.from_numpy(u), t_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(g_st, w_st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # a decode step from the state the prefill left
    want, w_st = step(p, jnp.asarray(u1), w_st)
    got, g_st = rglru.apply_rglru_step(cfg, pt, torch.from_numpy(u1), g_st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(g_st, w_st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert g_st.h.dtype == torch.float32


def test_rglru_matches_jax():
    """apply_rglru_seq and apply_rglru_step at the reduced width 64 from zero
    state and at a 256-wide block from a carried state (prompts of 37 and
    70: the doubling scan's last step covers part of the sequence); the
    scan against a time loop."""
    _rglru_case(64, 37, 0, carried=False)
    _rglru_case(256, 70, 1, carried=True)
    r = np.random.default_rng(2)
    a = torch.from_numpy(r.uniform(0.5, 1.0, (2, 13, 5)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((2, 13, 5)).astype(np.float32))
    h, loop = torch.zeros(2, 5), []
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(rglru.linear_scan(a, b).numpy(), torch.stack(loop, 1).numpy(),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------------
# the model on the ring
# ----------------------------------------------------------------------------


def _check_cache(got, want, tol):
    """Every leaf of the port's cache against repro's: shape and dtype equal,
    values within `tol` (bf16 compared in float32)."""
    w_leaves = [np.asarray(x) for x in jax.tree.leaves(want)]
    g_leaves = list(_torch_leaves(got))
    assert len(g_leaves) == len(w_leaves)
    for w, g in zip(w_leaves, g_leaves):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), \
            (g.shape, w.shape, g.dtype, w.dtype)
        g, w = (g.float().numpy(), w.astype(np.float32)) if g.dtype == torch.bfloat16 \
            else (g.numpy(), w)
        np.testing.assert_allclose(g, w, **tol)


def _torch_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):  # jax.tree.leaves orders dict keys so
            yield from _torch_leaves(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _torch_leaves(v)
    else:
        yield tree


def _ring_case(arch, *, cache_len, S=40, steps=8, **overrides):
    """Prefill and `steps` decode steps on both packages' rings; with the
    port's models, to check the bf16 prefill cache on."""
    jm, jp, m, p = _models(arch, **overrides)
    jb = j_get_backend("reference")
    prefill = jax.jit(lambda params, toks: jm.prefill(params, {"tokens": toks},
                                                      cache_len=cache_len, backend=jb))
    decode = jax.jit(lambda params, c, toks: jm.decode_step(params, c, {"tokens": toks},
                                                            backend=jb))
    r = np.random.default_rng(5)
    toks = r.integers(0, 256, (2, S)).astype(np.int32)
    want, jc = prefill(jp, jnp.asarray(toks))
    got, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, cache_len=cache_len,
                        backend="cuda")  # the wrappers' plain versions on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(tc, jc, TOL)
    for _ in range(steps):
        nt = r.integers(0, 256, (2, 1)).astype(np.int32)
        want, jc = decode(jp, jc, jnp.asarray(nt))
        got, tc = m.decode_step(p, tc, {"tokens": torch.from_numpy(nt)}, backend="cuda")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(tc, jc, TOL)
    assert int(tc["pos"]) == S + steps
    return tc, (jm, jp, m, p, toks)


def test_ring_model_matches_jax():
    """Ring prefill and 8 decode steps against repro's (see the module note);
    the CPU wrappers count no launch. kv_dtype bf16: the prefill's cache is
    bf16, as repro's (the paged engine commits the prompt's K/V from it)."""
    before = dict(LAUNCHES)
    tc, _ = _ring_case("recurrentgemma-9b", cache_len=64, n_layers=5)
    assert [set(c) for c in tc["blocks"]] == [{"rg"}, {"rg"}, {"kv"}]
    assert tc["blocks"][2]["kv"].capacity == 32  # the local block's ring: the window
    assert [set(t) for t in tc["tail"]] == [{"rg"}, {"rg"}]
    tc, (jm, jp, m, p, toks) = _ring_case("olmo-1b", cache_len=44)
    assert tc["blocks"][0]["kv"].capacity == 44
    jm.kv_dtype, m.kv_dtype = jnp.bfloat16, torch.bfloat16
    _, jc = jax.jit(lambda params, t: jm.prefill(params, {"tokens": t}, backend=j_get_backend(
        "reference")))(jp, jnp.asarray(toks))
    _, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, backend="reference")
    assert tc["blocks"][0]["kv"].k.dtype == torch.bfloat16
    _check_cache(tc, jc, BF16_TOL)
    assert LAUNCHES == before


# ----------------------------------------------------------------------------
# the engine on the ring
# ----------------------------------------------------------------------------

LENGTHS = (40, 36, 20)  # a wave of two past the window of 32, then a join
MAX_NEW = (4, 9, 5)


def test_ring_engine_matches_jax():
    """ServeEngine at reduced(recurrentgemma-9b), cache "auto": both packages
    resolve to the ring; the same finish order, tokens, entry widths and
    prefill widths, logits within the float tolerance; the joining request
    entered at the position the batch had reached."""
    jm, jp, m, p = _models("recurrentgemma-9b", seed=1)
    r = np.random.default_rng(11)
    prompts = [r.integers(0, 256, n).astype(np.int32) for n in LENGTHS]
    ecfg = dict(batch_size=2, max_len=96, trace_logits=True)
    j_eng = j_engine.ServeEngine(jm, jp, backend=j_get_backend("reference"),
                                 config=j_engine.ServeConfig(**ecfg))
    t_eng = ServeEngine(m, p, backend="reference", device="cpu", config=ServeConfig(**ecfg))
    assert j_eng.cache_mode == t_eng.cache_mode == "ring"
    done = {}
    for name, eng, make in (("jax", j_eng, j_engine.Request), ("port", t_eng, Request)):
        done[name] = eng.run([make(uid=i, prompt=q, max_new=n)
                              for i, (q, n) in enumerate(zip(prompts, MAX_NEW))])
    assert [q.uid for q in done["port"]] == [q.uid for q in done["jax"]] == [0, 2, 1]
    for j, t in zip(done["jax"], done["port"]):
        assert (t.uid, t.out, t.entry_width, t.done) == (j.uid, j.out, j.entry_width, j.done)
        assert len(t.logits) == len(t.out) == MAX_NEW[t.uid]
        np.testing.assert_allclose(np.stack(t.logits), np.stack(j.logits), **TOL)
    assert t_eng.prefill_widths == j_eng.prefill_widths == {40, 43}  # the join at 40 + 3
    for pkg_engine, make_cfg in ((j_engine.ServeEngine, j_engine.ServeConfig),
                                 (ServeEngine, ServeConfig)):
        kw = {} if pkg_engine is j_engine.ServeEngine else {"device": "cpu"}
        with pytest.raises(ValueError, match="cache='paged' unsupported"):
            pkg_engine(jm if not kw else m, jp if not kw else p,
                       config=make_cfg(cache="paged"), **kw)
