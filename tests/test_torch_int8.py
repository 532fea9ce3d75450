"""The port's int8 KV caches and the ring's decode attention against the JAX
package, on the CPU.

Op level, on the same numpy inputs:

* decode attention over the ring: the port's plain `_decode_cell` program
  (`ops.decode_attention_ref`, and the kernel wrapper, which computes it for
  CPU tensors) against `repro.kernels.ops.decode_attention_ref`, at G 1 and
  4, with the ring unwrapped and wrapped (a window), and with a softcap;
  `ring_valid` at positions before, at and past the ring's capacity, with
  and without a window; `cache_update_decode` on a float and an int8 ring;
  the prefill's ring roll against token t at slot t % W;
* the int8 paged partials (`paged_attention_partials_quant_reference`, and
  the wrapper) and the int8 decode op against `repro`'s reference forms;
* the int8 writes: `quantize_kv`, `_quant_page_write` (a running-max scale
  that grows on some pages and not on others), `quant_paged_commit` (stacked
  over layers, with pad rows and a page of pad only) and
  `paged_reset_scales` against `repro`'s.

Tolerance: float32 outputs within |port - repro| <= 2e-6 + 1e-5 |repro|
(sums in another order than XLA's); scales within 1e-6 relative; int8 codes
equal or off by one where float noise puts a value on the other side of a
rounding boundary: at most 1 in 1,000 codes (these inputs give none of the
512 to 2,304 codes a check compares).

Engine level: `ServeEngine` at `reduced(olmo-1b)` with `kv_dtype` int8 on
the paged pools (more requests than slots, so freed pages are handed out
again and their scales reset) and on the ring (a wave and a join), each
against `repro`'s own run of the same mode: equal tokens, finish order,
entry widths and counters, logits within 1e-3 + 1e-3 |repro| (the int8
rounding above, carried through 2 layers). Neither mode is held against the
other, nor a join against a solo run: those contracts fail in `repro`
itself (ROADMAP.md queue 3). Both packages force prefix sharing off on
int8 pools and refuse `spec_k > 1` there with the same error.

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
from repro.kernels import ops as j_ops
from repro.kernels import paged_attention as j_paged
from repro.models import Model as JModel
from repro.models import attention as j_attn
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import LAUNCHES, ops, paged_attention
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models.attention import AttnSpec
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine
from test_torch_recurrent import numpy_params

OP_TOL = dict(rtol=1e-5, atol=2e-6)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
MAX_OFF_BY_ONE = 1e-3  # share of int8 codes that may round the other way


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """Release the JAX executables this module compiled when it is done: XLA
    keeps each in memory maps of its own, and a test worker that runs many
    JAX tests can exhaust the kernel's per-process map limit."""
    yield
    jax.clear_caches()


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _codes_close(got: torch.Tensor, want) -> None:
    """int8 codes equal, or one apart at no more than MAX_OFF_BY_ONE of them."""
    g, w = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    diff = np.abs(g - w)
    assert got.dtype == torch.int8 and diff.max() <= 1
    assert int((diff == 1).sum()) <= MAX_OFF_BY_ONE * diff.size, int((diff == 1).sum())


def _scales_close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


# ----------------------------------------------------------------------------
# ring decode attention
# ----------------------------------------------------------------------------


def _check_ring_ops():
    r = np.random.default_rng(0)
    j_decode = jax.jit(j_ops.decode_attention_ref, static_argnums=4)
    j_valid = jax.jit(j_attn.ring_valid, static_argnums=(1, 2))
    B, Hkv, D, W = 2, 2, 16, 24
    for G, window, softcap in ((1, 0, 0.0), (4, 10, 5.0)):
        spec, jspec = AttnSpec(True, window, softcap), j_attn.AttnSpec(True, window, softcap)
        q = r.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
        k = r.standard_normal((B, W, Hkv, D)).astype(np.float32)
        v = r.standard_normal((B, W, Hkv, D)).astype(np.float32)
        for pos in (13, 40):  # the ring unwrapped, then wrapped
            valid = np.asarray(j_valid(jnp.asarray(pos), W, jspec))
            got_valid = attn.ring_valid(torch.tensor(pos), W, spec)
            np.testing.assert_array_equal(got_valid.numpy(), valid)
            want = np.asarray(j_decode(*map(jnp.asarray, (q, k, v, valid)), jspec))
            before = dict(LAUNCHES)
            got = ops.decode_attention_ref(*_t(q, k, v, valid), spec).numpy()
            np.testing.assert_array_equal(ops.decode_attention(*_t(q, k, v, valid), spec).numpy(),
                                          got)
            assert LAUNCHES == before
            np.testing.assert_allclose(got, want, **OP_TOL)
    for pos in (0, 5, 23, 24, 31, 100):  # ring_valid without a window too
        for cap, window in ((24, 0), (8, 8), (24, 6)):
            spec = AttnSpec(True, window, 0.0)
            np.testing.assert_array_equal(
                attn.ring_valid(torch.tensor(pos), cap, spec).numpy(),
                np.asarray(j_valid(jnp.asarray(pos), cap, j_attn.AttnSpec(True, window, 0.0))))


def _check_ring_writes():
    """cache_update_decode on a float and an int8 ring, quantize_kv, and the
    prefill's roll, against repro."""
    r = np.random.default_rng(1)
    B, W, Hkv, D = 2, 8, 2, 16
    cfg = reduced(get_config("olmo-1b"), n_kv_heads=Hkv)
    x = r.standard_normal((B, 3 * W, Hkv, D)).astype(np.float32)
    xq, xs = attn.quantize_kv(torch.from_numpy(x))
    jq, js = j_attn.quantize_kv(jnp.asarray(x))
    _codes_close(xq, jq)
    _scales_close(xs, js)
    update = jax.jit(j_attn.cache_update_decode)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        cache = attn.init_kv_cache(cfg, B, W, dtype, "cpu")
        jcache = j_attn.init_kv_cache(cfg, B, W, jdtype)
        for pos in (3, 8, 13):  # in the ring, at its end, wrapped
            kn = r.standard_normal((B, 1, Hkv, D)).astype(np.float32)
            vn = r.standard_normal((B, 1, Hkv, D)).astype(np.float32)
            cache = attn.cache_update_decode(cache, *_t(kn, vn), torch.tensor(pos))
            jcache = update(jcache, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
        for got, want in zip(cache, jcache):
            if got.dtype == torch.int8:
                _codes_close(got, want)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the roll: after a prefill of S > W tokens, token t sits at slot t % W
    S = 2 * W + 3
    ring = attn.cache_write_prefill(attn.init_kv_cache(cfg, B, W, torch.float32, "cpu"),
                                    *_t(x[:, :S], x[:, :S]))
    for t in range(S - W, S):
        np.testing.assert_array_equal(ring.k[:, t % W].numpy(), x[:, t])


# ----------------------------------------------------------------------------
# int8 page pools
# ----------------------------------------------------------------------------


def _quant_pool(r, n_phys, P, Hkv, D, layers=0):
    lead = (layers,) if layers else ()
    codes = [r.integers(-127, 128, lead + (n_phys, P, Hkv, D)).astype(np.int8) for _ in range(2)]
    scales = [r.uniform(0.01, 0.05, lead + (n_phys, Hkv)).astype(np.float32) for _ in range(2)]
    return codes + scales


def _check_quant_partials():
    r = np.random.default_rng(2)
    B, Hkv, G, D, P, n_phys, n_table = 3, 2, 4, 16, 4, 12, 4
    kq, vq, ks, vs = _quant_pool(r, n_phys, P, Hkv, D)
    q = r.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    table = np.zeros((B, n_table), np.int32)
    table[0, :3], table[1, :4] = [5, 2, 9], [1, 3, 4, 11]  # slot 2 parked
    pos = np.array([9, 14, 0], np.int32)
    for window, softcap in ((0, 0.0), (6, 5.0)):
        spec, jspec = AttnSpec(True, window, softcap), j_attn.AttnSpec(True, window, softcap)
        want = j_paged.paged_attention_partials_quant_reference(
            *map(jnp.asarray, (q.reshape(B, Hkv, G, D), kq, vq, ks, vs, table, pos)),
            window=window, softcap=softcap)
        args = _t(q.reshape(B, Hkv, G, D), kq, vq, ks, vs, table, pos)
        before = dict(LAUNCHES)
        got = paged_attention.paged_attention_partials_quant_reference(
            *args, window=window, softcap=softcap)
        wrapped = paged_attention.paged_attention_partials_quant(*args, window=window,
                                                                 softcap=softcap)
        assert LAUNCHES == before
        for g, w, x in zip(got, want, wrapped):
            np.testing.assert_array_equal(x.numpy(), g.numpy())
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **OP_TOL)
        np.testing.assert_allclose(
            ops.quant_paged_decode_attention_ref(*_t(q, kq, vq, ks, vs, table, pos),
                                                 spec).numpy(),
            np.asarray(j_ops.quant_paged_decode_attention_ref(
                *map(jnp.asarray, (q, kq, vq, ks, vs, table, pos)), jspec)), **OP_TOL)


def _check_quant_writes():
    """_quant_page_write, quant_paged_commit and paged_reset_scales against
    repro's, on a pool with live codes and scales."""
    r = np.random.default_rng(3)
    Hkv, D, P, n_phys = 2, 16, 4, 10
    kq, _, ks, _ = _quant_pool(r, n_phys, P, Hkv, D)
    page_of = np.array([4, 7, 0, 0], np.int64)  # two slots and two parked on the trash page
    off = np.array([1, 3, 2, 2], np.int64)
    x = r.standard_normal((4, 1, Hkv, D)).astype(np.float32)
    x[0] *= 0.001  # this token leaves page 4's scale as it is: its codes stay exact
    pool_q, pool_s = _t(kq, ks)
    attn._quant_page_write(pool_q, pool_s, torch.from_numpy(x), torch.from_numpy(page_of),
                           torch.from_numpy(off))
    want_q, want_s = jax.jit(j_attn._quant_page_write)(
        *map(jnp.asarray, (kq, ks, x, page_of, off)))
    live = np.arange(n_phys) != 0  # the trash page's contents are nobody's
    _codes_close(pool_q[live], np.asarray(want_q)[live])
    _scales_close(pool_s[live], np.asarray(want_s)[live])
    # page 4's scale did not grow: its other codes are untouched
    np.testing.assert_array_equal(np.delete(pool_q[4].numpy(), 1, axis=0),
                                  np.delete(kq[4], 1, axis=0))
    # a commit of a 16-wide prefill of 9 real tokens into 4 pages, stacked
    # over 2 layers: page 3 holds pad only, page 2 one real token
    layers, W, length = 2, 16, 9
    kq2, vq2, ks2, vs2 = _quant_pool(r, n_phys, P, Hkv, D, layers)
    dense = r.standard_normal((layers, 1, W, Hkv, D)).astype(np.float32)
    dq, ds = j_attn.quantize_kv(jnp.asarray(dense))
    row = np.array([6, 2, 8, 5, 0], np.int32)
    pool = attn.QuantPagedKVCache(*_t(kq2, vq2, ks2, vs2))
    dense_t = attn.QuantKVCache(*_t(dq, dq, ds, ds))
    attn.quant_paged_commit(pool, dense_t, torch.from_numpy(row), length, W)
    jpool = jax.jit(j_attn.quant_paged_commit, static_argnums=4)(
        j_attn.QuantPagedKVCache(*map(jnp.asarray, (kq2, vq2, ks2, vs2))),
        j_attn.QuantKVCache(dq, dq, ds, ds), jnp.asarray(row), jnp.asarray(length), W)
    for got, want in zip(pool, jpool):
        got, want = got[:, live], np.asarray(want)[:, live]
        if got.dtype == torch.int8:
            _codes_close(got, want)
        else:
            _scales_close(got, want)
    ids = np.array([2, 8, 0], np.int32)
    attn.paged_reset_scales(pool, torch.from_numpy(ids))
    jpool = j_attn.paged_reset_scales(jpool, jnp.asarray(ids))
    for got, want in zip(pool[2:], jpool[2:]):
        assert not got[:, ids].any()
        _scales_close(got[:, live], np.asarray(want)[:, live])


def test_ring_and_int8_ops_match_jax():
    """Ring decode attention, ring writes, the int8 paged partials and the
    int8 writes against repro (see the module note), in one test item."""
    _check_ring_ops()
    _check_ring_writes()
    _check_quant_partials()
    _check_quant_writes()


# ----------------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------------

COUNTERS = ("prompt_tokens", "prefill_tokens", "prefix_hit_tokens", "prefix_hits", "cow_copies",
            "pages_retired", "decode_rounds", "slot_rounds", "prefix_evictions")
# the paged run takes requests 0, 1, 3 (buckets 64, 64, 16: request 3 takes
# the pages request 0 freed), the ring run 0, 1, 2 (a wave and a join)
LENGTHS = (40, 36, 20, 12)
MAX_NEW = (4, 9, 5, 3)


def test_int8_engines_match_jax():
    """Paged-int8 and ring-int8 ServeEngine runs at reduced(olmo-1b), each
    against repro's run of the same mode (see the module note)."""
    cfg = reduced(get_config("olmo-1b"))
    tree = numpy_params(cfg, 3)
    jm, m = JModel(j_reduced(j_get_config("olmo-1b"))), Model(cfg, device="cpu")
    jm.kv_dtype, m.kv_dtype = jnp.int8, torch.int8
    jp, p = jax.tree.map(jnp.asarray, tree), convert.model_params_from_numpy(cfg, tree, "cpu")
    r = np.random.default_rng(4)
    prompts = [r.integers(0, 256, n).astype(np.int32) for n in LENGTHS]
    for cache, uids in (("paged", (0, 1, 3)), ("ring", (0, 1, 2))):
        ecfg = dict(batch_size=2, max_len=64, cache=cache, trace_logits=True)
        j_eng = j_engine.ServeEngine(jm, jp, backend=j_get_backend("reference"),
                                     config=j_engine.ServeConfig(**ecfg))
        t_eng = ServeEngine(m, p, backend="reference", device="cpu", config=ServeConfig(**ecfg))
        assert t_eng.cache_mode == j_eng.cache_mode == cache
        done = {}
        for name, eng, make in (("jax", j_eng, j_engine.Request), ("port", t_eng, Request)):
            done[name] = eng.run([make(uid=i, prompt=prompts[i], max_new=MAX_NEW[i])
                                  for i in uids])
        assert [q.uid for q in done["port"]] == [q.uid for q in done["jax"]]
        for j, t in zip(done["jax"], done["port"]):
            assert (t.uid, t.out, t.entry_width, t.done) == (j.uid, j.out, j.entry_width, j.done)
            np.testing.assert_allclose(np.stack(t.logits), np.stack(j.logits), **LOGIT_TOL)
        assert t_eng.prefill_widths == j_eng.prefill_widths
        if cache == "paged":
            assert {k: t_eng.stats[k] for k in COUNTERS} == {k: j_eng.stats[k] for k in COUNTERS}
            assert t_eng.config.share_prefix is j_eng.config.share_prefix is False
    for eng_cls, make_cfg, model, params, kw in (
            (j_engine.ServeEngine, j_engine.ServeConfig, jm, jp, {}),
            (ServeEngine, ServeConfig, m, p, {"device": "cpu"})):
        with pytest.raises(ValueError, match="spec_k > 1 is unsupported with int8 KV pools"):
            eng_cls(model, params, config=make_cfg(spec_k=2), **kw)
