"""The port's paged serving engine against the JAX package's, on the CPU.

One request list goes through `repro`'s `ServeEngine(backend="reference")`
and the port's `ServeEngine(backend="reference", device="cpu")`, both with
`trace_logits`, on `repro`'s parameters carried across: more requests than
slots, prompt buckets of 16 to 256 (across the 128 class boundary), a
shared page-aligned prefix on half of them; then a second wave on the warm
pool. Two cases: MHA on a shrunk pool, and GQA with a prefix cap, so that
both ways of evicting the prefix index run. Both must give equal tokens, finish order, entry widths and
prefix-sharing counters, and logits within float32 tolerance
(|port - repro| <= 1e-5 + 1e-4 |repro|: sums in another order over 2
layers). The checks run as two test items on purpose; see the note in
tests/test_torch_attention.py.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as j_serve
import repro.serving.engine as j_engine
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.backend import get_backend as j_get_backend
from repro.models import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serving import engine
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """Release the JAX executables this module compiled when it is done: XLA
    keeps each in memory maps of its own, and a test worker that runs many
    JAX tests can exhaust the kernel's per-process map limit."""
    yield
    jax.clear_caches()
COUNTERS = ("prompt_tokens", "prefill_tokens", "prefix_hit_tokens", "prefix_hits", "cow_copies",
            "decode_rounds", "slot_rounds", "prefix_evictions")
LENGTHS = (28, 40, 130, 150, 30, 45, 33, 12)  # buckets 32, 64, 256, 256, 32, 64, 64, 16
SHARED = 24  # a 3-page prefix on the even-numbered requests
CASES = {
    # model overrides, engine config
    # a pool of 29 usable pages: admissions evict index chains (newest first)
    "mha_pool_pressure": ({}, dict(batch_size=3, max_len=160, num_pages=30)),
    # past 32 index entries, least recently used prefixes are retired
    "gqa_prefix_cap": (dict(n_kv_heads=2), dict(batch_size=3, max_len=160, prefix_cap=32)),
}


def _prompts(seed=1):
    r = np.random.default_rng(seed)
    shared = r.integers(0, 256, SHARED)
    out = []
    for i, L in enumerate(LENGTHS):
        p = r.integers(0, 256, L)
        if i % 2 == 0:
            p[:SHARED] = shared
        out.append(p.astype(np.int32))
    return out


def _waves(make):
    """Wave 1: every prompt, budget 4 (5 for odd uids). Wave 2, on the warm
    pool: four wave-1 prompts again and one new, budget 3."""
    prompts = _prompts()
    wave1 = [make(uid=i, prompt=p, max_new=4 + i % 2) for i, p in enumerate(prompts)]
    new = np.random.default_rng(2).integers(0, 256, 19).astype(np.int32)
    wave2 = [make(uid=10 + i, prompt=p, max_new=3)
             for i, p in enumerate([prompts[0], prompts[3], prompts[5], new, prompts[7]])]
    return wave1, wave2


def _serve_both(case):
    """Both engines over both waves: {"jax"|"port": (wave1, stats1, wave2,
    stats2)}."""
    overrides, ecfg = CASES[case]
    jm = JModel(j_reduced(j_get_config("olmo-1b"), **overrides))
    jp = jm.init(jax.random.key(0))
    cfg = reduced(get_config("olmo-1b"), **overrides)
    m = Model(cfg, device="cpu")
    p = convert.model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    engines = {
        "jax": (j_engine.ServeEngine(jm, jp, backend=j_get_backend("reference"),
                                     config=j_engine.ServeConfig(trace_logits=True, **ecfg)),
                j_engine.Request),
        "port": (ServeEngine(m, p, backend="reference", device="cpu",
                             config=ServeConfig(trace_logits=True, **ecfg)), Request),
    }
    out = {}
    for name, (eng, make) in engines.items():
        wave1, wave2 = _waves(make)
        done1 = eng.run(wave1)
        stats1 = dict(eng.stats)
        done2 = eng.run(wave2)
        out[name] = (done1, stats1, done2, dict(eng.stats))
    return out


def test_engine_matches_jax():
    """For each of CASES, over both waves (the second on the warm pool): the
    same finish order, tokens and entry widths, logits within the
    tolerance, and repro's prefix-sharing and decode counters; the run
    exercises what they count: prefix hits in each wave and evictions (pool
    pressure, or the cap)."""
    for case in sorted(CASES):
        _check_engine(case)


def _check_engine(case):
    runs = _serve_both(case)
    for wave in (0, 2):
        done_j, done_t = runs["jax"][wave], runs["port"][wave]
        assert len(done_t) == len(done_j)
        for j, t in zip(done_j, done_t):
            assert (t.uid, t.out, t.entry_width, t.done) == (j.uid, j.out, j.entry_width,
                                                             j.done)
            assert len(t.logits) == len(t.out) == len(j.logits)
            np.testing.assert_allclose(np.stack(t.logits), np.stack(j.logits), **LOGIT_TOL)
    for wave in (1, 3):
        got, want = runs["port"][wave], runs["jax"][wave]
        assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
        assert set(got) == set(want)
        assert got["prefix_hits"] >= 1 and got["decode_rounds"] > 0
        assert got["prefix_evictions"] > 0


def _check_greedy_breaks_ties_at_the_lowest_index_as_jnp_argmax():
    logits = np.zeros((3, 1, 7), np.float32)
    logits[0, 0, [2, 5]] = 1.0
    logits[1, 0, [6, 0]] = -1.0
    logits[2, 0, [4, 1, 3]] = 2.0
    want = np.asarray(j_engine.greedy(jnp.asarray(logits)))
    got = engine.greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32 and got.shape == (3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 0].tolist() == [2, 1, 1]


def _check_bucket_len_matches_jax():
    for n in range(0, 300, 7):
        for lo in (1, 8, 16):
            assert engine.bucket_len(n, lo) == j_engine.bucket_len(n, lo)


def _fields(cls):
    return {f.name: (f.default, f.default_factory) for f in dataclasses.fields(cls)}


def _cli_defaults(parser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def _check_defaults_match_jax(monkeypatch):
    """ServeConfig, Request, ServeEngine and the serve CLI take repro's
    fields, parameters and defaults (`device` aside)."""
    assert _fields(ServeConfig) == _fields(j_engine.ServeConfig)
    assert _fields(Request) == _fields(j_engine.Request)
    got, want = (dict(inspect.signature(c).parameters) for c in (ServeEngine,
                                                                 j_engine.ServeEngine))
    assert got.pop("device").default is None
    assert {k: v.default for k, v in got.items()} == {k: v.default for k, v in want.items()}

    class Parsed(Exception):
        pass

    def capture(self, argv=None):
        raise Parsed(self)

    monkeypatch.setattr(j_serve.argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as got_jax:
        j_serve.main([])
    monkeypatch.undo()
    want = _cli_defaults(got_jax.value.args[0])
    got = _cli_defaults(serve.parser())
    assert got.pop("device") is None
    assert got == want


def _check_cli_runs_on_the_cpu_and_returns_the_summary():
    """The serve CLI with --device cpu on both backends: the same counters,
    and the summary dict has the keys repro's CLI returns; with --attn
    window:4 it retires pages, and with --prefill_chunk the same run gives the
    same counters."""
    argv = ["--requests", "3", "--batch", "2", "--prompt_len", "12", "--max_new", "3",
            "--prefix_len", "8", "--device", "cpu"]
    ref = serve.main(argv)
    kern = serve.main(argv + ["--backend", "cuda"])
    assert ref["requests"] == kern["requests"] == 3 and ref["tokens"] == 9
    assert ref["stats"] == kern["stats"] and ref["stats"]["prefix_hits"] == 2
    assert ref["cache"] == "paged"
    assert set(ref) == {"requests", "tokens", "wall_s", "backend", "cache", "prefix_hit_rate",
                        "stats", "prefill_chunk", "window"}
    windowed = serve.main(argv + ["--attn", "window:4"])
    chunked = serve.main(argv + ["--attn", "window:4", "--prefill_chunk", "4"])
    assert (windowed["window"], chunked["prefill_chunk"]) == (4, 4)
    assert windowed["tokens"] == chunked["tokens"] == 9
    assert windowed["stats"] == chunked["stats"] and windowed["stats"]["pages_retired"] > 0


def _tiny_model(**overrides):
    cfg = reduced(get_config("olmo-1b"), n_layers=1, **overrides)
    m = Model(cfg, device="cpu")
    return m, m.init(0)


NOT_PORTED = {
    "ring": lambda m, p: ServeEngine(m, p, device="cpu", config=ServeConfig(cache="ring")),
    "auto_on_recurrent": lambda m, p: ServeEngine(
        Model(dataclasses.replace(m.cfg, block_pattern=("rglru",)), device="cpu"), p,
        device="cpu"),
    "spec_k": lambda m, p: ServeEngine(m, p, device="cpu", config=ServeConfig(spec_k=2)),
    "int8": lambda m, p: (setattr(m, "kv_dtype", torch.int8), ServeEngine(m, p, device="cpu")),
    "ring_prefill_of_a_windowed_arch": lambda m, p: Model(
        dataclasses.replace(m.cfg, attn_kind="sliding", sliding_window=16),
        device="cpu").prefill(p, {"tokens": torch.zeros(1, 8, dtype=torch.int32)}),
    "arch": lambda m, p: get_config("recurrentgemma-9b"),
    "model_init_of_a_moe": lambda m, p: Model(
        ModelConfig("moe", "moe", 2, 64, 4, 4, 128, 256, block_pattern=("attn_moe",)),
        device="cpu").init(0),
}
# paths the port once raised for that now run: each serves a request
PORTED = {
    "prefill_chunk": lambda m, p: ServeEngine(m, p, device="cpu",
                                              config=ServeConfig(prefill_chunk=16)),
    "sliding_window": lambda m, p: ServeEngine(
        Model(dataclasses.replace(m.cfg, attn_kind="sliding", sliding_window=16),
              device="cpu"), p, device="cpu"),
}


def _check_not_yet_ported_options_raise():
    """Every path of NOT_PORTED, which the port does not have yet, raises
    NotImplementedError naming ROADMAP.md; none falls back to something
    else. Every path of PORTED serves a 40-token prompt."""
    for what in sorted(NOT_PORTED):
        m, p = _tiny_model()
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            NOT_PORTED[what](m, p)
    prompt = np.random.default_rng(0).integers(0, 256, 40).astype(np.int32)
    for what in sorted(PORTED):
        m, p = _tiny_model()
        eng = PORTED[what](m, p)
        done = eng.run([Request(uid=0, prompt=prompt, max_new=3)])
        assert len(done[0].out) == 3 and eng.stats["decode_rounds"] == 2


def _check_engine_needs_the_card_unless_asked_for_the_cpu():
    m, p = _tiny_model()
    if not torch.cuda.is_available():  # with a card, the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(m, p)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main([])
    with pytest.raises(ValueError, match="make the Model"):
        ServeEngine(m, p, device="meta")


def test_serving_surface_matches_jax(monkeypatch):
    """greedy's tie order, bucket_len, every default of ServeConfig, Request,
    ServeEngine and the serve CLI, the CLI's run and summary, the paths that
    must raise, and the device rule."""
    _check_greedy_breaks_ties_at_the_lowest_index_as_jnp_argmax()
    _check_bucket_len_matches_jax()
    _check_defaults_match_jax(monkeypatch)
    _check_cli_runs_on_the_cpu_and_returns_the_summary()
    _check_not_yet_ported_options_raise()
    _check_engine_needs_the_card_unless_asked_for_the_cpu()
