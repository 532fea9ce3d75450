"""The port's own copy of `repro.configs.base`: the architecture config, its
registry and `reduced` (the port imports nothing of `repro`), with the
MoE and RG-LRU sub-configs.

Only the architectures the port can run are registered. Asking `get_config`
for one `repro` registers but the port cannot run yet raises and names
`ROADMAP.md`, where the missing paths are queued.

Conventions (as in `repro`): `vocab_size` is the paper's vocabulary and
parameters use `padded_vocab` (the next multiple of 256); `block_pattern` is
the repeating unit of layer kinds, `("attn",)` for a uniform decoder.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Optional


@dataclass(frozen=True)
class MoEConfig:
    """`repro`'s mixture-of-experts config (every field and default)."""

    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # "tp": experts replicated over data, d_ff sharded over model.
    # "ep": expert dim sharded over model axis (requires n_experts % model == 0).
    # One card runs both alike; the field is kept so configs carry across.
    parallelism: str = "tp"


@dataclass(frozen=True)
class RGLRUConfig:
    """`repro`'s RG-LRU block config (RecurrentGemma's recurrent blocks)."""

    lru_width: int = 0  # 0 => d_model
    conv_width: int = 4
    block_width_divisor: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    # attention
    attn_kind: str = "full"  # full | sliding
    sliding_window: int = 0
    qkv_bias: bool = False
    rope_kind: str = "rope"  # rope | mrope | none | sinusoidal
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    # norms
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    mlp_kind: str = "swiglu"  # swiglu | gelu
    # layer pattern
    block_pattern: tuple = ("attn",)
    # mixtures / recurrences: MoEConfig, repro's SSMConfig (never set on the
    # archs the port registers) and RGLRUConfig
    moe: Optional[MoEConfig] = None
    ssm: Optional[object] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    tie_embeddings: bool = False
    # training-time knobs
    remat: bool = True
    # source provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / 256) * 256)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU tests (`repro`'s rule: 4 experts,
    top 2, expert d_ff 32 for a MoE; the RG-LRU width shrinks to 64; no arch
    the port registers has an SSM sub-config)."""
    updates: dict = dict(
        n_layers=max(2, len(cfg.block_pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_seq=16 if cfg.is_encoder_decoder else 0,
        remat=False,
    )
    if cfg.moe is not None:
        updates["moe"] = replace(cfg.moe, n_experts=4, top_k=2, d_ff=32)
    if cfg.rglru is not None:
        updates["rglru"] = replace(cfg.rglru, lru_width=64)
    updates.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **updates)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}

# archs `repro` registers that the port cannot run yet (ROADMAP.md queue 1,
# item 8: SSM, enc-dec, M-RoPE)
NOT_PORTED = ("mamba2-370m", "qwen2-vl-72b", "whisper-tiny")


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; see ROADMAP.md queue 1")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
