"""Granite 8B (code) — 36L, d_model 4096, 32H (GQA kv=8, head_dim 128),
d_ff 14336, vocab 49152; llama-style architecture. [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-8b")
def granite_8b() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49_152,
        attn_kind="full",
        rope_theta=10_000_000.0,
        block_pattern=("attn",),
        source="arXiv:2405.04324; hf:ibm-granite/granite-8b-code",
    )
