"""Mixtral 8x22B — 56L, d_model 6144, 48H (GQA kv=8, head_dim 128),
8 experts top-2 (per-expert d_ff 16384), sliding-window attention.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("mixtral-8x22b")
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,  # per-expert
        vocab_size=32768,
        attn_kind="sliding",
        sliding_window=4096,
        rope_theta=1_000_000.0,
        block_pattern=("attn_moe",),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, parallelism="tp"),
        source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B",
    )
