"""Qwen3-MoE 30B-A3B — 48L, d_model 2048, 32H (GQA kv=4, head_dim 128),
128 experts top-8 (per-expert d_ff 768), full attention.
[hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe_30b_a3b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,  # per-expert
        vocab_size=151_936,
        attn_kind="full",
        rope_theta=1_000_000.0,
        block_pattern=("attn_moe",),
        # 128 experts % 16 == 0 -> true expert parallelism over the model axis
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, parallelism="ep"),
        source="hf:Qwen/Qwen3-30B-A3B",
    )
