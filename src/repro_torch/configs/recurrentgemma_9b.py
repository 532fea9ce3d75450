"""RecurrentGemma 9B (Griffin) — 38L, d_model 4096, 16H (MQA kv=1,
head_dim 256), d_ff 12288; RG-LRU recurrent blocks + local attention in a
2:1 pattern (two recurrent blocks then one local-attention block).
[arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        attn_kind="sliding",  # local attention window
        sliding_window=2048,
        mlp_kind="swiglu",
        block_pattern=("rglru", "rglru", "local"),
        rglru=RGLRUConfig(lru_width=4096, conv_width=4),
        tie_embeddings=True,
        source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
    )
