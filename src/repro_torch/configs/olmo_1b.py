"""OLMo 1B — 16L, d_model 2048, 16H (MHA kv=16, head_dim 128), d_ff 8192,
vocab 50304; non-parametric LayerNorm (no scale/bias). [arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("olmo-1b")
def olmo_1b() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50_304,
        attn_kind="full",
        norm_kind="nonparam_ln",
        mlp_kind="swiglu",
        tie_embeddings=True,
        block_pattern=("attn",),
        source="arXiv:2402.00838; hf:allenai/OLMo-1B",
    )
