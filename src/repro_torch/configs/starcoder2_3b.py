"""StarCoder2 3B — 30L, d_model 3072, 24H (GQA kv=2, head_dim 128),
d_ff 12288, vocab 49152; GQA + RoPE + sliding-window (4096) attention.
[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-3b")
def starcoder2_3b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49_152,
        attn_kind="sliding",
        sliding_window=4096,
        qkv_bias=True,
        norm_kind="layernorm",
        mlp_kind="gelu",
        rope_theta=100_000.0,
        block_pattern=("attn",),
        source="arXiv:2402.19173; hf:bigcode/starcoder2-3b",
    )
