"""Qwen2 72B — 80L, d_model 8192, 64H (GQA kv=8, head_dim 128), d_ff 29568,
vocab 152064; GQA with QKV bias. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-72b")
def qwen2_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152_064,
        attn_kind="full",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        block_pattern=("attn",),
        source="arXiv:2407.10671; hf:Qwen/Qwen2-72B",
    )
