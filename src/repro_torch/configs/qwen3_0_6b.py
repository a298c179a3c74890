"""qwen3-0.6b — small dense GQA transformer with qk_norm.

[hf:Qwen/Qwen3-8B; hf] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936. Qwen3 convention: head_dim 128, tied embeddings.
The same configuration as ``repro/configs/qwen3_0_6b.py``.
"""

from repro_torch.configs.base import ModelConfig, register, register_smoke


@register
def qwen3_0_6b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


@register_smoke("qwen3-0.6b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        qk_norm=True,
        tie_embeddings=True,
        linear_chunk=16,
    )
