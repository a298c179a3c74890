"""phi3-mini-3.8b — dense MHA transformer (RoPE, SwiGLU).

[arXiv:2404.14219; unverified] 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064; head dim 96. The same configuration as
``repro/configs/phi3_mini_3_8b.py``.
"""

from repro_torch.configs.base import ModelConfig, register, register_smoke


@register
def phi3_mini_3_8b() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
    )


@register_smoke("phi3-mini-3.8b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        linear_chunk=16,
    )
