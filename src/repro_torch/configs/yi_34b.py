"""yi-34b — dense llama-architecture GQA transformer.

[arXiv:2403.04652; hf] 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000. The same configuration as ``repro/configs/yi_34b.py``.
"""

from repro_torch.configs.base import ModelConfig, register, register_smoke


@register
def yi_34b() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5_000_000.0,
    )


@register_smoke("yi-34b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=256,
        linear_chunk=16,
    )
