"""internlm2-20b — dense GQA transformer.

[arXiv:2403.17297; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. The same configuration as ``repro/configs/internlm2_20b.py``.
"""

from repro_torch.configs.base import ModelConfig, register, register_smoke


@register
def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92544,
        rope_theta=1_000_000.0,
    )


@register_smoke("internlm2-20b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke",
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
