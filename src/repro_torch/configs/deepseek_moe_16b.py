"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf] 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6. All 28 layers are MoE per the assignment
line (the real checkpoint's dense layer 0 is not modelled — the
assignment config is the contract).
The same configuration as ``repro/configs/deepseek_moe_16b.py``.
"""

from repro_torch.configs.base import (ModelConfig, MoEConfig, register,
                                      register_smoke)


@register
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    )


@register_smoke("deepseek-moe-16b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=2),
        linear_chunk=16,
    )
