"""qwen3-moe-235b-a22b — 128 experts top-8, qk_norm GQA.

[hf:Qwen/Qwen3-30B-A3B; hf] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8. Qwen3 convention: head_dim 128 (decoupled
from d_model), qk RMS-norm, no shared experts.
The same configuration as ``repro/configs/qwen3_moe_235b_a22b.py``.
"""

from repro_torch.configs.base import (ModelConfig, MoEConfig, register,
                                      register_smoke)


@register
def qwen3_moe_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, n_shared=0),
    )


@register_smoke("qwen3-moe-235b-a22b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=0),
        linear_chunk=16,
    )
