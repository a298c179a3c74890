"""rwkv6-1.6b "Finch" — attention-free, data-dependent per-channel decay.

[arXiv:2404.05892; unverified] 24L d_model=2048 (attn-free) d_ff=7168
vocab=65536; 32 heads of 64. The same configuration as
``repro/configs/rwkv6_1_6b.py``: RWKV-6's time-mix is the paper's eq. 4
with data-dependent per-channel decay plus the bonus u; there is no
attention layer, so ``--backend`` does not apply (``attention_backend``
is recorded as ``gated_linear``, as in JAX).
"""

from repro_torch.configs.base import (ModelConfig, RWKVConfig, register,
                                      register_smoke)


@register
def rwkv6_1_6b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        layer_pattern=("rwkv",),
        attention_backend="gated_linear",
        rope=False,
        norm="layernorm",
        rwkv=RWKVConfig(head_dim=64),
    )


@register_smoke("rwkv6-1.6b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        layer_pattern=("rwkv",),
        attention_backend="gated_linear",
        rope=False,
        norm="layernorm",
        rwkv=RWKVConfig(head_dim=16),
        linear_chunk=16,
    )
