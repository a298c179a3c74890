"""zamba2-7b — hybrid Mamba-2 + shared attention blocks.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64. The same configuration as
``repro/configs/zamba2_7b.py``: every 6th layer is the *shared*
attention block (one parameter set applied at 13 sites, each site with
its own decode state); the other 68 are Mamba-2 blocks. Pattern unit =
5 × mamba + 1 × shared_attn, 13 repeats, a tail of 3 mamba (5·13 + 13 +
3 = 81). Mamba-2: expand 2 → d_inner 7,168, SSD head dim 64 → 112 SSD
heads of d_state 64; the attention's head dim is 112 (3,584 / 32).

The Mamba-2 SSD core is the paper's eq. 4 update with a per-head scalar
decay: its prefill runs on the gated chunked kernel (B8), its decode is
``gated_decode_step``. ``attention_backend`` (softmax unless ``--backend``
says otherwise) applies to the shared attention blocks only.
"""

from repro_torch.configs.base import (ModelConfig, SSMConfig, register,
                                      register_smoke)


@register
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        layer_pattern=("mamba",) * 5 + ("shared_attn",),
        n_repeats=13,
        tail=("mamba",) * 3,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4),
    )


@register_smoke("zamba2-7b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        n_layers=9,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        layer_pattern=("mamba", "mamba", "shared_attn"),
        n_repeats=2,
        tail=("mamba", "mamba", "mamba"),
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4),
        linear_chunk=16,
    )
