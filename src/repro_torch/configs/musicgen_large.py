"""musicgen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048. The EnCodec audio frontend is a stub: token ids are the
codebook ids. LayerNorm + GELU, as MusicGen's (AudioCraft) decoder;
positions by RoPE, the framework's one positional scheme, where MusicGen
has sinusoidal embeddings. The same configuration as
``repro/configs/musicgen_large.py``.
"""

from repro_torch.configs.base import ModelConfig, register, register_smoke


@register
def musicgen_large() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        norm="layernorm",
        act="gelu",
    )


@register_smoke("musicgen-large")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        norm="layernorm",
        act="gelu",
        linear_chunk=16,
    )
