"""llama-3.2-vision-90b — dense GQA decoder with cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256.

100 layers = 80 self-attention + 20 cross-attention (every 5th layer
attends to the image memory), pattern unit = 4×attn + 1×cross ×20.
The ViT frontend is a stub: the caller passes precomputed patch
embeddings (B, 6404, d_model) as the memory.

Cross-attention is the paper's document/query setting verbatim: under the
``linear`` backend the image tokens are encoded ONCE into a fixed-size
C = KᵀV per layer and every text position does an O(k²) lookup.
The same configuration as ``repro/configs/llama3_2_vision_90b.py``.
"""

from repro_torch.configs.base import ModelConfig, register, register_smoke


@register
def llama3_2_vision_90b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        layer_pattern=("attn",) * 4 + ("cross",),
        n_repeats=20,
        rope_theta=500_000.0,
        n_img_tokens=6404,
    )


@register_smoke("llama-3.2-vision-90b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        family="vlm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        layer_pattern=("attn", "cross"),
        n_repeats=2,
        n_img_tokens=24,
        linear_chunk=16,
    )
