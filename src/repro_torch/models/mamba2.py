"""Mamba-2 (SSD) block (port of ``repro/models/mamba2.py``): the paper's
gated update with a scalar decay per head.

The SSD recurrence S_t = exp(−Δ_t·a_h)·S_{t−1} + B_t (Δ_t x_t)ᵀ,
y_t = S_tᵀ C_t is the paper's eq. 4 with α_t = exp(g_t) one number a
head, so it runs on the gated family's machinery:

    q = C (broadcast over heads),  k = B (broadcast),  v = Δ·x,
    log-decay g = −Δ_t·exp(A_log_h)  (B, H, T, 1), one per head.

Block (n_groups = 1): in_proj → [z | x | B | C | Δ] → causal depthwise
conv on [x|B|C] → SiLU → SSD → + D·x skip → RMSNorm gated by SiLU(z) →
out_proj.

Prefill (``want_state``) runs ``ssd_attention``: on a CUDA tensor one
launch of B8's inclusive route a layer, every head at once, with its
final state; on the CPU its plain version. Both clamp g at
``MIN_LOG_DECAY`` (−1) as JAX's ``chunked_gla`` does. The decays reach
−16·softplus(Δ) a token, so most heads sit at the clamp: in a chunk of
128 tokens k·e^(−b) passes fp32's range and JAX's prefill at the full
config's chunk is NaN (the gated RMSNorm then spreads one bad head over
every column). The plain version therefore runs in chunks of at most
``PREFILL_CHUNK`` (64), as RWKV-6's does, and prompts of the smoke
config take JAX's chunk. The kernel rescales within its own 64-token
tiles whatever the chunk. ``ssd_attention`` is forward-only: on a CUDA
tensor that needs a gradient the prefill raises rather than return an
output with no gradient.

Training (no state) runs ``gated_linear_attention``: B8 forward and B9's
recompute backward on the card, the plain versions on the CPU, at the
prefill's chunk, min(``linear_chunk``, ``PREFILL_CHUNK``): JAX's chunk of
128 is non-finite in training as in prefill at the full config's
decays, and the smoke config's 16 is JAX's. Decode is ``gated_decode_step`` in plain PyTorch, as JAX's jnp
decode, with g unclamped (JAX's asymmetry, kept). The decode state
(``MambaState``: the conv window of the last K−1 inputs and the
(H, d_state, head_dim) SSD matrices) is updated in place, inactive slots
bit for bit.

Under ``rules`` on a mesh (JAX ``mamba2.py:131-149``) the conv input is
constrained to ``conv_dim`` and q, k, v to ``heads_lin``; the SSD call
(B8 with or without its state, or B8/B9) runs on each rank's heads under
``sharding.kernel_site``, and the heads are gathered again before the
gated RMSNorm over d_inner. The decode state is split as
``mamba_state_specs`` says: the conv window on ``conv_dim``, the SSD
matrices on their heads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gated import gated_decode_step, gated_linear_attention
from repro_torch.kernels.gated_linear_attention.ops import ssd_attention
from repro_torch.models import layers as L
from repro_torch.sharding import Rules, constrain, kernel_site, whole_dims

Tensor = torch.Tensor
Params = Dict[str, Tensor]

PREFILL_CHUNK = 64
NULL = Rules.null()
# the logical names of a per-head SSD operand (B, H, T, D) on a mesh: the
# divisibility-checked heads, since each rank's block must be whole
SSD = ("batch", "heads", None, None)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, SSD heads, conv channels = x | B | C)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, d_inner + 2 * s.d_state


def mamba2_params(gen: torch.Generator, cfg: ModelConfig, *,
                  lead: Tuple[int, ...] = (), dtype=torch.float32) -> Params:
    """JAX's ``mamba2_params`` tree with a leading ``lead`` shape, drawn
    from ``gen`` (other numbers than JAX's: tests convert JAX's). The
    decay logits ``a_log``, ``dt_bias`` and ``d_skip`` are fp32."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    dev = gen.device

    def per_head(x):
        return x.expand(*lead, n_heads).clone()

    conv_w = torch.randn((*lead, s.conv_kernel, conv_dim), generator=gen,
                         device=dev) * 0.1
    return {
        "in_proj": L.dense_init(gen, d, 2 * d_inner + 2 * s.d_state + n_heads,
                                lead=lead, dtype=dtype),
        "conv_w": conv_w.to(dtype),
        "dt_bias": per_head(torch.zeros(n_heads, device=dev)),
        "a_log": per_head(torch.log(torch.linspace(
            1.0, 16.0, n_heads, dtype=torch.float32, device=dev))),
        "d_skip": per_head(torch.ones(n_heads, device=dev)),
        "norm_scale": torch.ones((*lead, d_inner), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, d_inner, d, lead=lead, dtype=dtype),
    }


def mamba2_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical sharding names, the tree of ``mamba2_params``."""
    return {
        "in_proj": ("fsdp", "d_inner"),   # uneven tail (B,C,dt) replicated
        "conv_w": (None, "conv_dim"),
        "dt_bias": (None,),
        "a_log": (None,),
        "d_skip": (None,),
        "norm_scale": ("d_inner",),
        "out_proj": ("d_inner", "fsdp"),
    }


class MambaState(NamedTuple):
    """Decode state: the conv window and the paper's fixed-size SSD
    state, O(1) in context length."""
    conv: Tensor    # (..., B, K-1, conv_dim) in cfg.dtype
    ssd: Tensor     # (..., B, H, d_state, head_dim) fp32


def init_mamba_state(cfg: ModelConfig, batch: int, *,
                     lead: Tuple[int, ...] = (), device=None) -> MambaState:
    s = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    return MambaState(
        conv=torch.zeros((*lead, batch, s.conv_kernel - 1, conv_dim),
                         dtype=getattr(torch, cfg.dtype), device=device),
        ssd=torch.zeros((*lead, batch, n_heads, s.d_state, s.head_dim),
                        dtype=torch.float32, device=device))


def mamba_state_specs(cfg: ModelConfig) -> "MambaState":
    """Logical sharding names of the decode state (the divisibility-checked
    ``heads``, not the uneven one: a state's layout must divide)."""
    return MambaState(conv=("batch", None, "conv_dim"),
                      ssd=("batch", "heads", None, None))


def _split_proj(proj: Tensor, cfg: ModelConfig
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """in_proj's output → (z, x | B | C, Δ before its softplus)."""
    d_inner, n_heads, conv_dim = _dims(cfg)
    return torch.split(proj, [d_inner, conv_dim, n_heads], dim=-1)


def _ssd_inputs(xbc: Tensor, dt_raw: Tensor, p: Params, cfg: ModelConfig):
    """xbc: (B, T, conv_dim) after the conv; dt_raw: (B, T, H). Returns
    q, k (B, H, T, d_state) broadcast views of C and B; v = Δ·x and the
    heads of x, (B, H, T, head_dim); g (B, H, T, 1) fp32."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    b, t, _ = xbc.shape
    x, bmat, cmat = torch.split(xbc, [d_inner, s.d_state, s.d_state],
                                dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])              # (B, T, H)
    g = (dt * -torch.exp(p["a_log"])).transpose(1, 2)[..., None]
    xh = x.reshape(b, t, n_heads, s.head_dim).transpose(1, 2)
    v = xh * dt.transpose(1, 2)[..., None].to(xh.dtype)
    k = bmat[:, None].expand(b, n_heads, t, s.d_state)
    q = cmat[:, None].expand(b, n_heads, t, s.d_state)
    return q, k, v, g, xh


def _gated_out(p: Params, y: Tensor, xh: Tensor, z: Tensor) -> Tensor:
    """+ D·x skip, the heads merged, RMSNorm gated by SiLU(z), out_proj.
    y, xh: (B, H, T, head_dim); z: (B, T, d_inner)."""
    b, h, t, n = y.shape
    y = y + p["d_skip"][None, :, None, None].to(y.dtype) * xh
    y = whole_dims(y, 1).transpose(1, 2).reshape(b, t, h * n)
    y = L.rmsnorm({"scale": p["norm_scale"]}, y) * F.silu(z)
    return y @ p["out_proj"].to(y.dtype)


def mamba2_apply(p: Params, x: Tensor, cfg: ModelConfig, *,
                 want_state: bool = False, kernel: bool = True,
                 rules: Rules = NULL
                 ) -> Tuple[Tensor, Optional[MambaState]]:
    """Full-sequence Mamba-2, x: (B, T, D) → (B, T, D), and with
    ``want_state`` the decode state after the last position.
    ``kernel=False`` runs the plain versions on a CUDA tensor.
    ``rules``: on a mesh the SSD runs on each rank's heads and the state
    comes back placed by ``mamba_state_specs``."""
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc = constrain(xbc, rules, "batch", None, "conv_dim")
    xbc_conv, conv_cache = L.causal_conv1d(xbc, p["conv_w"])
    q, k, v, g, xh = _ssd_inputs(F.silu(xbc_conv), dt_raw, p, cfg)
    q, k, v = (constrain(a, rules, "batch", "heads_lin", None, None)
               for a in (q, k, v))
    chunk = min(cfg.linear_chunk, PREFILL_CHUNK)
    if want_state:
        if kernel and x.is_cuda and torch.is_grad_enabled() and any(
                a.requires_grad for a in (q, k, v, g)):
            raise NotImplementedError(
                f"{cfg.name}: the Mamba-2 prefill (B8's inclusive route "
                f"with its state) is forward-only; train through "
                f"lm_loss, whose SSD runs B8/B9")
        y, s_f = kernel_site(
            lambda *a: ssd_attention(*a, chunk=chunk, kernel=kernel),
            rules, (q, k, v, g), (SSD,) * 4, (SSD, SSD))
    else:
        y = kernel_site(
            lambda *a: gated_linear_attention(*a, chunk_size=chunk,
                                              kernel=kernel),
            rules, (q, k, v, g), (SSD,) * 4, (SSD,))
    out = _gated_out(p, y, xh, z)
    if not want_state:
        return out, None
    return out, MambaState(
        conv=constrain(conv_cache.contiguous(), rules, "batch", None,
                       "conv_dim"), ssd=s_f)


def mamba2_decode(p: Params, x: Tensor, state: MambaState, cfg: ModelConfig,
                  *, active: Optional[Tensor] = None, rules: Rules = NULL
                  ) -> Tuple[Tensor, MambaState]:
    """One decode step, x (B, D): O(d_state·head_dim) a head, no conv or
    attention over the history. The state is updated in place; with
    ``active`` (B,) bool only the active rows (JAX's per-row select), the
    others bit for bit. ``rules``: on a mesh the state is placed by
    ``mamba_state_specs`` and each rank updates its own block."""
    proj = x[:, None, :] @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc = constrain(xbc, rules, "batch", None, "conv_dim")
    xx = torch.cat([state.conv.to(x.dtype), xbc], dim=1)     # (B, K, conv)
    y_conv = torch.einsum("bkc,kc->bc", xx, p["conv_w"].to(x.dtype))
    q, k, v, g, xh = _ssd_inputs(F.silu(y_conv)[:, None], dt_raw, p, cfg)
    # on a mesh each rank steps its own heads (the SSD state's split)
    o, ssd = kernel_site(gated_decode_step, rules,
                         (state.ssd, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                          g[:, :, 0]), (SSD,) + (SSD[:3],) * 4,
                         (SSD[:3], SSD))
    out = _gated_out(p, o[:, :, None], xh, z)[:, 0]
    for dst, src, names in zip(state, (xx[:, 1:], ssd),
                               mamba_state_specs(cfg)):
        src = constrain(src, rules, *names)
        if active is not None:
            src = torch.where(active.reshape(-1, *[1] * (src.ndim - 1)),
                              src.to(dst.dtype), dst)
        dst.copy_(src)
    return out, state
