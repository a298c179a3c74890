"""GQA attention (port of ``repro/models/attention.py``), three backends.

- ``softmax``: classic attention (paper §2), the baseline. Prefill runs
  causal flash attention over the flat heads, the B10 kernel for CUDA
  tensors (``models/xla_attention.py``, ``kernels/flash_attention``);
  the decode state is the KV cache, (B, S, Hkv, Dh) per layer in
  ``cfg.dtype``, read in plain PyTorch at O(pos) per token. Forward
  only: training under softmax raises.
- ``linear``: the paper's §3 mechanism; chunk-parallel causal linear
  attention for prefill, state (s, z) with the key-sum normaliser z
  under ``linear_normalize``.
- ``gated_linear``: the paper's §4 decay form, S ← diag(exp g) S + k vᵀ
  with a data-dependent log-decay g (``_decay``, per channel or per
  head); ``chunked_gla`` for prefill, the gated decode kernel after it,
  ``gated_linear_attention`` (B8/B9) for training, and a per-head
  groupnorm on the outputs. Its state has no z, whatever
  ``linear_normalize`` says.

The linear family's fixed-size (Dk×Dv per head) state advances by a
fused W-step recurrence, the CUDA kernels for CUDA tensors
(``kernels/fused_recurrent``).

Heads are laid out as in the JAX package: q projects to (G, Hkv, Dh)
with G = H / Hkv groups, the flat head index is g·Hkv + kv_head, and
k / v are broadcast over the G groups in that order, so states carried
over from JAX line up head for head. Sharding has no counterpart here;
with null rules head padding is the identity.

The decode functions update the state tensors in place and return them
(a softmax step writes its one cache row per sequence).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gated import chunked_gla, gated_linear_attention
from repro_torch.core.linear_attention import (
    causal_linear_attention, causal_linear_attention_chunked)
from repro_torch.kernels.fused_recurrent import ops as FR
from repro_torch.kernels.fused_recurrent import ref as FRref
from repro_torch.models import layers as L
from repro_torch.models import xla_attention as XA

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def _require_ported(cfg: ModelConfig) -> None:
    """The port serves softmax and the linear family, the latter without
    the feature gate (which JAX applies to the linear family only)."""
    backend = cfg.attention_backend
    if backend not in ("softmax", "linear", "gated_linear") or (
            cfg.feature_gate and backend != "softmax"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention_backend 'softmax', "
            f"'linear' or 'gated_linear', the last two without "
            f"feature_gate (got {backend!r}, "
            f"feature_gate={cfg.feature_gate})")


# ---------------------------------------------------------------------------
# feature maps
# ---------------------------------------------------------------------------

def feature_map(x: Tensor, kind: str) -> Tensor:
    """φ applied to q/k before the linear-attention inner product."""
    if kind == "identity":
        return x
    if kind == "elu1":
        return F.elu(x) + 1.0
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown feature map {kind!r}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attention_params(gen: torch.Generator, cfg: ModelConfig, *,
                     lead: Tuple[int, ...] = (),
                     dtype=torch.float32) -> Params:
    _require_ported(cfg)
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, d, h * dh, lead=lead, dtype=dtype),
        "wk": L.dense_init(gen, d, hkv * dh, lead=lead, dtype=dtype),
        "wv": L.dense_init(gen, d, hkv * dh, lead=lead, dtype=dtype),
        "wo": L.dense_init(gen, h * dh, d, lead=lead, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, dh), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((*lead, dh), dtype=dtype, device=gen.device)
    if cfg.attention_backend == "gated_linear":
        # decay projection (paper §4 α_t as a data-dependent gate)
        gd = dh if cfg.decay_mode == "vector" else 1
        p["w_gate"] = L.dense_init(gen, d, h * gd, lead=lead, dtype=dtype,
                                   scale=0.01)
        p["b_gate"] = torch.full((*lead, h * gd), 4.0, dtype=dtype,
                                 device=gen.device)       # init: slow decay
        p["gn_scale"] = torch.ones((*lead, h, dh), dtype=dtype,
                                   device=gen.device)
        p["gn_bias"] = torch.zeros((*lead, h, dh), dtype=dtype,
                                   device=gen.device)
    return p


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

class AttnState(NamedTuple):
    """Tagged decode state, JAX's fields in JAX's order; one family is
    used, the other fields are None:

    softmax: k_cache, v_cache (B, S, Hkv, Dh) in ``cfg.dtype``, the KV
             cache, O(S) per sequence;
    linear:  s (B, H, Dk, Dv) fp32 matrix state and z (B, H, Dk) fp32
             key-sum normaliser (linear backend under
             ``linear_normalize`` only, else None) — the paper's
             fixed-size representation; O(1) in context.
    """
    k_cache: Optional[Tensor] = None
    v_cache: Optional[Tensor] = None
    s: Optional[Tensor] = None
    z: Optional[Tensor] = None


def init_attn_state(cfg: ModelConfig, batch: int, *,
                    max_len: Optional[int] = None,
                    lead: Tuple[int, ...] = (), device=None) -> AttnState:
    """Zero decode state. ``max_len`` (the KV cache's length) is required
    under softmax and ignored by the linear family."""
    _require_ported(cfg)
    h, dh = cfg.n_heads, cfg.head_dim
    if cfg.attention_backend == "softmax":
        if max_len is None:
            raise ValueError(f"{cfg.name}: the softmax KV cache needs "
                             f"max_len")
        shape = (*lead, batch, max_len, cfg.n_kv_heads, dh)
        dtype = getattr(torch, cfg.dtype)    # "bfloat16", "float32", ...
        return AttnState(
            k_cache=torch.zeros(shape, dtype=dtype, device=device),
            v_cache=torch.zeros(shape, dtype=dtype, device=device))
    # the gated state has no normaliser, even under linear_normalize
    z = (torch.zeros((*lead, batch, h, dh), dtype=torch.float32,
                     device=device)
         if cfg.attention_backend == "linear" and cfg.linear_normalize
         else None)
    return AttnState(
        s=torch.zeros((*lead, batch, h, dh, dh), dtype=torch.float32,
                      device=device), z=z)


# ---------------------------------------------------------------------------
# projection plumbing
# ---------------------------------------------------------------------------

def _head_rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _project_qkv(p: Params, x: Tensor, cfg: ModelConfig
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """x: (B, T, D) → q (B, G, Hkv, T, Dh), k/v (B, Hkv, T, Dh)."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    q = (x @ p["wq"].to(x.dtype)).reshape(b, t, g, hkv, dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, t, hkv, dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, t, hkv, dh)
    q = q.permute(0, 2, 3, 1, 4)               # (B, G, Hkv, T, Dh)
    k = k.permute(0, 2, 1, 3)                  # (B, Hkv, T, Dh)
    v = v.permute(0, 2, 1, 3)
    if cfg.qk_norm:                            # qk-norm before RoPE
        q = _head_rmsnorm(q, p["q_norm"])
        k = _head_rmsnorm(k, p["k_norm"])
    return q, k, v


def _merge_heads(p: Params, o: Tensor, x_dtype) -> Tensor:
    """o: (B, G, Hkv, T, Dh) → (B, T, D) through wo."""
    b, g, hkv, t, dh = o.shape
    o = o.permute(0, 3, 1, 2, 4).reshape(b, t, g * hkv * dh)
    return o.to(x_dtype) @ p["wo"].to(x_dtype)


def _apply_rot(x: Tensor, c: Tensor, s: Tensor) -> Tensor:
    """Split-half rotation (not interleaved), in fp32."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _rope(q: Tensor, k: Tensor, positions: Tensor, cfg: ModelConfig
          ) -> Tuple[Tensor, Tensor]:
    """positions: (T,) shared, (B,) single-token decode, or (B, T)
    per-sequence windows; q (B,G,Hkv,T,D), k (B,Hkv,T,D)."""
    cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    if positions.ndim == 2:                              # (B, T) window
        c, s = cos[:, None, None], sin[:, None, None]    # (B,1,1,T,D/2)
    elif positions.ndim == 1 and q.shape[3] == positions.shape[0]:
        c, s = cos[None, None, None], sin[None, None, None]
    else:                                                # decode: (B,)
        c = cos[:, None, None, None]
        s = sin[:, None, None, None]
    q = _apply_rot(q, c, s)
    k = _apply_rot(k, c[:, :, 0] if c.ndim == 5 else c,
                   s[:, :, 0] if s.ndim == 5 else s)
    return q, k


def _heads(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Feature-mapped per-q-head view (B, H, T, Dh): q flattened over
    (G, Hkv), k and v broadcast over the G groups."""
    b, g, hkv, t, dh = q.shape
    h = g * hkv
    qf = feature_map(q, cfg.feature_map)
    kf = feature_map(k, cfg.feature_map)
    qh = qf.reshape(b, h, t, dh)
    kh = kf[:, None].expand(b, g, hkv, t, dh).reshape(b, h, t, dh)
    vh = v[:, None].expand(b, g, hkv, t, dh).reshape(b, h, t, dh)
    return qh, kh, vh


def _decay(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Data-dependent log-decay g ≤ 0 (the paper's α_t = exp(g_t)), fp32:
    (B, H, T, Dk) in vector mode, (B, H, T, 1) in scalar mode."""
    b, t, _ = x.shape
    gd = cfg.head_dim if cfg.decay_mode == "vector" else 1
    raw = x @ p["w_gate"].to(x.dtype) + p["b_gate"].to(x.dtype)
    raw = raw.reshape(b, t, cfg.n_heads, gd).permute(0, 2, 1, 3)
    # log α = −softplus(−raw)/decay_temp: raw → +∞ remembers, −∞ forgets
    return -F.softplus(-raw.float()) * (1.0 / cfg.decay_temp)


def _groupnorm(p: Params, o: Tensor) -> Tensor:
    """Per-head groupnorm of head outputs o: (B, H, T, Dh)."""
    return L.groupnorm_heads(o.transpose(1, 2), p["gn_scale"].float(),
                             p["gn_bias"].float()).transpose(1, 2)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def attention_apply(
    p: Params,
    x: Tensor,
    cfg: ModelConfig,
    *,
    want_state: bool = False,
    attention_kernel: bool = True,
) -> Tuple[Tensor, Optional[AttnState]]:
    """Full-sequence attention. x: (B, T, D) → (B, T, D).

    ``want_state=True`` (prefill) also returns the decode state after the
    last position. Under softmax that is the KV cache, k and v as
    (B, T, Hkv, Dh), and the attention runs ``flash_attention`` over
    the flat heads with K/V read by kv head (JAX broadcasts them over
    the groups first; the numbers are the same): B10 on CUDA tensors.
    Training under softmax raises NotImplementedError (B10 is forward
    only). For the linear family the state is the final
    state of the plain chunked forms and, for the linear backend,
    z = Σ_t k_t, a plain fp32 sum. Without it (training), the linear
    backend runs ``causal_linear_attention``: B2 forward and B3's §3.3
    recompute backward; the gated backend runs ``gated_linear_attention``:
    B8 forward and B9's recompute backward. All take the kernels on
    CUDA tensors and their plain versions on CPU tensors or under
    ``attention_kernel=False``.
    """
    _require_ported(cfg)
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        q, k = _rope(q, k, torch.arange(t, device=x.device), cfg)
    if cfg.attention_backend == "softmax":
        if not want_state:
            raise NotImplementedError(
                f"{cfg.name}: softmax training is not ported (B10 is "
                f"forward only; JAX's backward is _flash_bwd)")
        o_h = XA.flash_attention(q.reshape(b, h, t, dh), k, v, None, 0,
                                 kernel=attention_kernel)
        state = AttnState(k_cache=k.transpose(1, 2).contiguous(),
                          v_cache=v.transpose(1, 2).contiguous())
        return _merge_heads(p, o_h.reshape(b, h // hkv, hkv, t, dh),
                            x.dtype), state
    qh, kh, vh = _heads(q, k, v, cfg)
    if cfg.attention_backend == "linear" and want_state:
        o_h, s_f = causal_linear_attention_chunked(
            qh, kh, vh, chunk_size=cfg.linear_chunk,
            normalize=cfg.linear_normalize)
        zf = kh.float().sum(dim=2) if cfg.linear_normalize else None
    elif cfg.attention_backend == "linear":   # training: §3.3 backward
        o_h = causal_linear_attention(
            qh, kh, vh, chunk_size=cfg.linear_chunk,
            normalize=cfg.linear_normalize, kernel=attention_kernel)
        s_f = zf = None
    elif want_state:   # gated_linear prefill: chunked_gla clamps g
        o_h, s_f = chunked_gla(qh, kh, vh, _decay(p, x, cfg),
                               chunk_size=cfg.linear_chunk)
        o_h = _groupnorm(p, o_h)
        zf = None
    else:   # gated_linear training: B8 / B9's recompute backward
        o_h = gated_linear_attention(qh, kh, vh, _decay(p, x, cfg),
                                     chunk_size=cfg.linear_chunk,
                                     kernel=attention_kernel)
        o_h = _groupnorm(p, o_h)
        s_f = zf = None
    state = AttnState(s=s_f, z=zf) if want_state else None
    o = o_h.reshape(b, h // hkv, hkv, t, dh)
    return _merge_heads(p, o, x.dtype), state


# ---------------------------------------------------------------------------
# single-token / windowed decode
# ---------------------------------------------------------------------------

def _recurrent_linear(s, q, k, v, z, cfg: ModelConfig, lens=None):
    """W-step linear decode recurrence behind ``cfg.decode_kernel``; s and
    z are updated in place. "auto"/"fused" go through the kernel wrapper
    (the CUDA kernel for CUDA tensors); "reference" asks for the plain
    PyTorch version explicitly. Shapes: s (B,H,Dk,Dv); q,k (B,H,W,Dk);
    v (B,H,W,Dv); z (B,H,Dk)|None; lens (B,)|None."""
    if cfg.decode_kernel == "reference":
        o, s_new, z_new = FRref.fused_recurrent_linear_ref(
            s, q, k, v, z=z, normalize=cfg.linear_normalize, lens=lens)
        s.copy_(s_new)
        if z_new is None:
            return o, s, None
        z.copy_(z_new)
        return o, s, z
    return FR.fused_recurrent_linear(
        s, q, k, v, z=z, normalize=cfg.linear_normalize, lens=lens)


def _recurrent_gated(s, q, k, v, g, cfg: ModelConfig, lens=None):
    """W-step gated decode recurrence behind ``cfg.decode_kernel``; s is
    updated in place. "auto"/"fused" go through the kernel wrapper (the
    CUDA kernel for CUDA tensors); "reference" asks for the plain PyTorch
    version explicitly. Shapes: s (B,H,Dk,Dv); q,k,g (B,H,W,Dk);
    v (B,H,W,Dv); lens (B,)|None."""
    if cfg.decode_kernel == "reference":
        o, s_new = FRref.fused_recurrent_gated_ref(s, q, k, v, g, lens=lens)
        s.copy_(s_new)
        return o, s
    return FR.fused_recurrent_gated(s, q, k, v, g, lens=lens)


def _recurrent(p: Params, x: Tensor, state: AttnState, qh, kh, vh,
               cfg: ModelConfig, lens=None) -> Tuple[Tensor, AttnState]:
    """The backend's W-step recurrence over head rows (B, H, W, Dh), from
    the block input x: (B, W, D). Returns head outputs (B, H, W, Dh) and
    the state, updated in place. The gated decay is broadcast to Dk
    before the kernel (scalar mode), so the kernel always sees
    (B, H, W, Dk); the groupnorm runs on its output."""
    if cfg.attention_backend == "linear":
        o_w, s_new, z_new = _recurrent_linear(state.s, qh, kh, vh, state.z,
                                              cfg, lens=lens)
        return o_w, AttnState(s=s_new, z=z_new)
    g = _decay(p, x, cfg).expand(qh.shape)
    o_w, s_new = _recurrent_gated(state.s, qh, kh, vh, g, cfg, lens=lens)
    return _groupnorm(p, o_w), AttnState(s=s_new, z=None)


def attention_decode(
    p: Params,
    x: Tensor,
    state: AttnState,
    pos: Tensor,
    cfg: ModelConfig,
) -> Tuple[Tensor, AttnState]:
    """One decode step. x: (B, D); pos: () shared position or (B,)
    per-sequence positions. The state is updated in place.

    softmax: writes the step's k and v into cache row ``pos`` of each
    sequence, then attends over rows < pos + 1 (``decode_attention``,
    plain PyTorch): O(pos) per head. The position stays on the device.
    Linear family: O(k²) per head, independent of pos."""
    _require_ported(cfg)
    b, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x[:, None, :], cfg)
    if cfg.rope:
        q, k = _rope(q, k, pos.expand(b), cfg)
    if cfg.attention_backend == "softmax":
        rows = torch.arange(b, device=x.device)
        cols = pos.expand(b).long()
        state.k_cache[rows, cols] = k[:, :, 0].to(state.k_cache.dtype)
        state.v_cache[rows, cols] = v[:, :, 0].to(state.v_cache.dtype)
        o = XA.decode_attention(q[:, :, :, 0], state.k_cache.transpose(1, 2),
                                state.v_cache.transpose(1, 2), cols + 1)
        return _merge_heads(p, o[:, :, :, None], x.dtype)[:, 0], state
    qh, kh, vh = _heads(q, k, v, cfg)                  # (B, H, 1, Dh)
    o_w, new_state = _recurrent(p, x[:, None, :], state, qh, kh, vh, cfg)
    o = o_w.reshape(b, cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, 1,
                    cfg.head_dim)
    return _merge_heads(p, o, x.dtype)[:, 0], new_state


def attention_decode_window(
    p: Params,
    x: Tensor,
    state: AttnState,
    pos0: Tensor,
    cfg: ModelConfig,
    *,
    lens: Optional[Tensor] = None,
) -> Tuple[Tensor, AttnState]:
    """Decode W known tokens in one fused kernel launch.

    x: (B, W, D); pos0: () position of the first token, or (B,)
    per-sequence window starts. ``lens``: (B,) per-row valid window
    lengths — row b advances only its first lens[b] tokens (lens=0 rows
    keep their state bit for bit). The state is updated in place. Linear
    family only: JAX scans single-token decode for softmax there, which
    is not ported.
    """
    _require_ported(cfg)
    if cfg.attention_backend == "softmax":
        raise NotImplementedError(
            f"{cfg.name}: decode_window under softmax is not ported")
    b, w, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=x.device)
        steps = torch.arange(w, device=x.device)
        positions = (pos0[:, None] + steps if pos0.ndim == 1
                     else pos0 + steps)
        q, k = _rope(q, k, positions, cfg)
    qh, kh, vh = _heads(q, k, v, cfg)
    if lens is not None:
        lens = torch.as_tensor(lens, device=x.device).to(torch.int32)
        lens = lens.clamp(0, w)
    o_w, new_state = _recurrent(p, x, state, qh, kh, vh, cfg, lens=lens)
    o = o_w.reshape(b, cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, w,
                    cfg.head_dim)
    return _merge_heads(p, o, x.dtype), new_state
