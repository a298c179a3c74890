"""GQA attention (port of ``repro/models/attention.py``), three backends.

- ``softmax``: classic attention (paper §2), the baseline. Prefill and
  training run causal flash attention over the flat heads, the B10
  kernel for CUDA tensors (``models/xla_attention.py``,
  ``kernels/flash_attention``), training with JAX's blockwise backward
  in plain PyTorch; the decode state is the KV cache, (B, S, Hkv, Dh)
  per layer in ``cfg.dtype``, read in plain PyTorch at O(pos) per
  token. Windows (engine ingest, varlen decode) step single-token decode
  over their tokens, as JAX scans it.
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
(``kernels/fused_recurrent``). Under ``cfg.feature_gate`` (the paper's
§4 gate f = σ(W h + b) ⊙ h, which JAX applies to the linear family only)
the mapped keys and the values are gated before they reach the state,
in prefill, training, decode and the windows alike; the kernels take
the gated rows as they take any others.

Heads are laid out as in the JAX package: q projects to (G, Hkv, Dh)
with G = H / Hkv groups, the flat head index is g·Hkv + kv_head, and
k / v are broadcast over the G groups in that order, so states carried
over from JAX line up head for head.

Under ``rules`` on a mesh the tensors are DTensors, placed by the spec
trees, and each kernel call site runs under ``sharding.local_call``
(DTensor's ``local_map``): every rank runs the kernel, or its plain
version on the CPU, on its own heads. As in JAX, the linear family's
flat heads are zero-padded to a multiple of the model axis
(``padded_head_count``; its decode state is padded the same way by
``init_attn_state``) so that they always split evenly, and the pad
heads are sliced off before the output projection; with null rules the
padding is the identity. Softmax attention in training and prefill
splits the q heads and gives every rank the kv heads whole (their
gradients are partial sums over the model axis), or, where the split
does not fall on whole groups, broadcasts K/V to the flat heads and
pads them as the linear family does. A softmax decode step keeps its KV
cache where ``attn_state_specs`` puts it: split on the kv heads, or,
when they do not divide the model axis, on the head dim, where the
scores are a contraction over the head dim and are summed over the
model axis before the softmax (the value columns stay independent).

The decode functions update the state tensors in place and return them
(a softmax step writes its one cache row per sequence).

Cross-attention (the ``cross`` block kind, JAX ``:823-899``) attends from
the text positions to a pre-encoded memory, the paper's document/query
setting verbatim: under the linear family the memory's N key/value rows
collapse once into C = φ(K)ᵀV and z = Σφ(K) per kv head, and each query
is an O(k²) lookup; under softmax K and V are kept and every query
scores all N rows in fp32. No kernel, as in JAX (jnp einsums).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gated import chunked_gla, gated_linear_attention
from repro_torch.core.linear_attention import (
    causal_linear_attention, causal_linear_attention_chunked, safe_denom)
from repro_torch.kernels.fused_recurrent import ops as FR
from repro_torch.kernels.fused_recurrent import ref as FRref
from repro_torch.models import layers as L
from repro_torch.models import xla_attention as XA
from repro_torch.sharding import (
    Rules, constrain, dense_grad, grad_as_forward, kernel_site, local_call,
    map_local, replicated_like, split_last, whole_dims, whole_if_uneven)

Tensor = torch.Tensor
Params = Dict[str, Tensor]
NULL = Rules.null()
# the logical names of a per-head kernel operand (B, H, T, D) and of
# a per-row one (B,)
HEADS = ("batch", "heads_state", None, None)
ROWS = ("batch",)
# a KV cache (B, S, Hkv, Dh): the head dim takes the model axis where the
# kv heads do not divide it
KV_NAMES = ("batch", None, "kv_heads_state", "head_dim_state")


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
    if cfg.attention_backend in ("linear", "gated_linear") and \
            cfg.feature_gate:
        # the paper's exact gate f = σ(W h + b) ⊙ h applied to keys/values
        p["w_fgate"] = L.dense_init(gen, d, hkv * dh, lead=lead, dtype=dtype)
        p["b_fgate"] = torch.zeros((*lead, hkv * dh), dtype=dtype,
                                   device=gen.device)
    return p


def attention_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical sharding names, the tree of ``attention_params``: the flat
    projection dims shard over the model axis (the head count need not
    divide it)."""
    p = {
        "wq": ("fsdp", "heads"),
        "wk": ("fsdp", "kv_heads_flat"),
        "wv": ("fsdp", "kv_heads_flat"),
        "wo": ("heads", "fsdp"),
    }
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    if cfg.attention_backend == "gated_linear":
        p["w_gate"] = ("fsdp", "heads")
        p["b_gate"] = ("heads",)
        p["gn_scale"] = ("heads", None)
        p["gn_bias"] = ("heads", None)
    if cfg.attention_backend in ("linear", "gated_linear") and \
            cfg.feature_gate:
        p["w_fgate"] = ("fsdp", "kv_heads_flat")
        p["b_fgate"] = ("kv_heads_flat",)
    return p


def cross_attention_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    return {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads_flat"),
            "wv": ("fsdp", "kv_heads_flat"), "wo": ("heads", "fsdp")}


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
                    lead: Tuple[int, ...] = (), device=None,
                    rules: Optional[Rules] = None) -> AttnState:
    """Zero decode state. ``max_len`` (the KV cache's length) is required
    under softmax and ignored by the linear family, whose state heads
    are padded to a multiple of the model axis under ``rules``."""
    dh = cfg.head_dim
    h = cfg.n_heads if rules is None else padded_head_count(rules,
                                                            cfg.n_heads)
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


def attn_state_specs(cfg: ModelConfig) -> AttnState:
    """Logical sharding names of the decode state (same structure)."""
    if cfg.attention_backend == "softmax":
        return AttnState(k_cache=KV_NAMES, v_cache=KV_NAMES, s=None, z=None)
    z = (("batch", "heads_state", None)
         if cfg.attention_backend == "linear" and cfg.linear_normalize
         else None)
    return AttnState(k_cache=None, v_cache=None,
                     s=("batch", "heads_state", None, None), z=z)


def padded_head_count(rules: Rules, h: int) -> int:
    """The flat head count rounded up to a multiple of the model axis
    (JAX ``padded_head_count``): zero pad heads keep one even split."""
    m = rules.model_size
    return -(-h // m) * m if m > 1 else h


def _first_heads(x: Tensor, h: int) -> Tensor:
    """The first ``h`` heads of (B, H_pad, ...): the pad heads dropped
    (nothing to drop without padding)."""
    return x if x.shape[1] == h else x[:, :h]


def _pad_head_dim(x: Tensor, h_pad: int, axis: int = 1) -> Tensor:
    pad = h_pad - x.shape[axis]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    shape = list(x.shape)
    shape[axis] = h_pad
    # on a mesh each rank pads its block with the padded dim whole: torch
    # 2.11's DTensor fails to plan F.pad's redistribution
    return map_local(lambda t: F.pad(t, widths), whole_dims(x, axis), shape)


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
    q = split_last(x @ p["wq"].to(x.dtype), g, hkv, dh)
    k = split_last(x @ p["wk"].to(x.dtype), hkv, dh)
    v = split_last(x @ p["wv"].to(x.dtype), hkv, dh)
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
    o = grad_as_forward(whole_dims(o, 2, 4).permute(0, 3, 1, 2, 4).reshape(
        b, t, g * hkv * dh))
    return o.to(x_dtype) @ p["wo"].to(x_dtype)


def _merge_flat_heads(p: Params, o: Tensor, x_dtype) -> Tensor:
    """o: (B, H, T, Dh) in the flat head order g·Hkv + j → (B, T, D)
    through wo, the same product as ``_merge_heads``; on a mesh the
    heads' split need not fall on whole groups of Hkv (16 heads over a
    model axis of 16)."""
    b, h, t, dh = o.shape
    o = grad_as_forward(whole_if_uneven(o, 1).transpose(1, 2).reshape(
        b, t, h * dh))
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
    cos, sin = (replicated_like(t, q) for t in
                L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta))
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


def _gate_kv(p: Params, x: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig
             ) -> Tuple[Tensor, Tensor]:
    """Paper §4 sigmoid feature gate: f = σ(W h + b) ⊙ h, applied to the
    key and value features that enter the state update C ← C + f fᵀ.
    x: (B, T, D) the block input; k, v: (B, Hkv, T, Dh)."""
    b, t, _ = x.shape
    gate = torch.sigmoid(x @ p["w_fgate"].to(x.dtype)
                         + p["b_fgate"].to(x.dtype))
    gate = split_last(gate, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    return k * gate, v * gate


def _heads(p: Params, x: Tensor, q: Tensor, k: Tensor, v: Tensor,
           cfg: ModelConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """Feature-mapped per-q-head view (B, H, T, Dh): q flattened over
    (G, Hkv), k and v broadcast over the G groups; with
    ``cfg.feature_gate`` the mapped keys and the values gated first by
    ``_gate_kv`` of the block input x (B, T, D), as JAX does at each of
    its four call sites (prefill, decode, window, ingest)."""
    b, g, hkv, t, dh = q.shape
    h = g * hkv
    qf = feature_map(q, cfg.feature_map)
    kf = feature_map(k, cfg.feature_map)
    if cfg.feature_gate:
        kf, v = _gate_kv(p, x, kf, v, cfg)
    qh = whole_dims(qf, 2).reshape(b, h, t, dh)
    kh = whole_dims(kf, 1)[:, None].expand(b, g, hkv, t, dh).reshape(
        b, h, t, dh)
    vh = whole_dims(v, 1)[:, None].expand(b, g, hkv, t, dh).reshape(
        b, h, t, dh)
    return qh, kh, vh


def _valid_mask(lens, t: int, device) -> Tensor:
    """(B, 1, T, 1) bool over the (B, H, T, D) heads: position < lens[b]."""
    lens = torch.as_tensor(lens, device=device)
    return (torch.arange(t, device=device)[None, :]
            < lens[:, None])[:, None, :, None]


def _decay(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Data-dependent log-decay g ≤ 0 (the paper's α_t = exp(g_t)), fp32:
    (B, H, T, Dk) in vector mode, (B, H, T, 1) in scalar mode."""
    b, t, _ = x.shape
    gd = cfg.head_dim if cfg.decay_mode == "vector" else 1
    raw = x @ p["w_gate"].to(x.dtype) + p["b_gate"].to(x.dtype)
    raw = dense_grad(split_last(raw, cfg.n_heads, gd)).permute(0, 2, 1, 3)
    # log α = −softplus(−raw)/decay_temp: raw → +∞ remembers, −∞ forgets
    return -F.softplus(-raw.float()) * (1.0 / cfg.decay_temp)


def _groupnorm(p: Params, o: Tensor) -> Tensor:
    """Per-head groupnorm of head outputs o: (B, H, T, Dh)."""
    return L.groupnorm_heads(o.transpose(1, 2), p["gn_scale"].float(),
                             p["gn_bias"].float()).transpose(1, 2)


# ---------------------------------------------------------------------------
# kernel call sites on a mesh
# ---------------------------------------------------------------------------

def _flash(qh: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig,
           rules: Rules, kernel: bool) -> Tensor:
    """Causal attention over the flat q heads qh (B, H, T, Dh) with
    K/V of Hkv heads (B10 on CUDA tensors). On a mesh each rank takes
    its q heads: with whole groups of Hkv heads each, every rank reads
    K/V whole; otherwise K/V are broadcast to the flat heads and all
    three padded to the model axis."""
    def fn(q_, k_, v_):
        return XA.flash_attention(q_, k_, v_, None, 0,
                                  block=cfg.attn_block_q, kernel=kernel)
    if not rules.on_mesh:
        return fn(qh, k, v)
    b, h, t, dh = qh.shape
    hkv, m = k.shape[1], rules.model_size
    if h % m == 0 and (h // m) % hkv == 0:
        whole = ("batch", None, None, None)
        return local_call(fn, rules, (qh, k, v), (HEADS, whole, whole),
                          (HEADS,), grad_partial=(1, 2))
    hp = padded_head_count(rules, h)
    kb, vb = (_pad_head_dim(whole_dims(x, 1)[:, None].expand(
        b, h // hkv, hkv, t, dh).reshape(b, h, t, dh), hp) for x in (k, v))
    return _first_heads(local_call(fn, rules, (_pad_head_dim(qh, hp), kb,
                                               vb), (HEADS,) * 3, (HEADS,)),
                        h)


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
    varlen: Optional[Tensor] = None,
    rules: Rules = NULL,
) -> Tuple[Tensor, Optional[AttnState]]:
    """Full-sequence attention. x: (B, T, D) → (B, T, D).

    ``varlen``: (B,) per-row valid lengths of an END-padded batch
    (bucket-padded batched prefill). For the linear family the
    feature-mapped k and v are zeroed at pad positions and the gated
    log-decay is 0 there, so pad positions add nothing to the state or
    to z (then the masked key sum); under softmax causality already
    keeps pad keys from valid queries. Outputs at pad positions are
    garbage the caller ignores.

    ``want_state=True`` (prefill) also returns the decode state after the
    last position. Under softmax that is the KV cache, k and v as
    (B, T, Hkv, Dh), and the attention runs ``flash_attention`` over
    the flat heads with K/V read by kv head (JAX broadcasts them over
    the groups first; the numbers are the same): B10 on CUDA tensors.
    Training under softmax runs the same call under autograd: B10 with
    its log-sum-exp forward, JAX's blockwise backward over blocks of
    ``cfg.attn_block_q``. For the linear family the state is the final
    state of the plain chunked forms and, for the linear backend,
    z = Σ_t k_t, a plain fp32 sum. Without it (training), the linear
    backend runs ``causal_linear_attention``: B2 forward and B3's §3.3
    recompute backward; the gated backend runs ``gated_linear_attention``:
    B8 forward and B9's recompute backward. All take the kernels on
    CUDA tensors and their plain versions on CPU tensors or under
    ``attention_kernel=False``. ``rules``: on a mesh each of these calls
    runs on the rank's own heads; a state comes back placed by
    ``attn_state_specs``, the linear family's with its heads padded.
    """
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        q, k = _rope(q, k, torch.arange(t, device=x.device), cfg)
    vmask = None if varlen is None else _valid_mask(varlen, t, x.device)
    if cfg.attention_backend == "softmax":
        o_h = _flash(q.reshape(b, h, t, dh), k, v, cfg, rules,
                     attention_kernel)
        y = _merge_flat_heads(p, o_h, x.dtype)
        if not want_state:
            return y, None
        return y, AttnState(
            k_cache=constrain(k.transpose(1, 2).contiguous(), rules,
                              *KV_NAMES),
            v_cache=constrain(v.transpose(1, 2).contiguous(), rules,
                              *KV_NAMES))
    hp = padded_head_count(rules, h)
    qh, kh, vh = (_pad_head_dim(a, hp) for a in _heads(p, x, q, k, v, cfg))
    if vmask is not None:        # pad positions inert in the state sums
        kh = torch.where(vmask, kh, 0).to(kh.dtype)
        vh = torch.where(vmask, vh, 0).to(vh.dtype)
    qkv, chunk = (qh, kh, vh), cfg.linear_chunk
    if cfg.attention_backend == "linear" and want_state:
        o_h, s_f = kernel_site(
            lambda *a: causal_linear_attention_chunked(
                *a, chunk_size=chunk, normalize=cfg.linear_normalize),
            rules, qkv, (HEADS,) * 3, (HEADS, HEADS))
        zf = (constrain(kh.float().sum(dim=2), rules, "batch", "heads_state",
                        None) if cfg.linear_normalize else None)
    elif cfg.attention_backend == "linear":   # training: §3.3 backward
        o_h = kernel_site(
            lambda *a: causal_linear_attention(
                *a, chunk_size=chunk, normalize=cfg.linear_normalize,
                kernel=attention_kernel),
            rules, qkv, (HEADS,) * 3, (HEADS,))
        s_f = zf = None
    elif want_state:   # gated_linear prefill: chunked_gla clamps g
        g = _pad_head_dim(_decay(p, x, cfg), hp)
        if vmask is not None:    # pad positions must not decay the state
            g = torch.where(vmask, g, 0.0)
        o_h, s_f = kernel_site(lambda *a: chunked_gla(*a, chunk_size=chunk),
                           rules, qkv + (g,), (HEADS,) * 4, (HEADS, HEADS))
        o_h = _groupnorm(p, _first_heads(o_h, h))
        zf = None
    else:   # gated_linear training: B8 / B9's recompute backward
        o_h = kernel_site(
            lambda *a: gated_linear_attention(*a, chunk_size=chunk,
                                              kernel=attention_kernel),
            rules, qkv + (_pad_head_dim(_decay(p, x, cfg), hp),),
            (HEADS,) * 4, (HEADS,))
        o_h = _groupnorm(p, _first_heads(o_h, h))
        s_f = zf = None
    state = AttnState(s=s_f, z=zf) if want_state else None
    return _merge_flat_heads(p, _first_heads(o_h, h), x.dtype), state


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
               cfg: ModelConfig, lens=None, rules: Rules = NULL
               ) -> Tuple[Tensor, AttnState]:
    """The backend's W-step recurrence over head rows (B, H, W, Dh), from
    the block input x: (B, W, D). Returns head outputs (B, H, W, Dh) and
    the state, updated in place. The gated decay is broadcast to Dk
    before the kernel (scalar mode), so the kernel always sees
    (B, H, W, Dk); the groupnorm runs on its output. The state may have
    more (zero pad) heads than the model (``init_attn_state`` under
    rules): the head rows are padded to match and the pad heads' outputs
    dropped. On a mesh each rank updates its own heads of the state in
    place."""
    h, hp = qh.shape[1], state.s.shape[1]
    qh, kh, vh = (_pad_head_dim(a, hp) for a in (qh, kh, vh))
    if cfg.attention_backend == "linear":
        z_names = None if state.z is None else ("batch", "heads_state", None)
        o_w, s_new, z_new = kernel_site(
            lambda s, q, k, v, z, n: _recurrent_linear(s, q, k, v, z, cfg,
                                                       lens=n),
            rules, (state.s, qh, kh, vh, state.z, lens),
            (HEADS,) * 4 + (z_names, ROWS), (HEADS, HEADS, z_names),
            inplace=(0, 4))
        # on a mesh each rank updated its block of the state in place
        new = state if rules.on_mesh else AttnState(s=s_new, z=z_new)
        return _first_heads(o_w, h), new
    g = _pad_head_dim(_decay(p, x, cfg), hp).expand(qh.shape)
    o_w, s_new = kernel_site(
        lambda s, q, k, v, g_, n: _recurrent_gated(s, q, k, v, g_, cfg,
                                                   lens=n),
        rules, (state.s, qh, kh, vh, g, lens), (HEADS,) * 5 + (ROWS,),
        (HEADS, HEADS), inplace=(0,))
    new = state if rules.on_mesh else AttnState(s=s_new, z=None)
    return _groupnorm(p, _first_heads(o_w, h)), new


def _softmax_step(state: AttnState, q: Tensor, k: Tensor, v: Tensor,
                  pos: Tensor, active: Optional[Tensor], *,
                  scale: Optional[float] = None, partial_sum=None) -> Tensor:
    """One softmax decode step over the KV cache, in place. q: (B, G,
    Hkv, Dh); k, v: (B, Hkv, Dh); pos: (B,) the row each sequence writes
    (clamped to the cache, as JAX's dynamic update clamps it); active:
    (B,) bool or None. Writes k and v into row pos of each sequence (an
    inactive sequence gets its current row back, bit for bit), then
    attends over rows ≤ pos. Returns o (B, G, Hkv, Dh). ``scale`` and
    ``partial_sum`` go to ``decode_attention`` (a rank's block of the
    head dim)."""
    b = q.shape[0]
    rows = torch.arange(b, device=q.device)
    cols = pos.long().clamp(0, state.k_cache.shape[1] - 1)
    k_new = k.to(state.k_cache.dtype)
    v_new = v.to(state.v_cache.dtype)
    if active is not None:
        act = torch.as_tensor(active, device=q.device).bool()[:, None, None]
        k_new = torch.where(act, k_new, state.k_cache[rows, cols])
        v_new = torch.where(act, v_new, state.v_cache[rows, cols])
    state.k_cache[rows, cols] = k_new
    state.v_cache[rows, cols] = v_new
    return XA.decode_attention(q, state.k_cache.transpose(1, 2),
                               state.v_cache.transpose(1, 2), pos + 1,
                               scale=scale, partial_sum=partial_sum)


def _softmax_step_on(rules: Rules, state: AttnState, q: Tensor, k: Tensor,
                     v: Tensor, pos: Tensor, active: Optional[Tensor]
                     ) -> Tensor:
    """``_softmax_step`` on each rank's block of the KV cache, which
    stays where ``attn_state_specs`` put it. Split on the kv heads, the
    step is local; split on the head dim, the scores are partial sums
    over the rank's columns, summed over the model axis before the
    softmax, and each rank's output keeps its value columns."""
    if not rules.on_mesh:
        return _softmax_step(state, q, k, v, pos, active)
    import torch.distributed as dist
    dh = q.shape[-1]
    group = (rules.mesh.get_group("model") if rules.model_size > 1
             else None)

    def fn(kc, vc, q_, k_, v_, pos_, act_):
        split = q_.shape[-1] < dh
        return _softmax_step(
            AttnState(k_cache=kc, v_cache=vc), q_, k_, v_, pos_, act_,
            scale=dh ** -0.5,
            partial_sum=(lambda sc: dist.all_reduce(sc, group=group))
            if split else None)
    row = ("batch", "kv_heads_state", "head_dim_state")
    return local_call(fn, rules, (state.k_cache, state.v_cache, q, k, v,
                                  pos, active),
                      (KV_NAMES,) * 3 + (row, row, ROWS, ROWS), (KV_NAMES,),
                      out_shapes=(q.shape,), inplace=(0, 1))


def _softmax_window(p: Params, x: Tensor, state: AttnState, pos0,
                    cfg: ModelConfig, lens: Optional[Tensor]
                    ) -> Tuple[Tensor, AttnState]:
    """W known tokens under softmax: JAX scans single-token decode over
    the window (``block_decode_window``), step w at position pos0 + w
    and, with ``lens``, active where w < lens[b]. Here the window is
    projected once and the steps run over its tokens, each writing its
    cache row (gated) before it reads. The state is updated in place;
    outputs at masked steps are garbage."""
    b, w, _ = x.shape
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=x.device)
    positions = pos0.expand(b)[:, None] + torch.arange(w, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        q, k = _rope(q, k, positions, cfg)
    if lens is not None:
        lens = torch.as_tensor(lens, device=x.device).to(torch.int32)
    outs = [_softmax_step(state, q[:, :, :, i], k[:, :, i], v[:, :, i],
                          positions[:, i], None if lens is None else i < lens)
            for i in range(w)]
    return _merge_heads(p, torch.stack(outs, dim=3), x.dtype), state


def attention_decode(
    p: Params,
    x: Tensor,
    state: AttnState,
    pos: Tensor,
    cfg: ModelConfig,
    *,
    active: Optional[Tensor] = None,
    rules: Rules = NULL,
) -> Tuple[Tensor, AttnState]:
    """One decode step. x: (B, D); pos: () shared position or (B,)
    per-sequence positions. The state is updated in place; on a mesh
    (``rules``) each rank updates its own block of it.

    softmax: writes the step's k and v into cache row ``pos`` of each
    sequence, then attends over rows < pos + 1 (``decode_attention``,
    plain PyTorch): O(pos) per head. The position stays on the device.
    Linear family: O(k²) per head, independent of pos.

    ``active``: (B,) bool slot mask (continuous batching). An inactive
    row keeps its state bit for bit. JAX runs the step and then selects
    s and z; here the mask goes into the recurrence as per-row window
    lengths ``lens = active`` (W = 1), so B1/B7 (and their plain
    versions) leave a masked row's state untouched in place. Under
    softmax the one written cache row is gated as JAX gates it: the row
    is read back and where(active, new, current) written, with no host
    sync."""
    b, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x[:, None, :], cfg)
    if cfg.rope:
        q, k = _rope(q, k, pos.expand(b), cfg)
    if cfg.attention_backend == "softmax":
        o = _softmax_step_on(rules, state, q[:, :, :, 0], k[:, :, 0],
                             v[:, :, 0], pos.expand(b), active)
        return _merge_heads(p, o[:, :, :, None], x.dtype)[:, 0], state
    qh, kh, vh = _heads(p, x[:, None, :], q, k, v, cfg)   # (B, H, 1, Dh)
    lens = (None if active is None else
            torch.as_tensor(active, device=x.device).to(torch.int32))
    o_w, new_state = _recurrent(p, x[:, None, :], state, qh, kh, vh, cfg,
                                lens=lens, rules=rules)
    return _merge_flat_heads(p, o_w, x.dtype)[:, 0], new_state


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
    keep their state bit for bit). The state is updated in place. Under
    softmax the window steps single-token decode (``_softmax_window``),
    as JAX scans it; the linear family runs one fused launch.
    """
    if cfg.attention_backend == "softmax":
        return _softmax_window(p, x, state, pos0, cfg, lens)
    b, w, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=x.device)
        steps = torch.arange(w, device=x.device)
        positions = (pos0[:, None] + steps if pos0.ndim == 1
                     else pos0 + steps)
        q, k = _rope(q, k, positions, cfg)
    qh, kh, vh = _heads(p, x, q, k, v, cfg)
    if lens is not None:
        lens = torch.as_tensor(lens, device=x.device).to(torch.int32)
        lens = lens.clamp(0, w)
    o_w, new_state = _recurrent(p, x, state, qh, kh, vh, cfg, lens=lens)
    o = o_w.reshape(b, cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, w,
                    cfg.head_dim)
    return _merge_heads(p, o, x.dtype), new_state


def attention_ingest_window(
    p: Params,
    x: Tensor,
    state: AttnState,
    pos0: Tensor,
    cfg: ModelConfig,
    *,
    lens: Tensor,
) -> Tuple[Tensor, AttnState]:
    """Chunk-parallel variable-length window (JAX
    ``attention_ingest_window``): continue a partially encoded prefix
    over up to W more known tokens per row, through the plain chunked
    forms prefill uses (``causal_linear_attention_chunked``,
    ``chunked_gla``) started from the carried state and key sum.

    x: (B, W, D); pos0: (B,) per-row window starts; lens: (B,) valid
    counts (0 = inert row). Masked positions add zero key and value
    terms and log-decay 0, so an inert row's state comes back as it was.
    The state is updated in place; outputs at masked positions are
    garbage. Under softmax, whose cache has no cheap parallel
    continuation, the window steps single-token decode as
    ``attention_decode_window`` does (JAX's ``block_ingest_window``
    falls back to its per-step scan).
    """
    if cfg.attention_backend == "softmax":
        return _softmax_window(p, x, state, pos0, cfg, lens)
    b, w, _ = x.shape
    lens = torch.as_tensor(lens, device=x.device).to(torch.int32).clamp(0, w)
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        pos0 = torch.as_tensor(pos0, dtype=torch.int32,
                               device=x.device).expand(b)
        positions = pos0[:, None] + torch.arange(w, device=x.device)
        q, k = _rope(q, k, positions, cfg)
    qh, kh, vh = _heads(p, x, q, k, v, cfg)
    vmask = _valid_mask(lens, w, x.device)
    kh = torch.where(vmask, kh, 0).to(kh.dtype)
    vh = torch.where(vmask, vh, 0).to(vh.dtype)
    if cfg.attention_backend == "linear":
        o_w, s_new = causal_linear_attention_chunked(
            qh, kh, vh, chunk_size=cfg.linear_chunk,
            initial_state=state.s, initial_z=state.z,
            normalize=cfg.linear_normalize)
        if cfg.linear_normalize:
            state.z.copy_(state.z + kh.float().sum(dim=2))
    else:
        g = torch.where(vmask, _decay(p, x, cfg), 0.0)  # inert: exp(0) = 1
        o_w, s_new = chunked_gla(qh, kh, vh, g, chunk_size=cfg.linear_chunk,
                                 initial_state=state.s)
        o_w = _groupnorm(p, o_w)
    state.s.copy_(s_new)
    o = o_w.reshape(b, cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, w,
                    cfg.head_dim)
    return _merge_heads(p, o, x.dtype), state


# ---------------------------------------------------------------------------
# cross attention (VLM): the paper's document/query setting verbatim
# ---------------------------------------------------------------------------

def cross_attention_params(gen: torch.Generator, cfg: ModelConfig, *,
                           lead: Tuple[int, ...] = (),
                           dtype=torch.float32) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": L.dense_init(gen, d, h * dh, lead=lead, dtype=dtype),
        "wk": L.dense_init(gen, d, hkv * dh, lead=lead, dtype=dtype),
        "wv": L.dense_init(gen, d, hkv * dh, lead=lead, dtype=dtype),
        "wo": L.dense_init(gen, h * dh, d, lead=lead, dtype=dtype),
    }


class CrossMemory(NamedTuple):
    """Pre-encoded modality memory, JAX's fields in JAX's order. softmax
    keeps k, v (B, Hkv, N, Dh) in the compute type, O(N·k) per layer;
    the linear family keeps the paper's C = φ(K)ᵀV (B, Hkv, Dk, Dv) and
    z = Σφ(K) (B, Hkv, Dk), both fp32, O(k²) per layer whatever N. It
    does not change during decode."""
    k: Optional[Tensor] = None
    v: Optional[Tensor] = None
    c: Optional[Tensor] = None
    z: Optional[Tensor] = None


def init_cross_memory(cfg: ModelConfig, batch: int, *,
                      lead: Tuple[int, ...] = (), device=None
                      ) -> CrossMemory:
    """Zero cross memory of ``cfg.n_img_tokens`` rows (softmax, in
    ``cfg.dtype``) or zero C and z (linear family)."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.attention_backend == "softmax":
        shape = (*lead, batch, hkv, cfg.n_img_tokens, dh)
        dtype = getattr(torch, cfg.dtype)
        return CrossMemory(k=torch.zeros(shape, dtype=dtype, device=device),
                           v=torch.zeros(shape, dtype=dtype, device=device))
    return CrossMemory(
        c=torch.zeros((*lead, batch, hkv, dh, dh), dtype=torch.float32,
                      device=device),
        z=torch.zeros((*lead, batch, hkv, dh), dtype=torch.float32,
                      device=device))


def encode_cross_memory(p: Params, memory: Tensor, cfg: ModelConfig
                        ) -> CrossMemory:
    """memory: (B, N, D) precomputed patch embeddings (the frontend is a
    stub) → the layer's memory: the paper's encode-once compression,
    C = φ(K)ᵀV and z = Σφ(K) accumulated in fp32, for the linear
    family; K and V as they are for softmax."""
    b, n, _ = memory.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = split_last(memory @ p["wk"].to(memory.dtype), hkv, dh)
    v = split_last(memory @ p["wv"].to(memory.dtype), hkv, dh)
    k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)    # (B, Hkv, N, Dh)
    if cfg.attention_backend == "softmax":
        return CrossMemory(k=k, v=v)
    kf = feature_map(k, cfg.feature_map).float()
    return CrossMemory(c=torch.einsum("bhnk,bhnv->bhkv", kf, v.float()),
                       z=kf.sum(dim=2))


def cross_attention_apply(p: Params, x: Tensor, mem: CrossMemory,
                          cfg: ModelConfig) -> Tensor:
    """x: (B, T, D) queries against the encoded memory → (B, T, D).
    softmax: fp32 scores over all N rows, no kernel (as in JAX). Linear
    family: φ(q)·C, over φ(q)·z through ``safe_denom`` under
    ``linear_normalize``, in fp32."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_last(x @ p["wq"].to(x.dtype), h // hkv, hkv, dh)
    q = q.permute(0, 2, 3, 1, 4)                        # (B, G, Hkv, T, Dh)
    if cfg.attention_backend == "softmax":
        scores = torch.einsum("bghtd,bhnd->bghtn", q.float() * dh ** -0.5,
                              mem.k.float())
        o = torch.einsum("bghtn,bhnd->bghtd", torch.softmax(scores, dim=-1),
                         mem.v.float())
    else:
        qf = feature_map(q, cfg.feature_map).float()
        o = torch.einsum("bghtk,bhkv->bghtv", qf, mem.c)
        if cfg.linear_normalize:
            denom = torch.einsum("bghtk,bhk->bght", qf, mem.z)
            o = o / safe_denom(denom)[..., None]
    return _merge_heads(p, o.to(x.dtype), x.dtype)
