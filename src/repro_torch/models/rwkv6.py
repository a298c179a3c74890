"""RWKV-6 "Finch" block (port of ``repro/models/rwkv6.py``): the paper's
eq. 4 with data-dependent per-channel decay, plus the bonus-u
(current-token) term, and no attention at all.

Time-mix recurrence (per head, Dk = Dv = head_dim N):

    S_t = diag(w_t) S_{t−1} + k_t v_tᵀ
    o_t = (S_{t−1} + diag(u) k_t v_tᵀ)ᵀ r_t     (exclusive + bonus)

with w_t = exp(−exp(w̃_t)) a function of the token-shifted input. The
simplifications of the JAX block are kept: the token-shift coefficients
are learned vectors, every projection a full matrix.

Prefill runs the whole prompt through ``rwkv6_attention``: on a CUDA
tensor one launch of B8's exclusive route per layer, every head at once
with its own u; on the CPU its plain version. Both clamp the log-decay
at ``MIN_LOG_DECAY`` (−1, above the bf16 route's limit of −1.25). The
plain version runs in chunks of at most ``PREFILL_CHUNK`` tokens: with
the decay at the clamp, a chunk of more than 88 tokens scales keys by
exp(−b) past fp32's range, and JAX's chunk of 128 gives NaN there (the
full config's decays reach −0.9 a token); 64 keeps it finite, and
shorter prompts take the same chunk as JAX's. The kernel rescales
within its own 64-token tiles whatever the chunk.

Training runs the same call at the same chunk: where a gradient is
wanted, ``rwkv6_attention`` goes through B8's exclusive route forward
and its hand-written backward (B9's design with the strict mask, the
bonus terms, the exclusive dg and du; JAX differentiates
``chunked_gla`` by autodiff), or on the CPU and with ``kernel=False``
through their plain versions.

Decode is one ``gated_decode_step(exclusive=True, u=...)`` per layer and
token, plain PyTorch, as JAX's jnp decode: B7 has no bonus term. The
decode state (``RWKVState``: two token-shift rows and the N×N wkv matrix
per head) is updated in place, inactive slots bit for bit.

Channel-mix: out = σ(W_r x_r) ⊙ W_v relu(W_k x_k)² (squared-ReLU FFN).

Under ``rules`` on a mesh (JAX ``rwkv6.py:154-186``) r, k and v are
constrained to ``heads_lin``, and the prefill (B8's exclusive route, or
its backward under autograd) runs on each rank's heads with their u
under ``sharding.kernel_site``; the heads are gathered again before the
output gate. The decode state is split as ``rwkv_state_specs`` says: the
wkv matrices on their heads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gated import MIN_LOG_DECAY, gated_decode_step
from repro_torch.kernels.gated_linear_attention.ops import rwkv6_attention
from repro_torch.models import layers as L
from repro_torch.sharding import (
    Rules, constrain, grad_as_forward, kernel_site, split_last, whole_dims)

Tensor = torch.Tensor
Params = Dict[str, Tensor]

PREFILL_CHUNK = 64
NULL = Rules.null()
# the logical names of a per-head operand (B, H, T, N) at the kernel site
HEADS = ("batch", "heads", None, None)


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    n = cfg.rwkv.head_dim
    return cfg.d_model // n, n


def rwkv6_params(gen: torch.Generator, cfg: ModelConfig, *,
                 lead: Tuple[int, ...] = (), dtype=torch.float32) -> Params:
    """JAX's ``rwkv6_params`` tree with a leading ``lead`` shape, drawn
    from ``gen`` (other numbers than JAX's: tests convert JAX's)."""
    d = cfg.d_model
    h, n = _dims(cfg)
    dev = gen.device

    def full(shape, value, dt=dtype):
        return torch.full((*lead, *shape), value, dtype=dt, device=dev)

    def dense(d_in, d_out, scale=None):
        return L.dense_init(gen, d_in, d_out, lead=lead, dtype=dtype,
                            scale=scale)

    # w̃'s init spread, log(linspace(0.3, 0.9)) in fp32 as JAX computes it
    decay0 = torch.log(torch.linspace(0.3, 0.9, d, dtype=torch.float32,
                                      device=dev))
    p = {name: full((d,), 0.5) for name in ("mu_r", "mu_k", "mu_v", "mu_w",
                                             "mu_g")}
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = dense(d, d)
    p.update(
        w_decay0=decay0.expand(*lead, d).clone(),
        w_decay1=dense(d, 64, 0.01),
        w_decay2=dense(64, d, 0.01),
        u_bonus=full((h, n), 0.0, torch.float32),
        gn_scale=full((h, n), 1.0),
        gn_bias=full((h, n), 0.0),
        mu_ck=full((d,), 0.5),
        mu_cr=full((d,), 0.5),
        w_ck=dense(d, cfg.d_ff),
        w_cv=dense(cfg.d_ff, d),
        w_cr=dense(d, d),
        ln1=L.layernorm_params(d, lead=lead, dtype=dtype, device=dev),
        ln2=L.layernorm_params(d, lead=lead, dtype=dtype, device=dev))
    return p


def rwkv6_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical sharding names, the tree of ``rwkv6_params``."""
    vec = (None,)
    return {
        "mu_r": vec, "mu_k": vec, "mu_v": vec, "mu_w": vec, "mu_g": vec,
        "w_r": ("fsdp", "heads"),
        "w_k": ("fsdp", "heads"),
        "w_v": ("fsdp", "heads"),
        "w_g": ("fsdp", "heads"),
        "w_o": ("heads", "fsdp"),
        "w_decay0": vec,
        "w_decay1": ("fsdp", None),
        "w_decay2": (None, "heads"),
        "u_bonus": ("heads_lin", None),
        "gn_scale": ("heads_lin", None),
        "gn_bias": ("heads_lin", None),
        "mu_ck": vec, "mu_cr": vec,
        "w_ck": ("fsdp", "ffn"),
        "w_cv": ("ffn", "fsdp"),
        "w_cr": ("fsdp", "heads"),
        "ln1": {"scale": vec, "bias": vec},
        "ln2": {"scale": vec, "bias": vec},
    }


class RWKVState(NamedTuple):
    """Decode state: two one-token shift registers and the paper's k×k
    (head_dim × head_dim per head) wkv matrix."""
    shift_att: Tensor   # (..., B, D) previous token's input to time-mix
    shift_ffn: Tensor   # (..., B, D) previous token's input to channel-mix
    wkv: Tensor         # (..., B, H, N, N) fp32


def init_rwkv_state(cfg: ModelConfig, batch: int, *,
                    lead: Tuple[int, ...] = (), device=None) -> RWKVState:
    """Zero state; the shift rows in ``cfg.dtype`` (JAX's), wkv fp32."""
    d = cfg.d_model
    h, n = _dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    return RWKVState(
        shift_att=torch.zeros((*lead, batch, d), dtype=dtype, device=device),
        shift_ffn=torch.zeros((*lead, batch, d), dtype=dtype, device=device),
        wkv=torch.zeros((*lead, batch, h, n, n), dtype=torch.float32,
                        device=device))


def rwkv_state_specs(cfg: ModelConfig) -> "RWKVState":
    """Logical sharding names of the decode state."""
    return RWKVState(shift_att=("batch", None), shift_ffn=("batch", None),
                     wkv=("batch", "heads", None, None))


def _token_shift(x: Tensor, last: Optional[Tensor] = None) -> Tensor:
    """Previous-token stream: shift(x)_t = x_{t−1} (0 / ``last`` at t=0)."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x: Tensor, prev: Tensor, mu: Tensor) -> Tensor:
    return x + (prev - x) * mu.to(x.dtype)


def _decay_log(p: Params, xw: Tensor) -> Tensor:
    """log w_t = −exp(w̃_t) ≤ 0, w̃ = w0 + tanh(x W1) W2, fp32 (B, T, D)."""
    lora = grad_as_forward(torch.tanh(xw @ p["w_decay1"].to(xw.dtype))
                           @ p["w_decay2"].to(xw.dtype))
    return -torch.exp(p["w_decay0"] + lora.float())


def _time_mix(p: Params, x: Tensor, cfg: ModelConfig,
              shift: Optional[Tensor], wkv: Optional[Tensor], single: bool,
              kernel: bool = True, rules: Rules = NULL
              ) -> Tuple[Tensor, Tensor]:
    """Full sequence (``single`` False: x (B, T, D), the prefill through
    ``rwkv6_attention``) or one decode step (x (B, D), from ``shift`` and
    ``wkv``). Returns (out, the new wkv state fp32); nothing is written
    in place."""
    b, d = x.shape[0], cfg.d_model
    h, n = _dims(cfg)
    if single:
        prev, xs = shift[:, None, :].to(x.dtype), x[:, None, :]
    else:
        prev, xs = _token_shift(x, shift), x
    xr, xk, xv, xw, xg = (_mix(xs, prev, p[f"mu_{c}"]) for c in "rkvwg")
    t = xs.shape[1]

    def heads(a):                           # (B, T, D) → (B, H, T, N)
        return split_last(a, h, n).transpose(1, 2)
    r, k, v = (constrain(heads(a @ p[f"w_{c}"].to(x.dtype)), rules,
                         "batch", "heads_lin", None, None)
               for a, c in ((xr, "r"), (xk, "k"), (xv, "v")))
    g = F.silu(xg @ p["w_g"].to(x.dtype))
    lw = heads(_decay_log(p, xw))

    if single:     # on a mesh each rank steps its own heads
        o, wkv_new = kernel_site(
            lambda *a: gated_decode_step(*a[:5], exclusive=True, u=a[5]),
            rules, (wkv, r[:, :, 0], k[:, :, 0], v[:, :, 0], lw[:, :, 0],
                    p["u_bonus"]),
            (HEADS,) + (HEADS[:3],) * 4 + (("heads", None),),
            (HEADS[:3], HEADS))
        o = o[:, None]                              # (B, 1, H, N)
    else:
        chunk = min(cfg.linear_chunk, PREFILL_CHUNK)
        o, wkv_new = kernel_site(
            lambda *a: rwkv6_attention(*a, chunk=chunk,
                                       min_log_decay=MIN_LOG_DECAY,
                                       kernel=kernel),
            rules, (r, k, v, lw, p["u_bonus"]),
            (HEADS,) * 4 + (("heads", None),), (HEADS, HEADS),
            grad_partial=(4,))     # u: each rank's du covers its rows
        o = o.transpose(1, 2)                       # (B, T, H, N)
    o = L.groupnorm_heads(o, p["gn_scale"].float(), p["gn_bias"].float())
    o = (whole_dims(o, 2).reshape(b, t, d) * g).to(x.dtype)
    out = o @ p["w_o"].to(x.dtype)
    return (out[:, 0] if single else out), wkv_new


def _channel_mix(p: Params, x: Tensor, shift: Optional[Tensor],
                 single: bool) -> Tensor:
    if single:
        prev, xs = shift[:, None, :].to(x.dtype), x[:, None, :]
    else:
        prev, xs = _token_shift(x, shift), x
    xk = _mix(xs, prev, p["mu_ck"])
    xr = _mix(xs, prev, p["mu_cr"])
    kk = torch.square(F.relu(xk @ p["w_ck"].to(x.dtype)))
    out = torch.sigmoid(xr @ p["w_cr"].to(x.dtype)) * (
        kk @ p["w_cv"].to(x.dtype))
    return out[:, 0] if single else out


def rwkv6_apply(p: Params, x: Tensor, cfg: ModelConfig, *,
                want_state: bool = False, attention_kernel: bool = True,
                rules: Rules = NULL
                ) -> Tuple[Tensor, Optional[RWKVState]]:
    """Full RWKV-6 block (time-mix + channel-mix, layernorm residuals) on
    x (B, T, D). ``attention_kernel=False`` runs the prefill's plain
    version on a CUDA tensor. ``rules``: on a mesh the prefill runs on
    each rank's heads and the wkv state comes back placed by
    ``rwkv_state_specs``."""
    whole = ("batch", None, "embed")     # on a mesh: the sequence whole
    h1 = L.layernorm(p["ln1"], x)
    att, wkv = _time_mix(p, h1, cfg, None, None, single=False,
                         kernel=attention_kernel, rules=rules)
    x = x + constrain(att, rules, *whole)
    h2 = L.layernorm(p["ln2"], x)
    x = x + constrain(_channel_mix(p, h2, None, single=False), rules,
                      *whole)
    state = None
    if want_state:
        state = RWKVState(shift_att=h1[:, -1].clone(),
                          shift_ffn=h2[:, -1].clone(), wkv=wkv)
    return x, state


def rwkv6_decode(p: Params, x: Tensor, state: RWKVState, cfg: ModelConfig,
                 *, active: Optional[Tensor] = None, rules: Rules = NULL
                 ) -> Tuple[Tensor, RWKVState]:
    """One decode step, x (B, D): O(head_dim²) per head, O(1) in context
    length. The state is updated in place; with ``active`` (B,) bool only
    the active rows (JAX's per-row select), the others bit for bit.
    ``rules``: on a mesh the state is placed by ``rwkv_state_specs`` and
    each rank updates its own block."""
    h1 = L.layernorm(p["ln1"], x)
    att, wkv = _time_mix(p, h1, cfg, state.shift_att, state.wkv,
                         single=True, rules=rules)
    x = x + att
    h2 = L.layernorm(p["ln2"], x)
    x = x + _channel_mix(p, h2, state.shift_ffn, single=True)
    for dst, src, names in zip(state, (h1, h2, wkv), rwkv_state_specs(cfg)):
        src = constrain(src, rules, *names)
        if active is not None:
            src = torch.where(active.reshape(-1, *[1] * (src.ndim - 1)),
                              src.to(dst.dtype), dst)
        dst.copy_(src)
    return x, state

