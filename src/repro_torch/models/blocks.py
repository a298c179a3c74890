"""Block dispatch (port of ``repro/models/blocks.py``), five kinds, the
attention family's norms by ``cfg.norm`` (rmsnorm: a scale; layernorm:
a scale and a bias):

  "attn"         pre-norm self-attention (``softmax``, ``linear`` or
                 ``gated_linear``) + MLP, or + MoE FFN when ``cfg.moe``
                 is set
  "shared_attn"  the same block with an MLP, but ONE parameter set
                 (``params["shared"]``, passed as ``shared``) for all its
                 sites (Zamba-style); each site keeps its own decode state
                 and takes the fused window route of B1/B7, as "attn" does
  "cross"        pre-norm cross-attention to a pre-encoded modality
                 memory, gated by tanh(xgate) (zero at init: the block
                 adds nothing until trained), + MLP
  "mamba"        pre-norm Mamba-2 SSD block, no separate FFN
                 (``models/mamba2.py``)
  "rwkv"         RWKV-6 block (time-mix + channel-mix, its own
                 layernorms; ``models/rwkv6.py``)

A cross block's decode state is its encoded memory (``CrossMemory``),
static during decode; a mamba block's its ``MambaState`` and an rwkv
block's its ``RWKVState``: a window of tokens steps their single-token
decode under per-row masks, as JAX scans it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.sharding import Rules, constrain

Tensor = torch.Tensor
Params = Dict[str, Any]
# A.AttnState, A.CrossMemory, M.MambaState or R.RWKVState
State = Any
NULL = Rules.null()


def _uses_moe(kind: str, cfg: ModelConfig) -> bool:
    return cfg.moe is not None and kind == "attn"


def block_params(kind: str, gen: torch.Generator, cfg: ModelConfig, *,
                 lead: Tuple[int, ...] = (), dtype=torch.float32) -> Params:
    """A block's parameters; ``shared_attn`` draws an attention block's
    (the LM draws it once, for ``params["shared"]``)."""
    if kind == "mamba":
        return {"norm1": L.norm_params(cfg.norm, cfg.d_model, lead=lead,
                                       dtype=dtype, device=gen.device),
                "mamba": M.mamba2_params(gen, cfg, lead=lead, dtype=dtype)}
    if kind == "rwkv":
        return R.rwkv6_params(gen, cfg, lead=lead, dtype=dtype)
    p = {"norm1": L.norm_params(cfg.norm, cfg.d_model, lead=lead,
                                dtype=dtype, device=gen.device),
         "norm2": L.norm_params(cfg.norm, cfg.d_model, lead=lead,
                                dtype=dtype, device=gen.device)}
    if kind == "cross":
        p["cross"] = A.cross_attention_params(gen, cfg, lead=lead,
                                              dtype=dtype)
        p["xgate"] = torch.zeros((*lead, 1), dtype=dtype, device=gen.device)
    else:
        p["attn"] = A.attention_params(gen, cfg, lead=lead, dtype=dtype)
    if _uses_moe(kind, cfg):
        p["moe"] = MOE.moe_params(gen, cfg, lead=lead, dtype=dtype)
    else:
        p["mlp"] = L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                lead=lead, dtype=dtype)
    return p


def block_param_specs(kind: str, cfg: ModelConfig) -> Params:
    """Logical sharding names, the tree of ``block_params``."""
    norm_spec = ({"scale": (None,)} if cfg.norm == "rmsnorm"
                 else {"scale": (None,), "bias": (None,)})
    if kind == "mamba":
        return {"norm1": norm_spec, "mamba": M.mamba2_param_specs(cfg)}
    if kind == "rwkv":
        return R.rwkv6_param_specs(cfg)
    p = {"norm1": dict(norm_spec), "norm2": dict(norm_spec)}
    if kind == "cross":
        p["cross"] = A.cross_attention_param_specs(cfg)
        p["xgate"] = (None,)
    else:
        p["attn"] = A.attention_param_specs(cfg)
    if _uses_moe(kind, cfg):
        p["moe"] = MOE.moe_param_specs(cfg)
    else:
        mlp = {"w_up": ("fsdp", "ffn"), "w_down": ("ffn", "fsdp")}
        if cfg.act == "swiglu":
            mlp["w_gate"] = ("fsdp", "ffn")
        p["mlp"] = mlp
    return p


def block_state_specs(kind: str, cfg: ModelConfig) -> Any:
    """Logical sharding names, the tree of ``block_state_init``."""
    if kind == "mamba":
        return M.mamba_state_specs(cfg)
    if kind == "rwkv":
        return R.rwkv_state_specs(cfg)
    if kind == "cross":
        if cfg.attention_backend == "softmax":
            return A.CrossMemory(
                k=("batch", "kv_heads_state", None, "head_dim_state"),
                v=("batch", "kv_heads_state", None, "head_dim_state"),
                c=None, z=None)
        return A.CrossMemory(k=None, v=None,
                             c=("batch", "kv_heads_state", None, None),
                             z=("batch", "kv_heads_state", None))
    return A.attn_state_specs(cfg)


def block_state_init(kind: str, cfg: ModelConfig, batch: int, *,
                     max_len: Optional[int] = None,
                     lead: Tuple[int, ...] = (), device=None,
                     rules: Optional[Rules] = None) -> State:
    """A block's zero decode state; under ``rules`` an attention
    block's linear state has its heads padded to the model axis."""
    if kind == "mamba":
        return M.init_mamba_state(cfg, batch, lead=lead, device=device)
    if kind == "rwkv":
        return R.init_rwkv_state(cfg, batch, lead=lead, device=device)
    if kind == "cross":
        return A.init_cross_memory(cfg, batch, lead=lead, device=device)
    return A.init_attn_state(cfg, batch, max_len=max_len, lead=lead,
                             device=device, rules=rules)


def _ffn(p: Params, x: Tensor, kind: str, cfg: ModelConfig,
         rules: Rules = NULL, *logical: Optional[str]
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """The second residual: x + MLP or MoE of norm2(x), the FFN's output
    constrained to ``logical`` on a mesh. Returns (x, the router's aux
    loss, None without MoE: JAX's zero, with no tensor made for it on
    every block and step)."""
    h2 = L.apply_norm(cfg.norm, p["norm2"], x)
    if _uses_moe(kind, cfg):
        ff, aux = MOE.moe_apply(p["moe"], h2, cfg, rules=rules)
        return x + constrain(ff, rules, *logical), aux
    h2 = _gather_seq(h2, rules)
    return x + constrain(L.mlp(p["mlp"], h2, cfg.act), rules, *logical), None


def _gather_seq(h: Tensor, rules: Rules) -> Tensor:
    """A block's normed input (B, T, D) whole along the sequence before
    its projections, on a mesh (Megatron's sequence parallelism: gather
    the sequence, project, split it again at the block's output)."""
    return constrain(h, rules, "batch", None, "embed") if h.ndim == 3 \
        else h


def _cross(p: Params, h1: Tensor, mem: A.CrossMemory, cfg: ModelConfig
           ) -> Tensor:
    att = A.cross_attention_apply(p["cross"], h1, mem, cfg)
    return torch.tanh(p["xgate"]).to(att.dtype) * att


def block_apply(kind: str, p: Params, x: Tensor, cfg: ModelConfig, *,
                shared: Optional[Params] = None,
                memory: Optional[Tensor] = None, want_state: bool = False,
                attention_kernel: bool = True,
                varlen: Optional[Tensor] = None, rules: Rules = NULL
                ) -> Tuple[Tensor, Optional[State], Optional[Tensor]]:
    """x: (B, T, D) → (x, state_or_None, aux: the router's load-balance
    loss, None for a block without MoE). ``shared``: the shared attention
    parameters, which a ``shared_attn`` block applies (``p`` unused).
    ``memory``: (B, N, D) in the compute type, which a cross block
    encodes (its state). ``varlen``: (B,) per-row valid lengths of an
    END-padded batch (attention blocks; the MoE routes every position,
    pads included, as JAX does). A mamba block prefills through B8's
    inclusive route and trains through B8/B9, an rwkv block prefills
    through B8's exclusive route (``attention_kernel``). ``rules``: the
    attention and FFN outputs are constrained to (batch, seq_sp, embed)
    on a mesh, as JAX does; a mamba or rwkv block runs its kernel on each
    rank's heads."""
    if kind == "shared_attn":
        p = shared
    if kind == "mamba":
        if varlen is not None:
            raise ValueError(f"{cfg.name}: varlen prefill of a mamba block")
        h, st = M.mamba2_apply(p["mamba"], _gather_seq(
                                   L.apply_norm(cfg.norm, p["norm1"], x),
                                   rules), cfg,
                               want_state=want_state,
                               kernel=attention_kernel, rules=rules)
        return x + constrain(h, rules, "batch", "seq_sp", "embed"), st, None
    if kind == "rwkv":
        if varlen is not None:
            raise ValueError(f"{cfg.name}: varlen prefill of an rwkv block")
        x, st = R.rwkv6_apply(p, _gather_seq(x, rules), cfg,
                              want_state=want_state,
                              attention_kernel=attention_kernel,
                              rules=rules)
        return x, st, None
    h1 = _gather_seq(L.apply_norm(cfg.norm, p["norm1"], x), rules)
    if kind == "cross":
        if varlen is not None:
            raise ValueError(f"{cfg.name}: varlen prefill of a cross block")
        if memory is None:
            raise ValueError(f"{cfg.name}: a cross block needs the memory "
                             f"(B, n_img_tokens, d_model) to attend to")
        mem = A.encode_cross_memory(p["cross"], memory, cfg)
        att, st = _cross(p, h1, mem, cfg), (mem if want_state else None)
    else:
        att, st = A.attention_apply(p["attn"], h1, cfg,
                                    want_state=want_state,
                                    attention_kernel=attention_kernel,
                                    varlen=varlen, rules=rules)
    sp = ("batch", "seq_sp", "embed")
    x, aux = _ffn(p, x + constrain(att, rules, *sp), kind, cfg, rules, *sp)
    return x, st, aux


def block_decode(kind: str, p: Params, x: Tensor, state: State,
                 pos: Tensor, cfg: ModelConfig, *,
                 shared: Optional[Params] = None,
                 active: Optional[Tensor] = None,
                 rules: Rules = NULL) -> Tuple[Tensor, State]:
    """x: (B, D) one token per sequence; pos: () or (B,); ``active``:
    (B,) bool slot mask, inactive rows keep their state bit for bit. The
    state is updated in place (a cross block's memory is static).
    ``rules``: as in ``block_apply``."""
    if kind == "shared_attn":
        p = shared
    if kind == "mamba":
        h, st = M.mamba2_decode(p["mamba"],
                                L.apply_norm(cfg.norm, p["norm1"], x),
                                state, cfg, active=active, rules=rules)
        return x + h, st
    if kind == "rwkv":
        return R.rwkv6_decode(p, x, state, cfg, active=active, rules=rules)
    h1 = L.apply_norm(cfg.norm, p["norm1"], x)
    if kind == "cross":
        att, st = _cross(p, h1[:, None], state, cfg)[:, 0], state
    else:
        att, st = A.attention_decode(p["attn"], h1, state, pos, cfg,
                                     active=active, rules=rules)
    return _ffn(p, x + att, kind, cfg, rules, "batch", "embed")[0], st


def block_decode_window(kind: str, p: Params, x: Tensor, state: State,
                        pos0: Tensor, cfg: ModelConfig, *,
                        shared: Optional[Params] = None,
                        lens: Optional[Tensor] = None
                        ) -> Tuple[Tensor, State]:
    """x: (B, W, D) — W known tokens per sequence, one fused kernel launch
    per attention block for the linear family; a cross block looks each
    position up in its static memory. Under softmax the attention steps
    single-token decode over the window, as JAX scans ``block_decode``:
    a dense MLP is per token, so running it once over the window is the
    same function, but an MoE FFN's capacity follows the tokens of the
    call, so it runs once per step, on B tokens, as in JAX's scan.
    ``lens``: (B,) per-row valid window lengths. A mamba or rwkv block
    steps its single-token decode over the window, step w active where
    w < lens (JAX's scan). A ``shared_attn`` block applies ``shared``.
    The state is updated in place."""
    if kind == "shared_attn":
        p = shared
    if kind in ("mamba", "rwkv"):
        ys = [block_decode(kind, p, x[:, w], state, pos0, cfg,
                           active=None if lens is None else w < lens)[0]
              for w in range(x.shape[1])]
        return torch.stack(ys, dim=1), state
    h1 = L.apply_norm(cfg.norm, p["norm1"], x)
    if kind == "cross":
        att, st = _cross(p, h1, state, cfg), state
    else:
        att, st = A.attention_decode_window(p["attn"], h1, state, pos0,
                                            cfg, lens=lens)
    x = x + att
    if _uses_moe(kind, cfg) and cfg.attention_backend == "softmax":
        return torch.stack([_ffn(p, x[:, i], kind, cfg)[0]
                            for i in range(x.shape[1])], dim=1), st
    return _ffn(p, x, kind, cfg)[0], st


def block_ingest_window(kind: str, p: Params, x: Tensor, state: State,
                        pos0: Tensor, cfg: ModelConfig, *,
                        shared: Optional[Params] = None,
                        lens: Optional[Tensor] = None
                        ) -> Tuple[Tensor, State]:
    """Like :func:`block_decode_window`, but with ``lens`` the linear
    family's attention (``attn`` and ``shared_attn``) continues its state
    through the chunk-parallel prefill forms (``attention_ingest_window``)
    instead of the recurrence; softmax, cross, mamba and rwkv blocks keep
    the window path. The state is updated in place."""
    if lens is None or kind not in ("attn", "shared_attn") or \
            cfg.attention_backend == "softmax":
        return block_decode_window(kind, p, x, state, pos0, cfg,
                                   shared=shared, lens=lens)
    if kind == "shared_attn":
        p = shared
    h1 = L.apply_norm(cfg.norm, p["norm1"], x)
    att, st = A.attention_ingest_window(p["attn"], h1, state, pos0, cfg,
                                        lens=lens)
    return _ffn(p, x + att, kind, cfg)[0], st
