"""Language model over a stack of ``attn`` blocks (port of
``repro/models/lm.py``: training forward and loss, prefill, decode and
generation).

Parameters and states keep the JAX package's tree: ``embed`` (V, D),
``stack`` — a tuple with one entry per ``layer_pattern`` position whose
leaves carry a leading repeat axis R — ``tail``, ``final_norm`` and
``lm_head`` unless embeddings are tied. Layer r of a stacked group is
the view ``leaf[r]``, so the decode kernels and the softmax cache
writes update a layer's state inside the stacked tensor in place.

Unlike the JAX functions, which are pure, every decode function here
updates the decode state it is given in place and returns it: the state
of the whole model is hundreds of MiB at full width, and a copy per
token would cost more than the decode itself.

Training differentiates ``lm_loss`` with autograd. Under
``cfg.remat == "unit"`` each repeat of the layer pattern is a
``torch.utils.checkpoint`` region that keeps only its input and runs its
forward again in the backward, as ``jax.checkpoint`` with
``nothing_saveable`` does in JAX; the linear attention's own backward
(B3) recomputes its states and keeps only (q, k, v).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.attention import AttnState
from repro_torch.tree import leaves

Tensor = torch.Tensor
Params = Dict[str, Any]
State = Dict[str, Tuple[AttnState, ...]]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _at(tree: Any, r: int) -> Any:
    """Layer r of a stacked parameter or state tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    if isinstance(tree, AttnState):
        return AttnState(*(None if x is None else x[r] for x in tree))
    return tree[r]


def _stack_states(states) -> AttnState:
    return AttnState(*(None if xs[0] is None else torch.stack(xs)
                       for xs in zip(*states)))


# ---------------------------------------------------------------------------
# parameters and state
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters drawn from ``gen``, on ``gen.device``, in
    ``cfg.param_dtype``."""
    pdt = dtype_of(cfg.param_dtype)
    pattern, reps, tail = cfg.pattern_and_repeats
    params: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=pdt),
        "final_norm": L.rmsnorm_params(cfg.d_model, dtype=pdt,
                                       device=gen.device),
        "stack": tuple(B.block_params(kind, gen, cfg, lead=(reps,),
                                      dtype=pdt) for kind in pattern),
        "tail": tuple(B.block_params(kind, gen, cfg, dtype=pdt)
                      for kind in tail),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype=pdt)
    return params


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast float matrices (ndim ≥ 2) to the compute dtype; norm scales
    and other vectors stay fp32. Tensors already in ``dtype`` are reused,
    not copied."""
    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(cast(v) for v in x)
        if x.ndim >= 2 and x.is_floating_point():
            return x.to(dtype)
        return x
    return cast(params)


def init_decode_state(cfg: ModelConfig, batch: int, *,
                      max_len: Optional[int] = None, device=None) -> State:
    """Zero decode state for the whole stack. softmax: per-layer KV
    caches of ``max_len`` rows (required), O(max_len) memory. Linear
    family: fixed-size (Dk×Dv per head) matrices, O(1) in context length
    (``max_len`` ignored)."""
    pattern, reps, tail = cfg.pattern_and_repeats
    return {
        "stack": tuple(B.block_state_init(k, cfg, batch, max_len=max_len,
                                          lead=(reps,), device=device)
                       for k in pattern),
        "tail": tuple(B.block_state_init(k, cfg, batch, max_len=max_len,
                                         device=device) for k in tail),
    }


def pad_decode_state(states: State, cfg: ModelConfig, max_len: int) -> State:
    """Grow prefill KV caches to ``max_len`` rows with zeros, one new
    allocation per cache (softmax only; the linear family's states are
    fixed-size and come back as they are). The rows are the S axis of
    (…, S, Hkv, Dh); stacked groups have a leading repeat axis."""
    def fix(st: AttnState) -> AttnState:
        if st.k_cache is None:
            return st
        pad = max_len - st.k_cache.shape[st.k_cache.ndim - 3]
        if pad <= 0:
            return st
        grow = (0, 0, 0, 0, 0, pad)              # (Dh, Hkv, S) from the end
        return st._replace(k_cache=F.pad(st.k_cache, grow),
                           v_cache=F.pad(st.v_cache, grow))
    return {part: tuple(fix(st) for st in group)
            for part, group in states.items()}


def param_count(params: Params) -> int:
    return sum(x.numel() for x in leaves(params))


def state_bytes(states: State) -> int:
    return sum(t.nbytes for group in states.values() for st in group
               for t in st if t is not None)


# ---------------------------------------------------------------------------
# forward (training and prefill)
# ---------------------------------------------------------------------------

def _head(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    adt = dtype_of(cfg.dtype)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x.to(adt) @ head.to(adt)


def _trunk(params: Params, tokens: Tensor, cfg: ModelConfig,
           want_state: bool, attention_kernel: bool = True
           ) -> Tuple[Tensor, Optional[State]]:
    """Embed + every block. Returns (hidden (B, T, D), states|None).
    Without states and with autograd on, ``cfg.remat == "unit"``
    checkpoints each repeat of the pattern."""
    pattern, reps, tail = cfg.pattern_and_repeats
    x = params["embed"][tokens]

    def unit(x, unit_params):
        states = []
        for kind, p in zip(pattern, unit_params):
            x, st = B.block_apply(kind, p, x, cfg, want_state=want_state,
                                  attention_kernel=attention_kernel)
            states.append(st)
        return x, states

    remat = (cfg.remat == "unit" and not want_state
             and torch.is_grad_enabled())
    stack_states = [[] for _ in pattern]
    for r in range(reps):
        unit_params = [_at(group, r) for group in params["stack"]]
        if remat:
            # the model draws no random numbers: no RNG state to replay
            x = checkpoint(lambda x, up: unit(x, up)[0], x, unit_params,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        x, states = unit(x, unit_params)
        for i, st in enumerate(states):
            stack_states[i].append(st)
    tail_states = []
    for i, kind in enumerate(tail):
        x, st = B.block_apply(kind, params["tail"][i], x, cfg,
                              want_state=want_state,
                              attention_kernel=attention_kernel)
        tail_states.append(st)
    if not want_state:
        return x, None
    return x, {"stack": tuple(_stack_states(s) for s in stack_states),
               "tail": tuple(tail_states)}


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            want_state: bool = False, attention_kernel: bool = True
            ) -> Tuple[Tensor, Optional[State]]:
    """tokens: (B, T) int → (logits (B, T, V), states|None). Float
    matrices are cast to ``cfg.dtype`` once, outside the blocks, and
    gradients flow through the cast to the fp32 master parameters.
    ``attention_kernel=False`` runs the linear attention's plain versions
    on CUDA tensors (the training slice's reference route)."""
    params = cast_params(params, dtype_of(cfg.dtype))
    x, states = _trunk(params, tokens, cfg, want_state, attention_kernel)
    return _head(params, x, cfg), states


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: Tensor, labels: Tensor, z_loss: float = 0.0
                  ) -> Tensor:
    """Mean token cross-entropy, in fp32, the max taken out of the graph
    (JAX ``cross_entropy``); the label's logit is gathered, which gives
    the same value as JAX's masked sum without a (B, T, V) mask."""
    lf = logits.float()
    m = lf.max(dim=-1, keepdim=True).values.detach()
    sum_exp = torch.exp(lf - m).sum(dim=-1)
    lse = torch.log(sum_exp) + m[..., 0]
    label_logit = lf.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    if z_loss:
        nll = nll + z_loss * torch.square(torch.log(sum_exp) + m[..., 0])
    return nll.mean()


def lm_loss(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig, *,
            attention_kernel: bool = True
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """batch: {"tokens": (B, T), "labels": (B, T)} → (loss, {"xent",
    "aux"}). The port has no MoE, so aux is 0."""
    logits, _ = forward(params, batch["tokens"], cfg,
                        attention_kernel=attention_kernel)
    xent = cross_entropy(logits, batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    return xent + aux_w * aux, {"xent": xent, "aux": aux}


def prefill(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            attention_kernel: bool = True) -> Tuple[Tensor, State]:
    """Encode a prompt into the per-layer decode states: the fixed-size
    states of the linear family, or the softmax KV caches of the prompt's
    length (``pad_decode_state`` grows them). Returns (last-position
    logits (B, V), decode states); the head runs on the last position
    only. ``attention_kernel=False`` runs softmax prefill through B10's
    plain version on CUDA tensors (the reference route)."""
    params = cast_params(params, dtype_of(cfg.dtype))
    x, states = _trunk(params, tokens, cfg, want_state=True,
                       attention_kernel=attention_kernel)
    return _head(params, x[:, -1], cfg), states


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_blocks(params: Params, state: State, x: Tensor, pos: Tensor,
                   cfg: ModelConfig, block_fn, **block_kw) -> Tensor:
    """Run ``block_fn`` (single-token or window decode) through every
    block, updating each layer's state view in place."""
    pattern, reps, tail = cfg.pattern_and_repeats
    for r in range(reps):
        for i, kind in enumerate(pattern):
            x, _ = block_fn(kind, _at(params["stack"][i], r), x,
                            _at(state["stack"][i], r), pos, cfg, **block_kw)
    for i, kind in enumerate(tail):
        x, _ = block_fn(kind, params["tail"][i], x, state["tail"][i], pos,
                        cfg, **block_kw)
    return x


def decode_step(params: Params, state: State, token: Tensor, pos,
                cfg: ModelConfig) -> Tuple[Tensor, State]:
    """One autoregressive step. token: (B,) int; pos: () shared position
    or (B,) per-sequence positions. Returns (logits (B, V), state) with
    the state updated in place. O(k²) per layer for the linear family,
    independent of pos; O(pos) for the softmax KV cache."""
    params = cast_params(params, dtype_of(cfg.dtype))
    x = params["embed"][token].to(dtype_of(cfg.dtype))
    x = _decode_blocks(params, state, x, pos, cfg, B.block_decode)
    return _head(params, x, cfg), state


def sample_token(logits: Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> Tensor:
    """logits: (B, V) → (B,) int64. temperature 0.0 = greedy (argmax,
    first maximum on ties); > 0 = categorical draw from ``generator``."""
    if temperature and temperature > 0.0:
        if generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(params: Params, state: State, tok0: Tensor, pos0: int,
             n_steps: int, cfg: ModelConfig, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[Tensor, State]:
    """``n_steps`` autoregressive decode steps from token ``tok0`` (B,) at
    position ``pos0``. Returns (tokens (B, n_steps), state) where
    tokens[:, i] is the token sampled after consuming the i-th input; the
    state is updated in place. Under the linear family each step launches
    the decode kernel once per layer; under softmax each step writes one
    KV-cache row per layer, which must have room for pos0 + n_steps rows
    (``pad_decode_state``)."""
    if temperature and temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    params = cast_params(params, dtype_of(cfg.dtype))   # once, not per step
    positions = torch.arange(pos0, pos0 + n_steps, dtype=torch.int32,
                             device=tok0.device)
    tok = tok0
    toks = []
    for pos in positions:
        logits, state = decode_step(params, state, tok, pos, cfg)
        tok = sample_token(logits, temperature, generator)
        toks.append(tok)
    if not toks:
        return tok0.new_zeros((tok0.shape[0], 0)), state
    return torch.stack(toks, dim=1), state


def _window_forward(params: Params, state: State, tokens: Tensor, pos0,
                    cfg: ModelConfig, **block_kw) -> Tuple[Tensor, State]:
    params = cast_params(params, dtype_of(cfg.dtype))
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    x = _decode_blocks(params, state, x, pos0, cfg, B.block_decode_window,
                       **block_kw)
    return _head(params, x, cfg), state


def decode_window(params: Params, state: State, tokens: Tensor, pos0,
                  cfg: ModelConfig) -> Tuple[Tensor, State]:
    """Advance the state over W known tokens, one fused kernel launch per
    layer. tokens: (B, W); pos0: () or (B,) start positions. Returns
    (logits (B, W, V), state), logits[:, i] the next-token distribution
    after tokens[:, i]; the state is updated in place."""
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=tokens.device)
    return _window_forward(params, state, tokens, pos0, cfg)


def decode_window_varlen(params: Params, state: State, tokens: Tensor, pos0,
                         lens, cfg: ModelConfig, *,
                         active: Optional[Tensor] = None
                         ) -> Tuple[Tensor, State]:
    """Variable-length window: row b consumes tokens[b, :lens[b]] from
    position pos0[b] (0 ≤ lens ≤ W); ``active`` False rows behave as
    lens = 0. Masked rows and steps leave the state bit for bit as it was;
    their logits are garbage. Returns (logits (B, W, V), state)."""
    b, w = tokens.shape
    pos0 = torch.as_tensor(pos0, dtype=torch.int32,
                           device=tokens.device).expand(b)
    lens = torch.as_tensor(lens, device=tokens.device).to(torch.int32)
    lens = lens.clamp(0, w)
    if active is not None:
        lens = torch.where(torch.as_tensor(active, device=tokens.device),
                           lens, 0)
    return _window_forward(params, state, tokens, pos0, cfg, lens=lens)
