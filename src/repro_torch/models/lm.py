"""Language model over a stack of ``attn``, ``shared_attn``, ``cross``,
``mamba`` and ``rwkv`` blocks (port of ``repro/models/lm.py``: training
forward and loss, prefill, decode and generation, and the
continuous-batching surface of the serving engine: bucket-padded varlen
prefill, slot-masked segments, varlen windows and the per-slot state
copies).

Parameters and states keep the JAX package's tree: ``embed`` (V, D),
``stack`` — a tuple with one entry per ``layer_pattern`` position whose
leaves carry a leading repeat axis R — ``tail``, ``final_norm``,
``lm_head`` unless embeddings are tied, and ``shared``: one attention
block's parameters that every ``shared_attn`` site applies (Zamba-style;
its entries in ``stack`` and ``tail`` are empty), present only when the
pattern has such a site. Layer r of a stacked group is
the view ``leaf[r]``, so the decode kernels and the softmax cache
writes update a layer's state inside the stacked tensor in place.

Unlike the JAX functions, which are pure, every decode function here
updates the decode state it is given in place and returns it: the state
of the whole model is hundreds of MiB at full width, and a copy per
token would cost more than the decode itself.

``memory`` (B, N, D), the modality memory of ``cross`` blocks, is cast to
the compute type once; each cross block encodes it into its state
(``CrossMemory``), which decode reads and never changes. The MoE blocks'
router aux losses are summed over the stack into ``lm_loss``.

Training differentiates ``lm_loss`` with autograd. Under
``cfg.remat == "unit"`` each repeat of the layer pattern is a
``torch.utils.checkpoint`` region that keeps only its input and runs its
forward again in the backward, as ``jax.checkpoint`` with
``nothing_saveable`` does in JAX; the linear attention's own backward
(B3) recomputes its states and keeps only (q, k, v), and the softmax
attention's (JAX's blockwise ``_flash_bwd``) keeps (q, k, v, o, lse).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.attention import AttnState, CrossMemory
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.rwkv6 import RWKVState
from repro_torch.sharding import (
    Rules, constrain, distribute, distribute_tree, is_dtensor,
    is_logical_spec, map_local, replicate_mixed, replicated_like)
from repro_torch.tree import leaves

Tensor = torch.Tensor
Params = Dict[str, Any]
# per block: AttnState (attn, shared_attn), CrossMemory for a cross block,
# MambaState for mamba, RWKVState for rwkv
State = Dict[str, Tuple[Any, ...]]
_STATES = (AttnState, CrossMemory, MambaState, RWKVState)
NULL = Rules.null()


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _at(tree: Any, r: int) -> Any:
    """Layer r of a stacked parameter or state tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    if isinstance(tree, _STATES):
        return type(tree)(*(None if x is None else x[r] for x in tree))
    return tree[r]


def _stack_states(states):
    return type(states[0])(*(None if xs[0] is None else torch.stack(xs)
                             for xs in zip(*states)))


# ---------------------------------------------------------------------------
# parameters and state
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters drawn from ``gen``, on ``gen.device``, in
    ``cfg.param_dtype``. A ``shared_attn`` site holds ``{}``; the
    attention block it applies is ``params["shared"]``."""
    pdt = dtype_of(cfg.param_dtype)
    pattern, reps, tail = cfg.pattern_and_repeats

    def block(kind, lead=()):
        return ({} if kind == "shared_attn" else
                B.block_params(kind, gen, cfg, lead=lead, dtype=pdt))
    params: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=pdt),
        "final_norm": L.norm_params(cfg.norm, cfg.d_model, dtype=pdt,
                                    device=gen.device),
        "stack": tuple(block(kind, (reps,)) for kind in pattern),
        "tail": tuple(block(kind) for kind in tail),
    }
    if "shared_attn" in pattern + tail:
        params["shared"] = B.block_params("attn", gen, cfg, dtype=pdt)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype=pdt)
    return params


def _stacked(tree):
    """Prepend the stacked-layers axis to every leaf spec."""
    if is_logical_spec(tree):
        return ("layers",) + tree
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    if tree is None:
        return None
    return type(tree)(*(_stacked(v) for v in tree))


def param_specs(cfg: ModelConfig) -> Params:
    """Logical sharding names, the tree of ``init_params`` (JAX
    ``param_specs``)."""
    pattern, _, tail = cfg.pattern_and_repeats
    specs: Params = {
        "embed": ("vocab", "embed"),
        "final_norm": ({"scale": (None,)} if cfg.norm == "rmsnorm"
                       else {"scale": (None,), "bias": (None,)}),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    specs["stack"] = tuple(
        {} if kind == "shared_attn"
        else _stacked(B.block_param_specs(kind, cfg)) for kind in pattern)
    specs["tail"] = tuple(
        {} if kind == "shared_attn" else B.block_param_specs(kind, cfg)
        for kind in tail)
    if "shared_attn" in pattern + tail:
        specs["shared"] = B.block_param_specs("attn", cfg)
    return specs


def decode_state_specs(cfg: ModelConfig) -> Any:
    """Logical sharding names, the tree of ``init_decode_state`` (JAX
    ``decode_state_specs``)."""
    pattern, _, tail = cfg.pattern_and_repeats
    return {
        "stack": tuple(_stacked(B.block_state_specs(k, cfg))
                       for k in pattern),
        "tail": tuple(B.block_state_specs(k, cfg) for k in tail),
    }


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
                      max_len: Optional[int] = None, device=None,
                      rules: Optional[Rules] = None) -> State:
    """Zero decode state for the whole stack. softmax: per-layer KV
    caches of ``max_len`` rows (required), O(max_len) memory. Linear
    family: fixed-size (Dk×Dv per head) matrices, O(1) in context length
    (``max_len`` ignored). A cross block: its zero memory (K and V of
    ``n_img_tokens`` rows, or C and z). Under ``rules`` the linear
    family's state heads are padded to a multiple of the model axis (JAX
    ``padded_head_count``), and on a mesh every leaf is placed by
    ``decode_state_specs``."""
    pattern, reps, tail = cfg.pattern_and_repeats
    state = {
        "stack": tuple(B.block_state_init(k, cfg, batch, max_len=max_len,
                                          lead=(reps,), device=device,
                                          rules=rules)
                       for k in pattern),
        "tail": tuple(B.block_state_init(k, cfg, batch, max_len=max_len,
                                         device=device, rules=rules)
                      for k in tail),
    }
    if rules is None or not rules.on_mesh:
        return state
    return distribute_tree(state, decode_state_specs(cfg), rules)


def pad_decode_state(states: State, cfg: ModelConfig, max_len: int) -> State:
    """Grow prefill KV caches to ``max_len`` rows with zeros, one new
    allocation per cache (softmax only; the linear family's states are
    fixed-size and come back as they are, as do cross memories). The rows
    are the S axis of (…, S, Hkv, Dh); stacked groups have a leading
    repeat axis."""
    def fix(st):
        if not isinstance(st, AttnState) or st.k_cache is None:
            return st
        axis = st.k_cache.ndim - 3
        pad = max_len - st.k_cache.shape[axis]
        if pad <= 0:
            return st
        grow = (0, 0, 0, 0, 0, pad)              # (Dh, Hkv, S) from the end
        shape = list(st.k_cache.shape)
        shape[axis] = max_len
        # on a mesh each rank grows its block (the rows are not split)
        return st._replace(
            k_cache=map_local(lambda c: F.pad(c, grow), st.k_cache, shape),
            v_cache=map_local(lambda c: F.pad(c, grow), st.v_cache, shape))
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

def _head(params: Params, x: Tensor, cfg: ModelConfig,
          rules: Rules = NULL, *logical: Optional[str]) -> Tensor:
    """Final norm and the (tied) head; the logits constrained to
    ``logical`` on a mesh."""
    adt = dtype_of(cfg.dtype)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    if x.ndim == 3:     # on a mesh: the sequence whole before the product
        x = constrain(x, rules, "batch", None, "embed")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x.to(adt) @ head.to(adt), rules, *logical)


def _embed(params: Params, tokens: Tensor, rules: Rules) -> Tensor:
    """Rows of the embedding; on a mesh the vocab-sharded lookup of
    DTensor's ``embedding`` (each rank looks up its rows, a sum over
    the model axis completes them)."""
    if rules.on_mesh:
        return F.embedding(tokens, params["embed"])
    return params["embed"][tokens]


def _on_mesh(fn):
    """Run a model entry point with plain tensors (positions, masks)
    counting as replicated when its rules place tensors on a mesh."""
    @functools.wraps(fn)
    def wrapped(*args, rules: Rules = NULL, **kw):
        if not rules.on_mesh:
            return fn(*args, rules=rules, **kw)
        with replicate_mixed():
            return fn(*args, rules=rules, **kw)
    return wrapped


def _batch(x: Optional[Tensor], rules: Rules, *logical: Optional[str]):
    """A batch input placed by its logical names on a mesh (a DTensor
    as it comes)."""
    if x is None or not rules.on_mesh or is_dtensor(x):
        return x
    return distribute(x, rules, *logical)


def _add(aux: Optional[Tensor], a: Optional[Tensor]) -> Optional[Tensor]:
    return aux if a is None else a if aux is None else aux + a


def _trunk(params: Params, tokens: Tensor, cfg: ModelConfig,
           want_state: bool, attention_kernel: bool = True,
           varlen: Optional[Tensor] = None, memory: Optional[Tensor] = None,
           rules: Rules = NULL) -> Tuple[Tensor, Tensor, Optional[State]]:
    """Embed + every block. Returns (hidden (B, T, D), aux (), states|None)
    with aux the sum of the MoE blocks' router losses (0 without MoE).
    Without states and with autograd on, ``cfg.remat == "unit"``
    checkpoints each repeat of the pattern, its aux an output of the
    region. ``varlen``: (B,) per-row valid lengths of an END-padded
    batch. ``memory``: (B, N, D) for cross blocks, in the compute
    type. On a mesh the residual stream is constrained to (batch,
    seq_sp, embed) after the embedding and after every block, as JAX
    does."""
    pattern, reps, tail = cfg.pattern_and_repeats
    x = constrain(_embed(params, tokens, rules), rules,
                  "batch", "seq_sp", "embed")
    kw = dict(shared=params.get("shared"), memory=memory,
              want_state=want_state, attention_kernel=attention_kernel,
              varlen=varlen, rules=rules)

    def unit(x, unit_params):
        states, aux = [], None
        for kind, p in zip(pattern, unit_params):
            x, st, a = B.block_apply(kind, p, x, cfg, **kw)
            x = constrain(x, rules, "batch", "seq_sp", "embed")
            states.append(st)
            aux = _add(aux, a)
        return x, aux, states

    remat = (cfg.remat == "unit" and not want_state
             and torch.is_grad_enabled())
    stack_states = [[] for _ in pattern]
    aux = None
    for r in range(reps):
        unit_params = [_at(group, r) for group in params["stack"]]
        if remat:
            # the model draws no random numbers: no RNG state to replay
            x, a = checkpoint(lambda x, up: unit(x, up)[:2], x, unit_params,
                              use_reentrant=False, preserve_rng_state=False)
            aux = _add(aux, a)
            continue
        x, a, states = unit(x, unit_params)
        aux = _add(aux, a)
        for i, st in enumerate(states):
            stack_states[i].append(st)
    tail_states = []
    for i, kind in enumerate(tail):
        x, st, a = B.block_apply(kind, params["tail"][i], x, cfg, **kw)
        x = constrain(x, rules, "batch", "seq_sp", "embed")
        aux = _add(aux, a)
        tail_states.append(st)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not want_state:
        return x, aux, None
    return x, aux, {"stack": tuple(_stack_states(s) for s in stack_states),
                    "tail": tuple(tail_states)}


def _memory(memory: Optional[Tensor], cfg: ModelConfig) -> Optional[Tensor]:
    return None if memory is None else memory.to(dtype_of(cfg.dtype))


@_on_mesh
def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            memory: Optional[Tensor] = None, want_state: bool = False,
            attention_kernel: bool = True, varlen: Optional[Tensor] = None,
            rules: Rules = NULL) -> Tuple[Tensor, Optional[State]]:
    """tokens: (B, T) int → (logits (B, T, V), states|None); ``lm_loss``
    reads the router aux loss JAX's ``forward`` also returns. Float
    matrices are cast to ``cfg.dtype`` once, outside the blocks, and
    gradients flow through the cast to the fp32 master parameters; so is
    ``memory`` (B, N, D), the cross blocks' modality memory.
    ``attention_kernel=False`` runs the linear attention's plain versions
    on CUDA tensors (the training slice's reference route). ``varlen``:
    (B,) per-row valid lengths of an END-padded batch; logits at pad
    positions are garbage. ``rules``: as in ``lm_loss``."""
    params = cast_params(params, dtype_of(cfg.dtype))
    x, _, states = _trunk(params, _batch(tokens, rules, "batch", None), cfg,
                          want_state, attention_kernel, varlen,
                          _memory(_batch(memory, rules, "batch", None,
                                         "embed"), cfg), rules)
    return _head(params, x, cfg, rules, "batch", "seq_sp", None), states


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _nll(lf: Tensor, labels: Tensor, z_loss: float) -> Tensor:
    """Per-position token cross-entropy of fp32 logits with a whole
    vocab, the max taken out of the graph; the label's logit gathered."""
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    nll = lse - lf.gather(-1, labels[..., None].long())[..., 0]
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll


def cross_entropy(logits: Tensor, labels: Tensor, z_loss: float = 0.0
                  ) -> Tensor:
    """Mean token cross-entropy, in fp32, the max taken out of the graph
    (JAX ``cross_entropy``); the label's logit is gathered, which gives
    the same value as JAX's masked sum without a (B, T, V) mask.

    On a mesh (DTensor logits) whose vocab is whole on every rank (the
    loss's (batch, seq_sp, None) logits) each rank sums its own rows'
    losses (``local_map``; the labels split as the logits' rows) and
    the sum is a partial one over the mesh: no rank holds another's
    logits or their gradient. Logits split on the vocab take JAX's
    masked sum, which reduces over a sharded vocab as a sum does."""
    lf = logits.float()
    if not is_dtensor(lf):
        return _nll(lf, labels, z_loss).mean()
    mesh, last = lf.device_mesh, lf.ndim - 1
    if is_dtensor(labels) and not any(p.is_shard(last) or p.is_partial()
                                      for p in lf.placements):
        from torch.distributed.tensor import Partial
        from torch.distributed.tensor.experimental import local_map
        labels = labels.redistribute(mesh, lf.placements)
        total = local_map(
            lambda a, b: _nll(a, b, z_loss).sum(),
            out_placements=[Partial()] * mesh.ndim,
            in_placements=(tuple(lf.placements), tuple(labels.placements)),
            device_mesh=mesh)(lf, labels)
        return total / labels.numel()
    m = lf.max(dim=-1, keepdim=True).values.detach()
    sum_exp = torch.exp(lf - m).sum(dim=-1)
    lse = torch.log(sum_exp) + m[..., 0]
    col = replicated_like(torch.arange(lf.shape[-1], device=lf.device), lf)
    label_logit = torch.where(col == labels[..., None], lf, 0.0).sum(-1)
    nll = lse - label_logit
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll.mean()


@_on_mesh
def lm_loss(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig, *,
            attention_kernel: bool = True, rules: Rules = NULL
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """batch: {"tokens": (B, T), "labels": (B, T) [, "memory": (B, N, D)]}
    → (loss, {"xent", "aux"}): the token cross-entropy plus
    ``router_aux_weight`` times the MoE blocks' summed load-balance loss
    (aux 0 without MoE).

    ``rules`` (JAX's ``rules``; default null): on a mesh the parameters
    are DTensors placed by ``param_specs``, the batch is sharded on
    ``batch`` (plain tensors are placed here), and the loss is a
    replicated DTensor."""
    params = cast_params(params, dtype_of(cfg.dtype))
    tokens = _batch(batch["tokens"], rules, "batch", None)
    labels = _batch(batch["labels"], rules, "batch", None)
    memory = _batch(batch.get("memory"), rules, "batch", None, "embed")
    x, aux, _ = _trunk(params, tokens, cfg, False, attention_kernel,
                       memory=_memory(memory, cfg), rules=rules)
    xent = cross_entropy(_head(params, x, cfg, rules, "batch", "seq_sp",
                               None), labels)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    return xent + aux_w * aux, {"xent": xent, "aux": aux}


@_on_mesh
def prefill(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            memory: Optional[Tensor] = None, attention_kernel: bool = True,
            rules: Rules = NULL) -> Tuple[Tensor, State]:
    """Encode a prompt into the per-layer decode states: the fixed-size
    states of the linear family, or the softmax KV caches of the prompt's
    length (``pad_decode_state`` grows them); a cross block's state is
    ``memory`` (B, N, D) encoded once. Returns (last-position logits
    (B, V), decode states); the head runs on the last position only.
    ``attention_kernel=False`` runs softmax prefill through B10's plain
    version on CUDA tensors (the reference route). ``rules``: as in
    ``lm_loss``; the states come back as DTensors."""
    params = cast_params(params, dtype_of(cfg.dtype))
    x, _, states = _trunk(params, _batch(tokens, rules, "batch", None), cfg,
                          want_state=True, attention_kernel=attention_kernel,
                          memory=_memory(_batch(memory, rules, "batch", None,
                                                "embed"), cfg), rules=rules)
    return _head(params, x[:, -1], cfg, rules, "batch", "vocab"), states


def supports_varlen_prefill(cfg: ModelConfig) -> bool:
    """True when every block kind masks pad positions under per-row
    varlen prefill (attention blocks only)."""
    pattern, _, tail = cfg.pattern_and_repeats
    return set(pattern) | set(tail) <= {"attn", "shared_attn"}


def _rows_at(x: Tensor, idx: Tensor) -> Tensor:
    """x: (B, T, D), idx: (B,) → x[b, idx[b]] as (B, D)."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def prefill_varlen(params: Params, tokens: Tensor, lens, cfg: ModelConfig,
                   *, attention_kernel: bool = True) -> Tuple[Tensor, State]:
    """Batched bucket-padded prefill: B prompts of different lengths in
    one pass. tokens: (B, W), row b's prompt END-padded to W; lens: (B,)
    true lengths (lens = 0 rows are dummies with zero linear states).
    Pad positions add nothing to any state, so each row's state is that
    of prefilling the row alone. Returns (logits at each row's last
    valid position (B, V), decode states); the head runs on those rows
    only, never on the (B, W, V) logits."""
    if not supports_varlen_prefill(cfg):
        raise ValueError(f"{cfg.name}: varlen prefill needs an "
                         f"attention-only layer pattern")
    lens = torch.as_tensor(lens, device=tokens.device).to(torch.int32)
    params = cast_params(params, dtype_of(cfg.dtype))
    x, _, states = _trunk(params, tokens, cfg, want_state=True,
                          attention_kernel=attention_kernel, varlen=lens)
    return _head(params, _rows_at(x, (lens - 1).clamp(min=0)), cfg), states


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_blocks(params: Params, state: State, x: Tensor, pos: Tensor,
                   cfg: ModelConfig, block_fn, **block_kw) -> Tensor:
    """Run ``block_fn`` (single-token or window decode) through every
    block, updating each layer's state view in place."""
    pattern, reps, tail = cfg.pattern_and_repeats
    block_kw["shared"] = params.get("shared")
    for r in range(reps):
        for i, kind in enumerate(pattern):
            x, _ = block_fn(kind, _at(params["stack"][i], r), x,
                            _at(state["stack"][i], r), pos, cfg, **block_kw)
    for i, kind in enumerate(tail):
        x, _ = block_fn(kind, params["tail"][i], x, state["tail"][i], pos,
                        cfg, **block_kw)
    return x


@_on_mesh
def decode_step(params: Params, state: State, token: Tensor, pos,
                cfg: ModelConfig, *, active: Optional[Tensor] = None,
                rules: Rules = NULL) -> Tuple[Tensor, State]:
    """One autoregressive step. token: (B,) int; pos: () shared position
    or (B,) per-sequence positions. Returns (logits (B, V), state) with
    the state updated in place. O(k²) per layer for the linear family,
    independent of pos; O(pos) for the softmax KV cache. ``active``: (B,)
    bool slot mask; inactive rows keep their state bit for bit (their
    logits are garbage).

    ``rules``: on a mesh the parameters and the state (``init_decode_state``
    with the same rules) are DTensors; the token is one-hot against the
    vocab-sharded embedding when the model axis is larger than 1 (JAX's
    choice: a local (B, V/m) product and a small sum instead of a gather
    of the table), and each kernel runs on the rank's own heads."""
    adt = dtype_of(cfg.dtype)
    params = cast_params(params, adt)
    if rules.model_size > 1:
        onehot = F.one_hot(token.long(), cfg.vocab_size).to(adt)
        onehot = constrain(_batch(onehot, rules, "batch", "vocab"), rules,
                           "batch", "vocab")
        x = onehot @ params["embed"].to(adt)
    else:
        x = _embed(params, _batch(token, rules, "batch"), rules).to(adt)
    x = constrain(x, rules, "batch", "embed")
    x = _decode_blocks(params, state, x, pos, cfg, B.block_decode,
                       active=active, rules=rules)
    return _head(params, x, cfg, rules, "batch", "vocab"), state


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


# ---------------------------------------------------------------------------
# continuous batching: slot-masked segments and per-slot state copies
# ---------------------------------------------------------------------------
#
# A whole-stack decode state is {"stack": …, "tail": …}: "stack" leaves
# carry (R, S, …) and "tail" leaves (S, …), so the slot (batch) axis is 1
# and 0 respectively. ``_SLOT_AXES`` is the one place that says so.
_SLOT_AXES = (("stack", 1), ("tail", 0))


def _slot_leaves(state: State):
    """(leaf, slot axis) of every tensor of a whole-stack state, in a
    fixed order."""
    for part, axis in _SLOT_AXES:
        for st in state[part]:
            for x in st:
                if x is not None:
                    yield x, axis


def _map_slots(fn, state: State) -> State:
    """A new whole-stack state of ``fn(leaf, slot_axis)`` per leaf."""
    def one(st, axis):
        return type(st)(*(None if x is None else fn(x, axis) for x in st))
    return {part: tuple(one(st, axis) for st in state[part])
            for part, axis in _SLOT_AXES}


def snapshot_state(state: State, slot: int) -> State:
    """A batch-1 copy of slot ``slot`` of a stacked engine state, the
    inverse of :func:`restore_state`. For the linear family it is the
    paper's fixed-size representation: O(k²) per layer whatever the
    slot's context."""
    return _map_slots(lambda x, axis: x.narrow(axis, int(slot), 1).clone(),
                      state)


def _cache_rows(dst: Tensor, src: Tensor) -> int:
    """The rows of ``src`` along a KV cache's S axis (…, S, Hkv, Dh) when
    it is shorter there than ``dst`` (a prefill cache landing in the
    engine's ``max_len`` cache), else 0: the leaves match."""
    if dst.shape == src.shape:
        return 0
    axis = dst.ndim - 3
    if dst.shape[:axis] + dst.shape[axis + 1:] != \
            src.shape[:axis] + src.shape[axis + 1:] or \
            src.shape[axis] > dst.shape[axis]:
        raise ValueError(f"state leaf {tuple(src.shape)} does not land in "
                         f"{tuple(dst.shape)}")
    return src.shape[axis]


def restore_state(engine_state: State, snapshot: State, slot: int) -> State:
    """Write a batch-1 whole-stack state into slot ``slot`` of the engine
    state, in place; every other slot's rows stay bit for bit. A softmax
    KV cache of fewer rows than the engine's (a prefill's) fills the
    slot's first rows and the rest become zeros, as JAX's
    ``pad_decode_state`` + restore leave them. Returns the engine
    state."""
    for (e, axis), (r, _) in zip(_slot_leaves(engine_state),
                                 _slot_leaves(snapshot)):
        dst = e.narrow(axis, int(slot), 1)
        n = _cache_rows(dst, r)
        if n:
            dst.zero_()
            dst = dst.narrow(dst.ndim - 3, 0, n)
        dst.copy_(r)
    return engine_state


def write_slot_state(engine_state: State, request_state: State,
                     slot: int) -> State:
    """Admit a batch-1 request state into slot ``slot``: one O(k²) copy
    per layer for the linear family, independent of how much context the
    request consumed (alias of :func:`restore_state`)."""
    return restore_state(engine_state, request_state, slot)


def where_state(active, new: State, old: State) -> State:
    """Per-slot merge, in place: the rows of ``new`` at the slots where
    ``active`` (S,) is True are copied into ``old``; every other slot of
    ``old`` stays bit for bit (JAX selects a new state; the port copies
    only the chosen rows). The chosen slots are found once: a mask on
    the host costs no device sync. A softmax KV cache of ``new`` with
    fewer rows than ``old``'s (a bucket-width prefill landing in the
    engine's ``max_len`` caches) fills the chosen slots' first rows and
    zeros the rest, as JAX's ``pad_decode_state`` + select leave them.
    Returns ``old``."""
    idx = torch.nonzero(torch.as_tensor(active)).flatten()
    if not idx.numel():
        return old
    on = {}                                  # the index on each device
    for (n, axis), (o, _) in zip(_slot_leaves(new), _slot_leaves(old)):
        if o.device not in on:
            on[o.device] = idx.to(o.device)
        i = on[o.device]
        rows = _cache_rows(o, n)
        if rows:
            o.index_fill_(axis, i, 0)
            o = o.narrow(o.ndim - 3, 0, rows)
        o.index_copy_(axis, i, n.index_select(axis, i))
    return old


# ---------------------------------------------------------------------------
# row-ranged forms: O(W·k) copies of the softmax KV caches
# ---------------------------------------------------------------------------
#
# The linear family's states are fixed-size, so a snapshot costs O(k²)
# whatever the context; a softmax KV cache (…, max_len, Hkv, Dh) copied
# whole moves O(max_len·k) bytes however few rows were written. The three
# forms below copy only the rows that matter. They rest on a read-masking
# invariant of ``attention_decode``: a slot at position pos reads cache
# rows [0, pos] and writes row pos before it reads it, so rows at index
# ≥ pos are never read before they are rewritten, and a restore that
# leaves them stale gives the same tokens as one that overwrites them.

def _map_slots_kv(fn, state: State) -> State:
    """A new whole-stack state of ``fn(leaf, slot_axis, is_kv_cache)``."""
    def one(st, axis):
        kv = isinstance(st, AttnState)
        return type(st)(*(None if x is None else
                          fn(x, axis, kv and f in ("k_cache", "v_cache"))
                          for f, x in zip(st._fields, st)))
    return {part: tuple(one(st, axis) for st in state[part])
            for part, axis in _SLOT_AXES}


def _kv_flags(state: State):
    """Whether each leaf of ``_slot_leaves(state)`` is a KV cache."""
    for part, _ in _SLOT_AXES:
        for st in state[part]:
            kv = isinstance(st, AttnState)
            for f, x in zip(st._fields, st):
                if x is not None:
                    yield kv and f in ("k_cache", "v_cache")


def state_rows_view(state: State, slot: int, n_rows: int) -> State:
    """The batch-1 view of slot ``slot`` that :func:`snapshot_state_rows`
    copies: each softmax KV cache cut to its first ``n_rows`` rows, every
    other leaf whole. Nothing is copied (the shapes, dtypes and devices of
    a snapshot, e.g. a template to load snapshots onto)."""
    def read(x, axis, kv):
        x = x.narrow(axis, int(slot), 1)
        t = x.ndim - 3
        if kv and n_rows < x.shape[t]:
            x = x.narrow(t, 0, int(n_rows))
        return x
    return _map_slots_kv(read, state)


def snapshot_state_rows(state: State, slot: int, n_rows: int) -> State:
    """:func:`snapshot_state`, but each softmax KV cache keeps only its
    first ``n_rows`` rows (0 allowed), an O(n_rows·k) copy per layer;
    ``n_rows`` must be at least the slot's position for a snapshot that
    resumes. Every other leaf (the fixed-size states) is copied whole:
    for them this is :func:`snapshot_state`."""
    return _map_slots(lambda x, axis: x.clone(),
                      state_rows_view(state, slot, n_rows))


def restore_state_rows(engine_state: State, snapshot: State,
                       slot: int) -> State:
    """Write a batch-1, possibly row-ranged snapshot into slot ``slot``,
    in place: a KV cache cut to W rows writes rows [0, W) and leaves the
    slot's rows ≥ W as they were (never read; JAX's
    ``dynamic_update_slice`` writes only its update's extent), an
    O(W·k) copy per layer. A full-width snapshot makes this
    :func:`restore_state`. Returns the engine state."""
    for (e, axis), (r, _) in zip(_slot_leaves(engine_state),
                                 _slot_leaves(snapshot)):
        dst = e.narrow(axis, int(slot), 1)
        if dst.shape != r.shape:
            dst = dst.narrow(dst.ndim - 3, 0, _cache_rows(dst, r))
        dst.copy_(r)
    return engine_state


def where_state_rows(active, new: State, old: State, start,
                     width: int) -> State:
    """Row-ranged per-slot merge, in place: like :func:`where_state`,
    but each softmax KV cache is merged only over rows
    [start_s, start_s + width) of each chosen slot, an O(W·k) copy,
    where rows outside the range are either equal in ``new`` and ``old``
    (below) or unread (above). ``start`` (S,) per-slot row offsets, on
    the host, are clamped to ``max_len - width`` as JAX clamps them.
    Every other leaf takes the whole-slot merge of :func:`where_state`.
    Returns ``old``."""
    mask = torch.as_tensor(active).cpu().numpy().astype(bool)
    slots = [int(s) for s in mask.nonzero()[0]]
    if not slots:
        return old
    start = torch.as_tensor(start).cpu().tolist()
    idx = torch.as_tensor(slots)
    for ((n, axis), (o, _)), kv in zip(
            zip(_slot_leaves(new), _slot_leaves(old)), _kv_flags(old)):
        if not kv:
            i = idx.to(o.device)
            o.index_copy_(axis, i, n.index_select(axis, i))
            continue
        t = o.ndim - 3
        for s in slots:
            lo = min(max(int(start[s]), 0), o.shape[t] - width)
            o.narrow(axis, s, 1).narrow(t, lo, width).copy_(
                n.narrow(axis, s, 1).narrow(t, lo, width))
    return old


def slot_state_finite(state: State) -> Tensor:
    """(S,) bool: True where every float leaf of that slot is finite."""
    out = None
    for x, axis in _slot_leaves(state):
        if not x.is_floating_point():
            continue
        m = x.movedim(axis, 0)
        ok = torch.isfinite(m.reshape(m.shape[0], -1)).all(dim=-1)
        out = ok if out is None else out & ok
    return out


def generate_segment(params: Params, state: State, tok: Tensor, pos: Tensor,
                     active: Tensor, remaining: Tensor, n_steps: int,
                     cfg: ModelConfig, *, eos_id: Optional[int] = None,
                     temperature: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     pad_id: int = -1) -> Tuple[Tensor, Dict[str, Any]]:
    """One continuous-batching segment: ``n_steps`` slot-masked decode
    steps. Each slot carries its own lifecycle: tok (S,) its next input
    token, pos (S,) its position, active (S,) whether it holds a live
    request, remaining (S,) how many tokens it may still emit (this
    step's included). A slot stops inside the segment when its budget
    reaches zero or it emits ``eos_id``; stopped and empty slots emit
    ``pad_id`` and keep their state bit for bit (under softmax their
    one written cache row is gated), so each slot's tokens are those of
    its request run alone (greedy).

    JAX runs the segment as one ``lax.scan``; here it is a Python loop
    whose carry stays on the device, every stop decided by
    ``torch.where``: nothing in it waits for the host. Every step
    launches the decode kernel once per layer, the whole segment
    through, whatever the slots do (softmax: no kernel, the cache read
    is plain PyTorch). Returns (tokens (S, n_steps),
    carry) with carry = {"tok", "pos", "active", "remaining", "state"};
    the state is updated in place."""
    if temperature and temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    params = cast_params(params, dtype_of(cfg.dtype))   # once, not per step
    tok = tok.long()
    pos = pos.to(torch.int32)
    act = active.bool()
    rem = remaining.to(torch.int32)
    emitted = []
    for _ in range(n_steps):
        logits, state = decode_step(params, state, tok, pos, cfg, active=act)
        nxt = sample_token(logits, temperature, generator)
        emitted.append(torch.where(act, nxt, pad_id))
        rem = torch.where(act, rem - 1, rem)
        done = rem <= 0
        if eos_id is not None:
            done = done | (nxt == eos_id)
        pos = torch.where(act, pos + 1, pos)
        tok = torch.where(act, nxt, tok)
        act = act & ~done
    toks = (torch.stack(emitted, dim=1) if emitted
            else tok.new_zeros((tok.shape[0], 0)))
    return toks, {"tok": tok, "pos": pos, "active": act, "remaining": rem,
                  "state": state}


def _window_forward(params: Params, state: State, tokens: Tensor, pos0,
                    cfg: ModelConfig, block_fn=B.block_decode_window, *,
                    last: Optional[Tensor] = None, **block_kw
                    ) -> Tuple[Tensor, State]:
    """Embed, ``block_fn`` through every block, the head: on every
    position, or with ``last`` (B,) on position last[b] of each row only."""
    params = cast_params(params, dtype_of(cfg.dtype))
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    x = _decode_blocks(params, state, x, pos0, cfg, block_fn, **block_kw)
    if last is not None:
        x = _rows_at(x, last)
    return _head(params, x, cfg), state


def decode_window(params: Params, state: State, tokens: Tensor, pos0,
                  cfg: ModelConfig) -> Tuple[Tensor, State]:
    """Advance the state over W known tokens, one fused kernel launch per
    layer. tokens: (B, W); pos0: () or (B,) start positions. Returns
    (logits (B, W, V), state), logits[:, i] the next-token distribution
    after tokens[:, i]; the state is updated in place."""
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=tokens.device)
    return _window_forward(params, state, tokens, pos0, cfg)


def _varlen_args(tokens: Tensor, pos0, lens) -> Tuple[Tensor, Tensor]:
    b, w = tokens.shape
    pos0 = torch.as_tensor(pos0, dtype=torch.int32,
                           device=tokens.device).expand(b)
    lens = torch.as_tensor(lens, device=tokens.device).to(torch.int32)
    return pos0, lens.clamp(0, w)


def decode_window_varlen(params: Params, state: State, tokens: Tensor, pos0,
                         lens, cfg: ModelConfig, *,
                         active: Optional[Tensor] = None,
                         last_only: bool = False) -> Tuple[Tensor, State]:
    """Variable-length window: row b consumes tokens[b, :lens[b]] from
    position pos0[b] (0 ≤ lens ≤ W) through the recurrence (B1/B7 on
    CUDA tensors, one launch per layer; under softmax W single-token
    steps, the cache row of step w gated on w < lens[b], as JAX scans
    it); ``active`` False rows behave as lens = 0. Masked rows and steps leave the state bit for bit as it was;
    their logits are garbage. Returns (logits (B, W, V), state), or with
    ``last_only`` each row's logits after its last valid token, (B, V),
    the head run on those rows only."""
    pos0, lens = _varlen_args(tokens, pos0, lens)
    if active is not None:
        lens = torch.where(torch.as_tensor(active, device=tokens.device),
                           lens, 0)
    last = (lens - 1).clamp(min=0) if last_only else None
    return _window_forward(params, state, tokens, pos0, cfg, last=last,
                           lens=lens)


def ingest_window_varlen(params: Params, state: State, tokens: Tensor, pos0,
                         lens, cfg: ModelConfig, *, last_only: bool = False
                         ) -> Tuple[Tensor, State]:
    """Chunk-parallel sibling of :func:`decode_window_varlen` for prompt
    ingestion (same arguments and row masking): the linear family
    continues each row's state through the plain chunked prefill forms
    from the carried state and key sum, at prefill cost rather than W
    recurrent steps; softmax, whose cache has no parallel continuation,
    takes the per-step path of :func:`decode_window_varlen`. Returns
    (logits (B, W, V), state), or (B, V) with ``last_only``; the state
    is updated in place."""
    pos0, lens = _varlen_args(tokens, pos0, lens)
    last = (lens - 1).clamp(min=0) if last_only else None
    return _window_forward(params, state, tokens, pos0, cfg,
                           B.block_ingest_window, last=last, lens=lens)
