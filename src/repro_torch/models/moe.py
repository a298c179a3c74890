"""Mixture-of-Experts FFN, DeepSeekMoE / Qwen3-MoE style (port of
``repro/models/moe.py``: the einsum path and ``moe_apply_shard_map``,
expert parallelism over a mesh).

Shared experts (always-on dense MLPs) are one dense SwiGLU of width
``n_shared · d_ff_expert``. Routed experts use top-k softmax routing with
a sort-based capacity dispatch:

  1. every (token, choice) pair is ranked within its expert in token
     order (a stable argsort over expert ids, then ``searchsorted``);
  2. pairs whose rank reaches the capacity
     ``C = max(8, ceil8(capacity_factor · N · k / E))`` are dropped
     (weight 0), GShard style;
  3. kept pairs are scattered into an (E·C + 1, D) buffer whose last row
     takes the dropped pairs and is sliced off, the experts run as one
     batched (E, C, D) × (E, D, F) product, and the outputs are gathered
     back, weighted by the router and summed over the k choices.

No kernel: JAX computes the expert products outside any Pallas kernel
(XLA's einsum), and here they are ``torch.bmm``. Every step is
deterministic on CUDA as on the CPU: the scatter writes each kept slot
once (only the discarded last row takes several writes), and the sum
over the k choices is a reduction over a (N, k, D) view, not an
``index_add_``, so a run repeats bit for bit.

On a mesh whose model axis divides the expert count,
``moe_apply_shard_map`` runs JAX's shard_map program on each rank's
tokens under DTensor's ``local_map``: local routing and dispatch, an
all-to-all over the model axis, the experts' FSDP shards gathered over
the data axes, the experts, the reverse all-to-all and the local
combine, every collective an autograd-aware one. Any other call on a
mesh runs the einsum path on the whole (replicated) tensors.

The router aux loss is the load-balance loss ``E · Σ_e f_e · p_e / k``
(fraction of routed choices × mean probability).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import Rules, constrain, local_call, whole_dims
from repro_torch.tree import leaves, tree_map

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def moe_params(gen: torch.Generator, cfg: ModelConfig, *,
               lead: Tuple[int, ...] = (), dtype=torch.float32) -> Params:
    """Router (D, E) in fp32 whatever ``dtype``; experts (E, D, F),
    (E, D, F) and (E, F, D), ``w_down`` scaled by 1/√(2·n_layers); the
    shared experts as one SwiGLU of width ``n_shared · d_ff_expert``."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": L.dense_init(gen, d, e, lead=lead, dtype=torch.float32,
                               scale=0.02),
        "w_gate": L.normal_matrices(gen, (*lead, e, d, f), scale, dtype),
        "w_up": L.normal_matrices(gen, (*lead, e, d, f), scale, dtype),
        "w_down": L.normal_matrices(gen, (*lead, e, f, d),
                          scale / math.sqrt(2 * cfg.n_layers), dtype),
    }
    if m.n_shared > 0:
        p["shared"] = L.mlp_params(gen, d, m.n_shared * f, "swiglu",
                                   lead=lead, dtype=dtype)
    return p


def moe_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical sharding names, the tree of ``moe_params``."""
    p = {
        "router": (None, None),                 # tiny; replicated
        "w_gate": ("experts", "fsdp", None),
        "w_up": ("experts", "fsdp", None),
        "w_down": ("experts", None, "fsdp"),
    }
    if cfg.moe.n_shared > 0:
        p["shared"] = {"w_up": ("fsdp", "ffn"), "w_gate": ("fsdp", "ffn"),
                       "w_down": ("ffn", "fsdp")}
    return p


# ---------------------------------------------------------------------------
# routing + dispatch
# ---------------------------------------------------------------------------

def route(router_w: Tensor, x_flat: Tensor, top_k: int
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """x_flat: (N, D) → (weights (N, K) fp32, experts (N, K) int64,
    aux ()). Softmax, then top-k, the weights renormalised (+1e-9), all
    in fp32 whatever the router's and x's types."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                      # (N, E)
    weights, experts = torch.topk(probs, top_k, dim=-1)        # (N, K)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    n, e = probs.shape
    # load balance: E · Σ_e (choices routed to e / N) · (mean prob of e)
    # / k; the counts by a scatter of ones (exact, with no host sync)
    counts = torch.zeros(e, dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, experts.reshape(-1),
                        torch.ones(experts.numel(), device=probs.device))
    aux = e * torch.sum(counts / n * probs.mean(dim=0)) / top_k
    return weights, experts, aux


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float
             ) -> int:
    c = int(factor * n_tokens * top_k / n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for clean tiling


def dispatch_slots(experts: Tensor, n_experts: int, cap: int
                   ) -> Tuple[Tensor, Tensor]:
    """experts: (N, K) → (slot (N·K,), keep (N·K,) bool). Each pair's
    rank within its expert comes from a stable argsort over the flat
    expert ids (token order, then choice order) and ``searchsorted`` of
    each expert's first position; a kept pair (rank < cap) lands in row
    expert·cap + rank of the expert buffer, a dropped one in the trash
    row E·cap."""
    flat = experts.reshape(-1)
    nk = flat.numel()
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat.device), side="left")
    rank_sorted = torch.arange(nk, device=flat.device) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, flat * cap + rank, n_experts * cap)
    return slot, keep


def moe_apply(p: Params, x: Tensor, cfg: ModelConfig, *,
              rules: Rules = Rules.null()) -> Tuple[Tensor, Tensor]:
    """x: (B, T, D) → (out (B, T, D), aux () fp32); also takes (B, D), a
    decode step. The capacity is set by the B·T tokens of the call.

    ``rules``: JAX's choice of dispatch: the shard_map all-to-all path
    when a model axis exists and divides the expert count (a (B, T, D)
    input); on a mesh otherwise the einsum path runs on the whole
    tensors on every rank."""
    m = cfg.moe
    if (m.dispatch == "shard_map" and rules.model_size > 1
            and m.n_experts % rules.model_size == 0 and x.ndim == 3):
        return moe_apply_shard_map(p, x, cfg, rules)
    if rules.on_mesh:
        args = [x] + leaves(p)

        def whole(*local):
            it = iter(local[1:])
            return _einsum_moe(tree_map(lambda _: next(it), p), local[0],
                               cfg)
        return local_call(whole, rules, args,
                          [(None,) * a.ndim for a in args],
                          ((None,) * x.ndim, ()), out_shapes=(x.shape, ()))
    return _einsum_moe(p, x, cfg)


def _einsum_moe(p: Params, x: Tensor, cfg: ModelConfig
                ) -> Tuple[Tensor, Tensor]:
    """``moe_apply`` on one device: the sort-based dispatch, the batched
    experts and the shared experts."""
    m = cfg.moe
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, None, :]
    b, t, d = x.shape
    n, k, e = b * t, m.top_k, m.n_experts
    x_flat = x.reshape(n, d)

    weights, experts, aux = route(p["router"], x_flat, k)
    cap = capacity(n, k, e, m.capacity_factor)
    slot, keep = dispatch_slots(experts, e, cap)

    # dispatch: each pair's token into its expert row (trash row last)
    token_idx = torch.arange(n, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = x_flat[token_idx]
    expert_in = buf[:-1].reshape(e, cap, d)

    # the experts: batched SwiGLU over the expert axis
    gate = torch.bmm(expert_in, p["w_gate"].to(x.dtype))
    up = torch.bmm(expert_in, p["w_up"].to(x.dtype))
    expert_out = torch.bmm(F.silu(gate) * up, p["w_down"].to(x.dtype))

    # combine: gather each pair's row (the trash row reads zeros), weight
    # it, and sum over the k choices of each token, in x's type
    out_flat = torch.cat([expert_out.reshape(e * cap, d),
                          x.new_zeros((1, d))], dim=0)
    w = (weights.reshape(-1) * keep).to(x.dtype)
    combined = (out_flat[slot] * w[:, None]).reshape(n, k, d).sum(dim=1)

    if m.n_shared > 0:
        combined = combined + L.mlp(p["shared"], x_flat, "swiglu")
    out = combined.reshape(b, t, d)
    if squeeze:
        out = out[:, 0]
    return out, aux


# ---------------------------------------------------------------------------
# expert parallelism: explicit all-to-all dispatch over the model axis
# ---------------------------------------------------------------------------
#
# Per-rank program (tokens arrive (B_loc, T_loc, D): batch over the data
# axes, sequence over the model axis, the sequence-parallel residual
# layout):
#
#   1. route locally; build an (E, cap_src, D) send buffer by the same
#      sort and scatter as the einsum path (all local);
#   2. all-to-all over the model axis: rank m receives, for each of its
#      E/M local experts, the cap_src-token slices from every peer;
#   3. the experts' weights are FSDP-sharded on d_model: all-gathered
#      over the data axes (their gradients come back reduce-scattered);
#   4. the batched expert SwiGLU; the reverse all-to-all; the local
#      weighted combine.
#
# The router's tallies are summed over every rank, so each returns the
# same global load-balance loss.

class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over a process group whose result every rank
    then uses whole: the backward is the identity (each rank's gradient
    of the replicated loss is already the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_apply_shard_map(p: Params, x: Tensor, cfg: ModelConfig,
                        rules: Rules) -> Tuple[Tensor, Tensor]:
    """``moe_apply`` with expert parallelism (JAX ``moe_apply_shard_map``):
    x: (B, T, D) on the rules' mesh, split (batch, seq_sp); the experts
    split over the model axis, their d_model over the data axes."""
    from torch.distributed import _functional_collectives as fc
    m = cfg.moe
    mesh = rules.mesh
    n_model = rules.model_size
    e_loc = m.n_experts // n_model
    model_group = mesh.get_group("model")
    dp_groups = [mesh.get_group(a) for a in ("pod", "data")
                 if a in rules.mesh_axes and rules.axis_size(a) > 1]
    all_groups = [mesh.get_group(a) for a in rules.mesh_axes
                  if rules.axis_size(a) > 1]

    # the autograd all-gather (its backward a reduce-scatter), under its
    # name in the torch at hand
    gather = getattr(fc, "all_gather_single_autograd", None) or \
        fc.all_gather_tensor_autograd

    def gather_fsdp(w, dim):
        # innermost data axis first: the pod-major blocks then line up
        for g in reversed(dp_groups):
            w = gather(w, dim, g)
        return w

    def body(x_blk, router_w, w_gate, w_up, w_down):
        nb, tb, d = x_blk.shape
        n_loc = nb * tb
        xf = x_blk.reshape(n_loc, d)
        # local routing; the aux tallies summed over every rank
        probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)
        weights, experts = torch.topk(probs, m.top_k, dim=-1)
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
        cnt = torch.zeros(m.n_experts, dtype=torch.float32,
                          device=xf.device)
        cnt.scatter_add_(0, experts.reshape(-1),
                         torch.ones(experts.numel(), device=xf.device))
        cnt_g, p_g = cnt, probs.sum(dim=0)
        for g in all_groups:
            cnt_g = _SumOverRanks.apply(cnt_g, g)
            p_g = _SumOverRanks.apply(p_g, g)
        n_g = n_loc * mesh.size()
        aux = m.n_experts * torch.sum(
            (cnt_g / (n_g * m.top_k)) * (p_g / n_g))
        # local capacity dispatch
        cap = capacity(n_loc, m.top_k, m.n_experts, m.capacity_factor)
        slot, keep = dispatch_slots(experts, m.n_experts, cap)
        token_idx = torch.arange(n_loc, device=xf.device
                                 ).repeat_interleave(m.top_k)
        send = xf.new_zeros((m.n_experts * cap + 1, d))
        send = send.index_put((slot,), xf[token_idx])
        # all-to-all over the model axis: block j goes to rank j
        recv = fc.all_to_all_single_autograd(
            send[:-1].contiguous(), None, None, model_group)
        expert_in = recv.reshape(n_model, e_loc, cap, d).transpose(0, 1
                                 ).reshape(e_loc, n_model * cap, d)
        wg, wu = gather_fsdp(w_gate, 1), gather_fsdp(w_up, 1)
        wd = gather_fsdp(w_down, 2)
        gate = torch.bmm(expert_in, wg.to(xf.dtype))
        up = torch.bmm(expert_in, wu.to(xf.dtype))
        expert_out = torch.bmm(F.silu(gate) * up, wd.to(xf.dtype))
        back = expert_out.reshape(e_loc, n_model, cap, d).transpose(0, 1
                                  ).reshape(n_model * e_loc * cap, d)
        got = fc.all_to_all_single_autograd(back.contiguous(), None, None,
                                            model_group)
        out_flat = torch.cat([got, xf.new_zeros((1, d))], dim=0)
        w = (weights.reshape(-1) * keep).to(xf.dtype)
        combined = (out_flat[slot] * w[:, None]).reshape(
            n_loc, m.top_k, d).sum(dim=1)
        return combined.reshape(nb, tb, d), aux

    x_names = ("batch", "seq_sp", None)
    out, aux = local_call(
        body, rules, (x, p["router"], p["w_gate"], p["w_up"], p["w_down"]),
        (x_names, (None, None), ("experts", "fsdp", None),
         ("experts", "fsdp", None), ("experts", None, "fsdp")),
        (x_names, ()), out_shapes=(x.shape, ()), grad_partial=(1,))
    if m.n_shared > 0:    # the dense shared experts on the whole sequence
        out = out + constrain(L.mlp(p["shared"], whole_dims(x, 1), "swiglu"),
                              rules, *x_names)
    return out, aux


# ---------------------------------------------------------------------------
# dense oracle (tests): every expert on every token
# ---------------------------------------------------------------------------

def moe_dense_oracle(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """O(N·E) reference without dispatch or capacity: equals
    ``moe_apply`` when nothing drops (capacity ≥ every expert's load)."""
    m = cfg.moe
    b, t, d = x.shape
    x_flat = x.reshape(-1, d)
    weights, experts, _ = route(p["router"], x_flat, m.top_k)
    gate = torch.einsum("nd,edf->enf", x_flat, p["w_gate"].to(x.dtype))
    up = torch.einsum("nd,edf->enf", x_flat, p["w_up"].to(x.dtype))
    all_out = torch.einsum("enf,efd->end", F.silu(gate) * up,
                           p["w_down"].to(x.dtype))
    onehot = F.one_hot(experts, m.n_experts).to(x.dtype)      # (N, K, E)
    w = torch.einsum("nk,nke->ne", weights.to(x.dtype), onehot)
    out = torch.einsum("ne,end->nd", w, all_out)
    if m.n_shared > 0:
        out = out + L.mlp(p["shared"], x_flat, "swiglu")
    return out.reshape(b, t, d)
