"""Single-layer GRU, the paper's encoder (§5) (port of ``repro/qa/gru.py``).

The JAX package's formula and layout: ``w_i`` (d_in, 3k) and ``w_h``
(k, 3k) stacked reset | update | candidate, with the bias on the input
side only, so the candidate gate reads tanh(x w_n + b_n + r ⊙ (h u_n)).
``torch.nn.GRU`` (cuDNN) adds a separate hidden bias inside the
candidate's reset product and is not this function. The GRU is plain
tensor code in JAX, not a Pallas kernel, so it stays plain PyTorch here:
a Python loop over time with one matmul per step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def gru_params(generator: torch.Generator, d_in: int, d_hidden: int,
               dtype: torch.dtype = torch.float32) -> Params:
    """Weights drawn from ``generator`` on its device (the JAX package
    draws from a PRNG key: the numbers differ, the scales are the same)."""
    dev = generator.device
    randn = lambda *shape: torch.randn(shape, generator=generator,
                                       device=dev)
    return {
        "w_i": (randn(d_in, 3 * d_hidden) / d_in ** 0.5).to(dtype),
        "w_h": (randn(d_hidden, 3 * d_hidden) / d_hidden ** 0.5).to(dtype),
        "b": torch.zeros(3 * d_hidden, dtype=dtype, device=dev),
    }


def _cell(p: Params, h: Tensor, gi: Tensor) -> Tensor:
    """One step from the input projection ``gi`` = x w_i + b."""
    gh = h @ p["w_h"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_cell(p: Params, h: Tensor, x: Tensor) -> Tensor:
    """h: (B, K); x: (B, D) -> new h."""
    return _cell(p, h, x @ p["w_i"] + p["b"])


def gru_scan(p: Params, xs: Tensor, h0: Optional[Tensor] = None
             ) -> Tuple[Tensor, Tensor]:
    """xs: (B, T, D) -> (hidden states (B, T, K), last state (B, K)).

    The input projection of every step is one matmul before the loop; the
    loop then runs the recurrent part step by step.
    """
    b, t, _ = xs.shape
    k = p["w_h"].shape[0]
    h = (torch.zeros((b, k), dtype=xs.dtype, device=xs.device)
         if h0 is None else h0)
    gi = xs @ p["w_i"] + p["b"]                      # (B, T, 3K)
    hs = torch.empty((b, t, k), dtype=h.dtype, device=xs.device)
    for i in range(t):
        h = _cell(p, h, gi[:, i])
        hs[:, i] = h
    return hs, h
