"""The paper's §6 proposed extension: a second-order recurrent unit
(port of ``repro/core/second_order.py``).

    r_t = C_{t−1} h_{t−1}                    (the "already-stored" probe)
    h_t = GRUCell([x_t ; W_r r_t], h_{t−1})
    C_t = α·C_{t−1} + h_t h_tᵀ               (the paper's update, α ≤ 1)

The C state doubles as the document representation, so lookups stay
O(k²). Like ``qa/gru.py`` it is plain tensor code in JAX (a ``lax.scan``
of jnp), not a Pallas kernel, so it stays plain PyTorch here: a Python
loop over time.

At t = 0 the probe is C₀h₀ = 0, where the normalisation x / (‖x‖ + 1e-6)
has no derivative: JAX's gradient there is NaN, torch's finite. Only the
cotangents of the constant h₀ and C₀ see it; every parameter gradient
agrees.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.qa.gru import gru_cell, gru_params

Tensor = torch.Tensor
Params = Dict[str, object]


def second_order_params(generator: torch.Generator, d_in: int, k: int,
                        dtype: torch.dtype = torch.float32) -> Params:
    """Weights drawn from ``generator`` on its device (the JAX package
    draws from a PRNG key: the numbers differ, the scales are the same)."""
    dev = generator.device
    return {
        "gru": gru_params(generator, d_in + k, k, dtype),
        # probe projection: scales C h (which grows with t) into the cell
        "w_probe": (torch.randn((k, k), generator=generator, device=dev)
                    * 0.05).to(dtype),
        # α = σ(8) ≈ 0.99966, a long memory (JAX's choice: σ(4) forgets a
        # fact within ~40 tokens and fails the cloze task)
        "alpha_logit": torch.tensor(8.0, dtype=dtype, device=dev),
    }


def second_order_scan(
    p: Params,
    xs: Tensor,
    h0: Optional[Tensor] = None,
    c0: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """xs: (B, T, D) -> (hidden states (B, T, k), h_T, C_T (B, k, k))."""
    b, t, _ = xs.shape
    k = p["w_probe"].shape[0]
    h = (torch.zeros((b, k), dtype=xs.dtype, device=xs.device)
         if h0 is None else h0)
    c = (torch.zeros((b, k, k), dtype=xs.dtype, device=xs.device)
         if c0 is None else c0)
    alpha = torch.sigmoid(p["alpha_logit"])
    hs = []
    for i in range(t):
        probe = torch.einsum("bkl,bl->bk", c, h)
        # normalise the probe (C grows about linearly with t)
        probe = probe / (torch.linalg.vector_norm(probe, dim=-1,
                                                  keepdim=True) + 1e-6)
        inp = torch.cat([xs[:, i], probe @ p["w_probe"]], dim=-1)
        h = gru_cell(p["gru"], h, inp)
        c = alpha * c + h[:, :, None] * h[:, None, :]
        hs.append(h)
    return torch.stack(hs, dim=1), h, c
