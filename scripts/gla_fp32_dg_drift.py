"""The fp32 route of the gated kernels (B8, B9) against the per-token scan
as the decay strengthens: why its ``DECAY_LIMIT`` is −1.5.

For g held at lo = −1, −1.5, −2 and −2.5 (``min_log_decay`` = lo, chunk
32), o and the four gradients of ``gated_linear_attention`` (forward B8,
backward B9) against ``gla_scan``'s autograd evaluated in fp64, each as
max|Δ| over max|scan|. Beside them: κ = max|q⊙dq| / max|dg| (fp64), by
which the identity dg = reverse-cumsum(q⊙dq − k⊙dk) amplifies the rounding
of dq and dk; dg's error over κ; and dg formed by the same identity in
fp64 from the route's fp32 dq and dk, which leaves out the wrapper's fp32
cumsum. The inputs are ``tests/test_torch_gated_train.py``'s
``_drift_inputs``: q, k = elu1 and v, do standard normal, (1, 1, 1024,
128) from numpy's ``default_rng(21)``; that test holds JAX's Pallas bwd
and the plain version to the same rows on the CPU.

Past −1.5 the wrappers refuse fp32 calls on CUDA; the script lifts the
fp32 entry of ``DECAY_LIMIT`` for its own run and restores it. Only
finiteness is asserted.

    PYTHONPATH=src python scripts/gla_fp32_dg_drift.py [--device cpu]

The kernels rescale within their own 32-token tiles whatever the chunk;
the chunk of 32 keeps the plain version, which the wrapper runs on the
CPU, finite too (chunk-wide, it is NaN at chunk 128 past the clamp, as
JAX's is).
"""

from __future__ import annotations

import argparse
from unittest import mock

import numpy as np
import torch

from repro_torch.core.gated import gla_scan
from repro_torch.kernels.gated_linear_attention import ops as GL

LOWS = (-1.0, -1.5, -2.0, -2.5)


def drift_inputs(seed: int = 21, t: int = 1024, d: int = 128):
    """q, k positive (elu1), v and do signed: numpy (1, 1, t, d) fp32."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((1, 1, t, d)) for _ in range(4)]
    elu1 = lambda a: np.where(a > 0, a + 1.0, np.exp(np.minimum(a, 0.0)))  # noqa
    return [a.astype(np.float32) for a in (elu1(x[0]), elu1(x[1]), x[2],
                                          x[3])]


def _vjp(fn, xs, do):
    leaves = [x.clone().requires_grad_() for x in xs]
    o = fn(*leaves)
    o.backward(do)
    return [o.detach()] + [x.grad for x in leaves]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.double()
    return ((a.double() - b).abs().max() / b.abs().max()).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    q, k, v, do = (torch.from_numpy(x).to(dev) for x in drift_inputs())
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(dev))
    print("lo     o        dq       dk       dv       dg       kappa  "
          "dg/kappa  dg by the identity in fp64")
    with mock.patch.dict(GL.DECAY_LIMIT, {torch.float32: min(LOWS)}):
        for lo in LOWS:
            g = torch.full_like(q, lo)
            got = _vjp(lambda a, b, c, e: GL.gated_linear_attention(
                a, b, c, e, chunk=32, min_log_decay=lo), [q, k, v, g], do)
            want = _vjp(lambda a, b, c, e: gla_scan(a, b, c, e)[0],
                        [x.double() for x in (q, k, v, g)], do.double())
            if not all(torch.isfinite(x).all() for x in got):
                raise AssertionError(f"lo = {lo}: non-finite output")
            qdq = q.double() * want[1]
            kappa = (qdq.abs().max() / want[4].abs().max()).item()
            diff = q.double() * got[1].double() - k.double() * got[2].double()
            dg64 = diff.flip(2).cumsum(2).flip(2)
            errs = [rel(a, b) for a, b in zip(got, want)]
            print(f"{lo:<6} " + " ".join(f"{e:.2e}" for e in errs)
                  + f" {kappa:6.2f} {errs[4] / kappa:.2e}  "
                  f"{rel(dg64, want[4]):.2e}")


if __name__ == "__main__":
    main()
