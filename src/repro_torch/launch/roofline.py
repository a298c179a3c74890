"""Roofline terms at NVIDIA H100 SXM peaks (port of
``repro/launch/roofline.py``, whose constants are a TPU v5e's).

    compute term    = FLOPs_per_device / peak_FLOPs
    memory term     = HBM_bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device / link_bw_effective

The per-device quantities come from one traced step of one rank
(``launch/hlo.py``'s ``analyze_step``), which is the per-device program,
so no further division by the device count is needed.

Hardware constants (NVIDIA H100 SXM5 data sheet; published peaks, not
measurements of this repository):
  989 TFLOP/s bf16 on the dense tensor cores; 67 TFLOP/s fp32 outside
  them (the FMA routes of the kernels); 3.35 TB/s HBM3. NVLink 4 gives a
  card 18 links of 25 GB/s per direction, 450 GB/s in all; a ring
  collective over the NVSwitch keeps every link busy, so the default
  effective collective bandwidth is NVLINK_LINKS_EFFECTIVE · 25 GB/s =
  450 GB/s. Per-link maths is kept explicit so the assumption is
  auditable. The 256- and 512-rank production meshes span many
  eight-card nodes: their data and pod axes would cross InfiniBand
  (about 50 GB/s a card), so for them the collective term is a lower
  bound.

JAX's ``_pallas`` terms drop the HBM traffic of attention score blocks,
which its Pallas kernels keep in VMEM. Here they are ``_fused``: the
fused CUDA kernels keep score blocks in shared memory or registers.
JAX's names map one to one: ``t_memory_pallas`` → ``t_memory_fused``,
``t_bound_pallas`` → ``t_bound_fused``, ``mfu_bound_pallas`` →
``mfu_bound_fused`` (and so the ``as_dict`` keys).

``bound`` is the least time one kernel launch could take: the bytes it
must move over the memory rate or its operations over a peak, whichever
is larger (``chip_smoke.py``'s per-kernel bounds).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor cores, per card
PEAK_FLOPS_FP32 = 67e12         # fp32 FMA, outside the tensor cores
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_LINK_BW = 25e9           # bytes/s per link and direction
NVLINK_LINKS_EFFECTIVE = 18.0   # links a ring collective keeps busy


def bound(n_bytes: float, flops: float, peak: float = PEAK_FLOPS_FP32
          ) -> dict:
    """The least time the card could take: bytes over the memory rate or
    the operations over ``peak`` (the fp32 rate outside the tensor cores
    unless given), whichever is larger, in ms."""
    bytes_ms = n_bytes / HBM_BW * 1e3
    flops_ms = flops / peak * 1e3
    return dict(bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=n_bytes, flops=flops)


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    n_devices: int
    model_flops_global: float = 0.0
    # HBM traffic of attention score blocks — kept on chip by the fused
    # CUDA kernels; the "fused" memory term excludes it.
    score_bytes_per_device: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_memory_fused(self) -> float:
        return max(self.hbm_bytes_per_device
                   - self.score_bytes_per_device, 0.0) / HBM_BW

    @property
    def t_bound_fused(self) -> float:
        return max(self.t_compute, self.t_memory_fused, self.t_collective)

    @property
    def mfu_bound_fused(self) -> float:
        denom = self.n_devices * PEAK_FLOPS_BF16 * self.t_bound_fused
        return self.model_flops_global / denom if denom else 0.0

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / (
            NVLINK_LINK_BW * NVLINK_LINKS_EFFECTIVE)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time if compute/memory/comm fully overlap."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs (global): how much of the traced
        compute is useful model math (catches remat and dispatch waste)."""
        traced_global = self.flops_per_device * self.n_devices
        return self.model_flops_global / traced_global \
            if traced_global else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on achievable MFU: useful FLOPs / (cards × peak ×
        bound step time)."""
        denom = self.n_devices * PEAK_FLOPS_BF16 * self.t_bound
        return self.model_flops_global / denom if denom else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "score_bytes_per_device": self.score_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_fused_s": self.t_memory_fused,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "t_bound_fused_s": self.t_bound_fused,
            "bottleneck": self.bottleneck,
            "model_flops_global": self.model_flops_global,
            "model_flops_ratio": self.model_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "mfu_bound_fused": self.mfu_bound_fused,
        }


def terms_from_artifact(art: Dict) -> RooflineTerms:
    """The terms of a dry-run artifact (``launch/dryrun.py``)."""
    return RooflineTerms(
        flops_per_device=art["flops_per_device"],
        hbm_bytes_per_device=art["hbm_bytes_per_device"],
        wire_bytes_per_device=art["collectives"]["wire_bytes"],
        n_devices=art["n_devices"],
        model_flops_global=art.get("model_flops", 0.0),
        score_bytes_per_device=art["roofline"]["score_bytes_per_device"],
    )
