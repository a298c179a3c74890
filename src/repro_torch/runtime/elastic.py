"""Elastic re-mesh planning: map a surviving device count to a mesh shape
(port of ``repro/runtime/elastic.py``).

When nodes fail, the job restarts on the surviving topology. The planner
keeps the model axis fixed (the tensor-parallel degree is baked into
layouts and must divide head and ffn dims) and shrinks the data axis:
data parallelism is the elastic dimension. Checkpoints restore through
:func:`repro_torch.checkpoint.elastic.restore_on_mesh`; the global batch
is held constant by raising gradient-accumulation steps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def plan_mesh_shape(
    n_chips: int,
    *,
    model: int = 16,
    prefer_pods: Optional[int] = None,
) -> Dict[str, int]:
    """Largest (pod, data, model) grid fitting ``n_chips`` with the given
    tensor-parallel degree. Returns {"pod": P, "data": D, "model":
    model}."""
    if n_chips < model:
        raise ValueError(f"{n_chips} chips cannot host model={model} TP")
    slots = n_chips // model
    if prefer_pods and slots % prefer_pods == 0:
        return {"pod": prefer_pods, "data": slots // prefer_pods,
                "model": model}
    return {"pod": 1, "data": slots, "model": model}


def accum_for_batch(global_batch: int, data_parallel: int,
                    per_device_batch: int = 1) -> Tuple[int, int]:
    """(microbatch per step, accumulation steps) that keep the global
    batch constant after data parallelism shrinks."""
    per_step = data_parallel * per_device_batch
    # the largest divisor of the global batch at most per_step
    while global_batch % per_step != 0:
        per_step -= 1
    return per_step, global_batch // per_step
