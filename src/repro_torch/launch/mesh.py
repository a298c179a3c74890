"""Device meshes on ``torch.distributed`` (port of ``repro/launch/mesh.py``).

Single pod: (data=16, model=16), 256 devices. Multi-pod: (pod=2, data=16,
model=16), 512 devices; "pod" is a second, slower data-parallel axis.
Each function builds a named ``DeviceMesh`` over the ranks of the
default process group, which the caller has started (``torchrun``
gives its address, world size and rank; nothing else tells a program of
a cluster). ``device`` is "cuda" unless the caller asks for "cpu", as
at every entry point of the port; on CUDA each rank uses the device of
its local rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a started process group "
                           "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: str = "cuda"):
    """A mesh of the given shape and axis names (elastic re-mesh, smoke
    meshes). Its size must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if n != _world():
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"the process group has {_world()}")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = required_devices(multi_pod)
    if _world() != n:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh "
            f"{dict(zip(axes, shape))} needs a world of {n} ranks, not "
            f"{_world()}")
    return make_mesh(shape, axes, device=device)


def required_devices(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


def make_smoke_mesh(data: Optional[int] = None, model: int = 1, *,
                    device: str = "cuda"):
    """(data, model) over every rank of the process group (1 rank →
    (1, 1))."""
    n = _world()
    if data is None:
        data = n // model
    return make_mesh((data, model), ("data", "model"), device=device)
