"""Elastic restore: lay a checkpoint out on a different mesh (port of
``repro/checkpoint/elastic.py``).

Checkpoints store logical (whole) arrays in the JAX package's format, so
restoring elastically is: build the new mesh, resolve the same logical
sharding rules against it, and place every leaf with its placements.
Each rank reads the file and keeps its own block; nothing is sent. Batch
divisibility is the caller's concern; parameter layouts need no
divisibility, since the rules fall back to replication for dims that do
not divide.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint.manager import load_pytree
from repro_torch.sharding import Rules, distribute_tree


def restore_on_mesh(
    path: str,
    like: Any,
    spec_tree: Any,
    mesh,
    rules: Optional[Rules] = None,
) -> Tuple[Any, Dict]:
    """Load ``path`` and place it on ``mesh`` (a named ``DeviceMesh``)
    by ``spec_tree``'s logical names (the structure of ``like``),
    whatever mesh the checkpoint was written under; the leaves land on
    the mesh's device type. Returns (tree of DTensors, extra)."""
    rules = rules or Rules.for_mesh(mesh)
    host_tree, extra = load_pytree(path, like)
    device = mesh.device_type
    if device == "cuda":
        import torch
        device = f"cuda:{torch.cuda.current_device()}"
    from repro_torch.tree import tree_map
    host_tree = tree_map(lambda x: x.to(device), host_tree)
    return distribute_tree(host_tree, spec_tree, rules), extra
