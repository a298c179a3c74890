"""Checkpointing of the port (``repro/checkpoint``): atomic, async, with
retention, in the JAX package's on-disk format; ``restore_on_mesh``
lays a checkpoint out on any mesh."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_step, load_pytree, read_extra, read_manifest,
    save_pytree,
)
from repro_torch.checkpoint.elastic import restore_on_mesh  # noqa: F401
