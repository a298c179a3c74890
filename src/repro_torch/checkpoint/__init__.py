"""Checkpointing of the port (``repro/checkpoint``): atomic, async, with
retention, in the JAX package's on-disk format. ``elastic.py``'s
``restore_on_mesh`` waits with the multi-device work (ROADMAP queue A
item 7)."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_step, load_pytree, read_extra, read_manifest,
    save_pytree,
)
