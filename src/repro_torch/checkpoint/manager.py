"""Checkpointing with atomic writes and async saves (port of
``repro/checkpoint/manager.py``).

The on-disk format is the JAX package's, so either package restores the
other's checkpoints:

* ``step_N/arrays.npz`` holds one host array per leaf, named by its tree
  path (``tree.leaves_with_paths``: ``opt/mu/embed``, ...), and
  ``step_N/manifest.json`` the ``keys`` in flattening order, each leaf's
  ``dtypes`` and the caller's ``extra`` dict. bfloat16 has no numpy type
  without ``ml_dtypes``: its leaves are written as raw two-byte ``V2``
  arrays beside ``"bfloat16"`` in ``dtypes`` (what ``np.savez`` makes of
  JAX's ``ml_dtypes`` arrays) and viewed back through int16.
* **atomic**: a step is staged as ``step_N.tmp`` and ``os.replace``d into
  place; a crash mid-save leaves only a ``.tmp``, removed when the next
  manager is constructed.
* **async**: ``save(..., blocking=False)`` copies every leaf to host
  memory synchronously and writes in a background thread. The copy is
  owned: the port's AdamW updates parameters and moments in place, and a
  CPU tensor's ``.cpu()`` or ``.numpy()`` would share the storage that
  the next step overwrites. ``wait()`` joins the writer.
* **retention**: the newest ``keep`` steps stay.
* **meshes**: a tree of DTensors is saved as its logical (whole)
  arrays, gathered on every rank and written by rank 0 alone, so
  ``restore_on_mesh`` lays it out on any mesh.

``load_pytree`` and ``restore`` place each leaf on the template leaf's
device and dtype.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import full, is_dtensor
from repro_torch.tree import leaves, leaves_with_paths, tree_map


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """An owned host copy of a leaf, taken at the call."""
    return x.detach().to("cpu", copy=True)


def _to_numpy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, the dtype name the manifest records)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = x.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A stored array as a tensor; ``ValueError`` for raw bytes of any
    extension dtype but bfloat16 (JAX's float8, which the port holds in
    no tree)."""
    if arr.dtype.kind == "V":
        if dtype_name != "bfloat16":
            raise ValueError(f"raw {arr.dtype} leaf of dtype {dtype_name!r}: "
                             f"the port reads bfloat16 only")
        return torch.from_numpy(np.asarray(arr, order="C").view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


def save_pytree(path: str, tree: Any, extra: Optional[Dict] = None) -> None:
    """Write ``tree`` to the directory ``path`` atomically."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays, manifest, dtypes = {}, [], {}
    for key, leaf in leaves_with_paths(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
        manifest.append(key)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"keys": manifest, "dtypes": dtypes,
                   "extra": extra or {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _corrupt(path: str, why: str) -> ValueError:
    return ValueError(f"corrupt checkpoint at {path}: {why}")


def read_manifest(path: str) -> Dict:
    """Read and validate a checkpoint directory's manifest, rejecting a
    missing, truncated or corrupt file with a ``ValueError`` that names
    the path."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise _corrupt(path, "manifest.json missing")
    try:
        with open(manifest_path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise _corrupt(path, f"unreadable manifest.json ({e})") from e
    if not isinstance(meta, dict) or "keys" not in meta:
        raise _corrupt(path, "manifest.json missing 'keys'")
    return meta


def read_extra(path: str) -> Dict:
    """The manifest's ``extra`` dict alone (same validation as
    :func:`read_manifest`)."""
    return read_manifest(path).get("extra", {})


def _place(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def load_pytree(path: str, like: Any) -> Tuple[Any, Dict]:
    """Load into the structure of ``like`` (values replaced), each leaf a
    tensor on the template leaf's device and dtype.

    A truncated or corrupt checkpoint (missing or undecodable manifest
    or array archive, or an archive missing manifest keys) raises
    ``ValueError`` naming ``path``; callers fall back to an older step."""
    meta = read_manifest(path)
    arrays_path = os.path.join(path, "arrays.npz")
    if not os.path.exists(arrays_path):
        raise _corrupt(path, "arrays.npz missing")
    try:
        with np.load(arrays_path, allow_pickle=False) as data:
            try:
                arrays = {key: data[key] for key in meta["keys"]}
            except KeyError as e:
                raise _corrupt(
                    path, f"arrays.npz missing key {e.args[0]!r}") from e
    except ValueError:
        raise
    except Exception as e:  # BadZipFile, truncated member, OSError, ...
        raise _corrupt(path, f"unreadable arrays.npz ({e})") from e
    dtypes, flat = meta.get("dtypes", {}), []
    for key, leaf in leaves_with_paths(like):
        if key not in arrays:
            raise _corrupt(path, f"checkpoint lacks leaf {key!r} required "
                           f"by the restore template")
        try:
            flat.append(_place(_to_tensor(arrays[key], dtypes.get(key)),
                               leaf))
        except ValueError as e:
            raise ValueError(f"checkpoint at {path}, leaf {key!r}: {e}"
                             ) from e
    it = iter(flat)
    return tree_map(lambda _: next(it), like), meta.get("extra", {})


_STEP = re.compile(r"step_(\d+)")


def _steps(directory: str) -> List[int]:
    return sorted(int(m.group(1)) for m in map(_STEP.fullmatch,
                                               os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._writer: Optional[threading.Thread] = None
        self._writer_exc: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        # garbage-collect interrupted saves
        for name in os.listdir(directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        # an owned host copy, taken now: the writer thread must not read
        # tensors that the next step updates in place
        host_tree = tree_map(lambda x: _host_copy(full(x)), tree)
        if any(is_dtensor(x) for x in leaves(tree)):
            import torch.distributed as dist
            if dist.get_rank() != 0:     # rank 0 writes the whole arrays
                return

        def work():
            try:
                save_pytree(self._step_dir(step), host_tree, extra)
                self._retain()
            except BaseException as e:   # surfaced on the next wait()
                self._writer_exc = e

        if blocking:
            work()
            if self._writer_exc:
                exc, self._writer_exc = self._writer_exc, None
                raise exc
        else:
            self._writer = threading.Thread(target=work, daemon=True)
            self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_exc is not None:
            exc, self._writer_exc = self._writer_exc, None
            raise exc

    def steps(self) -> List[int]:
        """Retained step numbers, oldest to newest."""
        return _steps(self.directory)

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict, int]:
        """Restore the requested (default: newest) step.

        An explicitly requested corrupt step raises its ``ValueError``
        (naming the step directory). With ``step=None`` a corrupt newest
        step falls back to the next-oldest retained step, and only raises
        if every retained step is corrupt."""
        return self.restore_with(lambda extra: like, step)

    def restore_with(self, like_fn: Callable[[Dict], Any],
                     step: Optional[int] = None) -> Tuple[Any, Dict, int]:
        """Like :meth:`restore`, with the template tree built from the
        checkpoint's own ``extra`` dict: ``like_fn(extra)`` → like."""
        self.wait()
        if step is not None:
            extra = read_extra(self._step_dir(step))
            tree, extra = load_pytree(self._step_dir(step), like_fn(extra))
            return tree, extra, step
        candidates = self.steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        last_err: Optional[ValueError] = None
        for s in reversed(candidates):
            try:
                extra = read_extra(self._step_dir(s))
                tree, extra = load_pytree(self._step_dir(s), like_fn(extra))
                return tree, extra, s
            except ValueError as e:
                last_err = e
        raise last_err

    def has_checkpoint(self) -> bool:
        return latest_step(self.directory) is not None

    def _retain(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
