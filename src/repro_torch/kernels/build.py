"""Build and load the port's CUDA kernels.

Each kernel source under ``kernels/<name>/csrc`` exposes a plain C entry
point (no PyTorch headers). At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/kernels/`` at the root of
the checkout, named by a hash of the source, of every file it includes
with ``#include "..."`` (``kernels/csrc/hopper.cuh``) and of the flags, so
a changed source or header never loads a stale library, and loaded with
``ctypes``.
``build`` compiles several sources at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# one loaded library per source file, for the life of the process
_LOADED: Dict[Path, ctypes.CDLL] = {}
# what the compiler said for each built source, and how long it took
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (set CUDA_HOME)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources_of(source: Path) -> list:
    """``source`` and every file it reaches through ``#include "..."``
    (resolved against the including file's directory, as nvcc does), each
    once, in the order met."""
    seen, todo = [], [Path(source).resolve()]
    while todo:
        path = todo.pop(0)
        if path not in seen:
            seen.append(path)
            todo += [(path.parent / name.decode()).resolve()
                     for name in _INCLUDE.findall(path.read_bytes())]
    return seen


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for path in sources_of(source):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> None:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; wait for all of them, then raise if
    any failed."""
    jobs = []
    for source in (Path(s).resolve() for s in sources):
        lib_path = _lib_path(source)
        if source in _LOADED or lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((source, lib_path, tmp, proc, time.perf_counter()))
    failed = []
    for source, lib_path, tmp, proc, t0 in jobs:
        out, err = proc.communicate()
        BUILD_SECONDS[source.name] = time.perf_counter() - t0
        BUILD_LOG[source.name] = out + err
        if proc.returncode == 0:
            os.replace(tmp, lib_path)
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {source.name}:\n{out}{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content) and load it. The wrappers
    call this at every launch: a loaded library is found under the path
    as given, without ``resolve()``, whose file-system calls can cost
    more than the launch (``chip_smoke.py`` phase 14 prints both)."""
    lib = _LOADED.get(source)
    if lib is None:
        resolved = Path(source).resolve()
        if resolved not in _LOADED:
            build([resolved])
            _LOADED[resolved] = ctypes.CDLL(str(_lib_path(resolved)))
        lib = _LOADED[source] = _LOADED[resolved]
    return lib
