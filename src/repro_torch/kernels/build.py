"""Build and load the port's CUDA kernels.

Each kernel source under ``kernels/<name>/csrc`` exposes a plain C entry
point (no PyTorch headers). At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/kernels/`` at the root of
the checkout, named by a hash of the source and the flags so a changed
source never loads a stale library, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

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


def load_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content) and load it."""
    source = Path(source).resolve()
    if source in _LOADED:
        return _LOADED[source]
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source.name}:\n{proc.stdout}"
                    f"{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_SECONDS[source.name] = time.perf_counter() - t0
        BUILD_LOG[source.name] = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[source] = lib
    return lib
