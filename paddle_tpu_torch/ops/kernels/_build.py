"""Build the port's CUDA sources (``paddle_tpu_torch/csrc/<name>.cu``)
into shared libraries with a plain C interface, and load them with
ctypes.

A source compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the repository root, at first use
(the hash covers the source and the flags, so an edited source never
loads a stale library). Nothing here runs at import time: the module
imports on a machine with no ``nvcc`` and no card."""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from ...core.enforce import KernelCompileError

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    """One built library: its path, the seconds ``nvcc`` took (0 when it
    was already built) and the compiler's output (``-Xptxas -v``
    registers, shared memory and spills per kernel)."""

    name: str
    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelCompileError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelCompileError(f"no CUDA source {src}")
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless this source, with these flags,
    is built already. Raises :class:`KernelCompileError` with the
    compiler output on failure."""
    path = library_path(name)
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Built(name, path, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelCompileError(f"nvcc failed for {name}.cu "
                                 f"(rc {proc.returncode}):\n{proc.stdout}")
    log_path.write_text(proc.stdout)
    os.replace(tmp, path)   # atomic: a concurrent build never sees a
    # half-written library
    return Built(name, path, secs, proc.stdout)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name).path))
            _loaded[name] = lib
        return lib
