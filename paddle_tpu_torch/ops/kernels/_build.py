"""Build the port's CUDA sources (``paddle_tpu_torch/csrc/<name>.cu``)
into shared libraries with a plain C interface, and load them with
ctypes.

A source compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the repository root, at first use
(the hash covers the source and the flags, so an edited source never
loads a stale library). A source listed in :data:`PARTS` compiles as
several translation units at once, one ``nvcc -c`` each with the
source's part macro set, linked into the one library. Nothing here runs
at import time: the module imports on a machine with no ``nvcc`` and no
card."""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

from ...core.enforce import KernelCompileError

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_FLAGS = COMPILE_FLAGS + ("-shared",)
# {source: (its part macro, the number of parts)}: part 0 holds the entry
# points, each other part a group of kernel instances
PARTS = {"flash_attention": ("PT_FLASH_PART", 9)}

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
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                       + repr(PARTS.get(name)).encode())
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
    src = str(CSRC / f"{name}.cu")
    t0 = time.perf_counter()
    if name in PARTS:
        macro, n = PARTS[name]
        objs = [path.with_suffix(f".{os.getpid()}.part{k}.o")
                for k in range(n)]
        try:
            with ThreadPoolExecutor(n, thread_name_prefix="pt-nvcc") as pool:
                logs = list(pool.map(
                    lambda k: _nvcc(name, [*COMPILE_FLAGS, "-c",
                                           f"-D{macro}={k}", "-o",
                                           str(objs[k]), src]), range(n)))
            logs.append(_nvcc(name, ["-shared", "-o", str(tmp),
                                     *map(str, objs)]))
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        log = "".join(logs)
    else:
        log = _nvcc(name, [*NVCC_FLAGS, "-o", str(tmp), src])
    secs = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, path)   # atomic: a concurrent build never sees a
    # half-written library
    return Built(name, path, secs, log)


def _nvcc(name: str, args: Sequence[str]) -> str:
    """One ``nvcc`` run; its output, or :class:`KernelCompileError`
    with it."""
    proc = subprocess.run([nvcc(), *args], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise KernelCompileError(f"nvcc failed for {name}.cu "
                                 f"(rc {proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name).path))
            _loaded[name] = lib
        return lib
