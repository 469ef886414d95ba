"""Build and load a hand-written CUDA kernel's shared library.

Each kernel directory holds its source under ``csrc/`` and builds it with
``nvcc`` for ``sm_90a`` at first use into a shared library with a plain C
interface, under ``build/<hash of the source bytes and flags>/`` beside its
``ops.py``, loaded with ``ctypes``.  Keying the directory on the source and
the flags means an edited source never loads a stale build.  The compiler's
output (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``nvcc.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Tuple

__all__ = ["NVCC_FLAGS", "library_path", "load"]

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks: Dict[Path, threading.Lock] = {}
_locks_guard = threading.Lock()


def library_path(source: Path, build_dir: Path, name: str,
                 flags: Tuple[str, ...] = NVCC_FLAGS) -> Path:
    """``build_dir/<hash>/name``, the hash over ``source``'s bytes and the
    compiler flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(flags).encode())
    return Path(build_dir) / h.hexdigest()[:16] / name


def _nvcc() -> str:
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def _build(source: Path, so: Path, flags: Tuple[str, ...]) -> None:
    """Compile into a temporary name and rename, so a concurrent build or an
    interrupted one never leaves a half-written library under ``so``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (so.parent / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source.name}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, so)


def load(source: Path, so: Path, configure: Callable[[ctypes.CDLL], None],
         flags: Tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """Build ``source`` into ``so`` unless it is there, load it, and let
    ``configure`` set the entry points' ``argtypes``.  Each library has its
    own lock, so two kernels build in parallel and one never twice."""
    with _locks_guard:
        lock = _locks.setdefault(so, threading.Lock())
    with lock:
        if not so.exists():
            _build(source, so, flags)
        lib = ctypes.CDLL(str(so))
        configure(lib)
        return lib
