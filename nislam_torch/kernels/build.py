"""Build and load the port's CUDA kernels: nvcc → ``nislam_torch/_build/`` → ctypes.

Each kernel source in ``nislam_torch/csrc/`` is compiled at first use into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), cached by a hash of the source and the flags, and loaded
with ``ctypes``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else ``$CUDA_HOME/bin``, else the toolkit's default
    install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME")
    return path


def library_path(name: str) -> str:
    """Cache path of kernel ``name``'s library, keyed by source and flags."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its cached library exists; returns
    the library path.  The library is written under a temporary name and
    renamed into place, so a concurrent or cut-off build never leaves a
    partial file behind."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def loaded() -> tuple:
    """Names of the kernels whose libraries this process has loaded."""
    with _lock:
        return tuple(_loaded)


def load_library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed), load and ``bind`` (declare the C signatures of)
    kernel ``name`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _loaded[name] = lib
        return lib
