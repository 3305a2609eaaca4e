"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface, loaded through ctypes (no PyTorch headers, so a
build takes seconds). Libraries land in ``openembedding_tpu_torch/_build/``
(listed in ``.gitignore``) under a name that carries a hash of the source
and the flags, so an edited source never loads a stale library. Nothing
is built at import: the first kernel call builds, or :func:`build_all`
builds every source at once, one ``nvcc`` process per source, all started
together.

``nvcc`` is found through ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then
the toolkit's default install prefix ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from csrc/ at first use")


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start one nvcc (or return None when the library is already built)."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, out, cmd


def _finish(name: str, started, t0: float) -> float:
    """Wait for one nvcc; returns its seconds (0.0 for a cached build)."""
    if started is None:
        return 0.0
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all() -> Dict[str, float]:
    """Compile every csrc source in parallel; returns seconds per source."""
    with _lock:
        t0 = time.perf_counter()
        started = {name: _start(name) for name in sources()}
        return {name: _finish(name, s, t0) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            _finish(name, _start(name), t0)
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
