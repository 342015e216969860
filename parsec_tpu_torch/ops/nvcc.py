"""Build a CUDA source of the package into a shared library and load it.

Each ``.cu`` file under ``ops/csrc/`` exposes a plain C interface. On
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``parsec_tpu_torch/_build/`` and loaded with ``ctypes``. The library's
file name carries a hash of the source and the flags, so an edited
source rebuilds instead of loading a stale binary (the source-hash cache
idiom of the reference package's native core loader). There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per source: seconds spent in nvcc (0.0 when the cached library was
# loaded) and the compiler's resource report (-Xptxas -v)
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc") if root else ""
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` at the current
    source and flags."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:16]}.so")


def _build(name: str, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n{build_log[name]}")
    os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = library_path(name)
            if os.path.exists(so):
                build_seconds.setdefault(name, 0.0)
            else:
                _build(name, so)
            lib = ctypes.CDLL(so)
            _libs[name] = lib
    return lib
