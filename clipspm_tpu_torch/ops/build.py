"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``clipspm_tpu_torch/build/`` (git-ignored), then
loaded with ``ctypes``. The library's file name carries a hash of its source
and of every ``csrc/*.cuh`` header, so an edited kernel or shared header is
rebuilt and a stale build is never loaded. ``nvcc`` runs with ``-Xptxas -v``
and its report (registers, shared memory, spills of each kernel) is kept
beside the library as ``<library>.ptxas.txt``. Nothing is
built when a module is imported: the CPU tests import every module on a host
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source at first use")


def library_path(name: str) -> str:
    """The build of ``csrc/<name>.cu``: its name hashes the source and every
    header under ``csrc/`` (any of them may be included)."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current build exists; returns
    the library path. Safe to call from several threads for different
    sources (each writes its own temporary file)."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    with open(f"{out}.ptxas.txt", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
