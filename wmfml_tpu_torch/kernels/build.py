"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``wmfml_tpu_torch/_build/lib<name>_<hash>.so`` for ``sm_90a`` (no
PyTorch headers, so a build takes seconds, not minutes). The content hash
in the file name (the source and the ``csrc/*.cuh`` headers it may include)
makes a stale library impossible to load. ``load_all``
starts one nvcc per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("stem", "stem_bwd", "favor", "features", "image_da")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
ptxas_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> str:
    # the source, every shared header beside it, and the flags
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; return
    (process, temporary output, final path) or None."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def load_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every named source not loaded yet."""
    names = tuple(names)
    with _lock:
        builds = {n: _start(n) for n in names if n not in _libs}
        # wait for every compiler before raising, so none is left running
        logs = {n: b[0].communicate()[0] for n, b in builds.items() if b}
        for n, b in builds.items():
            if b:
                proc, tmp, path = b
                ptxas_log[n] = logs[n]
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for csrc/{n}.cu:\n{logs[n]}")
                os.replace(tmp, path)
            _libs[n] = ctypes.CDLL(_lib_path(n))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    return load_all((name,))[name]
