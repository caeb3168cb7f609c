"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout and
loaded with :mod:`ctypes` (a plain C interface: no PyTorch headers, so a
build takes seconds). ``<hash>`` is a content hash of the source and the
compiler flags, so an edited source rebuilds and an unchanged one is
loaded as it is. A failed build raises; nothing falls back.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


# name -> loaded library / build record of this process
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin); the "
        "port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content hash."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled if not cached."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed on {name}.cu (exit {res.returncode}):\n"
                    f"{res.stdout}\n{res.stderr}")
            log = res.stdout + res.stderr
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    BUILD_LOG[name] = dict(path=str(out), seconds=time.perf_counter() - t0,
                           compiler_output=log)
    _LIBS[name] = lib
    return lib
