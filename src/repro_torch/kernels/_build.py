"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout and
loaded with :mod:`ctypes` (a plain C interface: no PyTorch headers, so a
build takes seconds). ``<hash>`` is a content hash of the source, of the
headers it includes from ``csrc/`` (``#include "x.cuh"``) and of the
compiler flags, so an edited source or header rebuilds and an unchanged
one is loaded as it is. A failed build raises; nothing falls back.

Every source gets :data:`NVCC_FLAGS`. A source adds its own flags on a
line of its own that starts with ``// nvcc-flags:`` (the drain tick asks
for ``--fmad=false`` there); they are part of the hash.
:func:`load_all` starts one ``nvcc`` per source, all at once.
:func:`ptr` and :func:`check_tensor` serve the ctypes wrappers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
FLAGS_TAG = "// nvcc-flags:"
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


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


def file_flags(path: Path) -> Tuple[str, ...]:
    """The flags a CUDA source is compiled with: the common set, then those
    of the source's own ``// nvcc-flags:`` lines."""
    own = []
    for line in Path(path).read_text().splitlines():
        if line.startswith(FLAGS_TAG):
            own.extend(line[len(FLAGS_TAG):].split())
    return NVCC_FLAGS + tuple(own)


def source_flags(name: str) -> Tuple[str, ...]:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return file_flags(CSRC / f"{name}.cu")


def local_headers(path: Path) -> Tuple[Path, ...]:
    """The headers a source includes with quotes from its own directory,
    and those they include in turn, in the order first met."""
    path = Path(path)
    seen: Dict[Path, None] = {}
    todo = [path]
    while todo:
        for inc in INCLUDE.findall(todo.pop(0).read_text()):
            h = path.parent / inc
            if h.exists() and h not in seen:
                seen[h] = None
                todo.append(h)
    return tuple(seen)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a content hash of the
    source, the headers it includes and its flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(source_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """The libraries built from ``csrc/<name>.cu`` for every name; the
    sources not yet built are compiled by one ``nvcc`` each, all started
    together. Raises on the first build that failed."""
    names = list(dict.fromkeys(names))
    todo = [n for n in names if n not in _LIBS]
    t0 = time.perf_counter()
    jobs = {}
    try:
        for name in todo:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *source_flags(name), "-o", tmp,
                   str(CSRC / f"{name}.cu")]
            jobs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = {}
        for name, (tmp, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                    f"{log}")
            os.replace(tmp, library_path(name))
            logs[name] = log
    finally:
        for tmp, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    for name in todo:
        out = library_path(name)
        _LIBS[name] = ctypes.CDLL(str(out))
        BUILD_LOG[name] = dict(path=str(out),
                               seconds=time.perf_counter() - t0,
                               compiler_output=logs.get(name, ""))
    return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled if not cached."""
    return load_all([name])[name]


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes argument."""
    return ctypes.c_void_p(x.data_ptr())


def check_tensor(kernel: str, x: torch.Tensor, name: str, dtype, shape,
                 device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel takes as a raw pointer."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}")
