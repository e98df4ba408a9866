"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -I kernels/csrc -o build/repro_torch/<name>-<hash>.so <name>.cu

``kernels/csrc/common.cuh`` holds the device helpers the kernels share; a
source may include headers of its own directory (``expand/csrc/
expand_bulk.cuh``). Libraries go to ``build/repro_torch/`` at the root of
the checkout, named by a hash of their source, the headers beside it and
the shared header, so an edit rebuilds and an unchanged source is reused. The build runs at first use, never at
import time.
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

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"
SOURCES = {
    "expand": _KERNELS / "expand" / "csrc" / "expand.cu",
    "gatherdist": _KERNELS / "gatherdist" / "csrc" / "gatherdist.cu",
    "expand_int8": _KERNELS / "expand" / "csrc" / "expand_int8.cu",
    "gatherdist_int8": _KERNELS / "gatherdist" / "csrc" / "gatherdist_int8.cu",
    "rerank_fetch": _KERNELS / "rerank_fetch" / "csrc" / "rerank_fetch.cu",
    "rangescan": _KERNELS / "rangescan" / "csrc" / "rangescan.cu",
    "flashattn": _KERNELS / "flashattn" / "csrc" / "flashattn.cu",
    "flashattn_wgmma": _KERNELS / "flashattn" / "csrc" / "flashattn_wgmma.cu",
}
COMMON = _KERNELS / "csrc" / "common.cuh"
# no --use_fast_math: the int8 kernels need true IEEE divisions and square
# roots to round query codes and bounds as the plain versions do
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(COMMON.parent)]

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()   # the fan-out's threads may load a library at once


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers
    beside it and the shared header."""
    src = SOURCES[name]
    parts = [src, *sorted(src.parent.glob("*.cuh")), COMMON]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns
    (process, temporary path, final path), or None when already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=None) -> dict[str, str]:
    """Compile the named sources (all by default), one nvcc each, all
    started together. Returns each build's compiler output (ptxas register
    and shared-memory report); raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    jobs = {n: _start(n) for n in names}
    logs, failed = {}, []
    for n, job in jobs.items():
        if job is None:
            logs[n] = "(cached)"
            continue
        proc, tmp, out = job
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(n)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _load_lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def check(lib: ctypes.CDLL, prefix: str, rc: int) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} kernel launch failed ({rc}): "
                           f"{fn(rc).decode()}")
