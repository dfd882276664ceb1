"""Build and bind the port's CUDA C++ sources.

Each ``nerf_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and loaded
with ``ctypes``. No PyTorch headers are included, so a source builds in
seconds. The libraries go to ``build/nerf_tpu_torch/`` beside the package,
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused. ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for every one of them.

Calling convention of every C entry point: pointers and the CUDA stream are
``void*`` (``ctypes.c_void_p``; a bare Python int would be cut to 32 bits),
the kernel launches on the given stream, allocates nothing, never
synchronises, and the function returns ``cudaGetLastError()`` as an int.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
SOURCES = ("render_samples", "composite")
# no --use_fast_math: the positional encoding takes sinf/cosf of phases up
# to 2^9 * pi * |x| (thousands of radians), which the fast intrinsics'
# range reduction cannot hold
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source whose library is missing, in parallel.
    Returns the seconds spent. The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept in
    ``build/nerf_tpu_torch/<name>.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        so = library_path(name)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
