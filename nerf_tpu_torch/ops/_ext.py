"""Build and bind the port's CUDA C++ sources.

Each ``nerf_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and loaded
with ``ctypes``. No PyTorch headers are included, so a source builds in
seconds. ``VARIANTS`` are further libraries built from one of the sources
with a preprocessor definition: the Hopper MLP kernels on the int8-compute
weight route, which needs a build of its own. The libraries go to
``build/nerf_tpu_torch/`` beside the package, named by a hash of the
source, the headers it includes (``#include "..."``, transitively) and the
flags, so an edited source or header rebuilds the libraries that include it
and an unchanged one is reused. ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for every one of them.

Calling convention of every C entry point: pointers and the CUDA stream are
``void*`` (``ctypes.c_void_p``; a bare Python int would be cut to 32 bits),
the kernel launches on the given stream, allocates nothing, never
synchronises, and the function returns ``cudaGetLastError()`` as an int.
A group of pointers (the packed weights, the gradient arrays) is passed as
one array of ``void*`` (``pointer_array``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
SOURCES = ("composite", "ray_wgmma", "mlp_backward_wgmma", "dequant_stream", "occupancy",
           "mip360_wgmma")
# library -> (source, definition): the Hopper MLP kernels on the int8-compute
# route (they take int8 and int16 weights in their bf16 build, after
# dequant_stream)
VARIANTS = {"ray_wgmma_i8": ("ray_wgmma", "-DNERF_WQ=3")}
LIBRARIES = SOURCES + tuple(VARIANTS)
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


def _source_and_flags(name: str):
    source, define = VARIANTS.get(name, (name, None))
    return CSRC / f"{source}.cu", NVCC_FLAGS + ((define,) if define else ())


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _included(source: Path) -> List[Path]:
    """The files ``source`` includes by ``#include "..."``, transitively,
    each once, in the order they are first reached."""
    seen: List[Path] = []
    todo = [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            header = source.parent / name.decode()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(name: str) -> Path:
    source, flags = _source_and_flags(name)
    digest = hashlib.sha256(source.read_bytes())
    for header in _included(source):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = LIBRARIES) -> float:
    """Compile every named library whose file is missing, in parallel.
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
        source, flags = _source_and_flags(name)
        cmd = [nvcc, *flags, "-o", str(tmp), str(source)]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (a source or a variant), built at first use."""
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


def pointer_array(tensors: Iterable[Optional[torch.Tensor]]):
    """A C array of ``void*`` to the tensors' data (NULL for None). The
    caller keeps the tensors alive until the launch has been enqueued."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ran() -> int:
    """What a launch just made on the current stream adds to its wrapper's
    count: 1 if it ran, 0 if the stream is capturing a CUDA graph. A captured
    launch only records the kernel; it runs on each replay, which no wrapper
    sees (a profiler trace counts those)."""
    capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
    return 0 if capturing else 1
