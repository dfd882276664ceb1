"""ctypes bindings for the port's host runtime (``runtime.cpp``).

Counterpart of ``nerf_tpu/runtime/__init__.py`` without the PNG decoder:
``RayBatchSampler``, a background C++ producer of shuffled training ray
batches (the streaming trainer's input), and ``assemble_tiles``, which
stitches ray tiles into a frame. The same C interface and arithmetic as the
JAX package's library, so one seed gives the same batches bit for bit.

The library is built at first use with ``g++`` into ``build/nerf_tpu_torch/``
beside the package, named by a hash of the source and the flags (an edited
source is rebuilt), under a file lock, through a temporary file and
``os.replace``; the compiler's output is kept in ``runtime.log`` there.
Nothing falls back: a failed build or load raises (the JAX module's numpy
fallback would draw other batches from the same seed).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

_F = ctypes.POINTER(ctypes.c_float)
_U64 = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "nerf_sampler_create": ([_F, _F, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                             ctypes.c_float, ctypes.c_uint32, ctypes.c_uint64], ctypes.c_void_p),
    "nerf_sampler_next": ([ctypes.c_void_p, _F, _F, _F], None),
    "nerf_sampler_destroy": ([ctypes.c_void_p], None),
    "nerf_assemble_tiles": ([_F, _U64, _U64, ctypes.c_uint32, _F, ctypes.c_uint64,
                             ctypes.c_uint32], None),
}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((CXX,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libnerf_runtime-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises with the compiler's output if the build fails."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "runtime.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # another process may be building it
        if so.exists():
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
        except OSError as e:                    # no compiler at all
            raise RuntimeError(f"nerf_tpu_torch.runtime: cannot run {CXX}: {e}") from e
        (so.parent / "runtime.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nerf_tpu_torch.runtime: {CXX} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The bound library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


class RayBatchSampler:
    """Background native producer of shuffled ``(rays_o, rays_d, rgb)``
    training batches (``[n_rays, 3]`` float32 numpy arrays each) from
    host-resident images: each batch is ``n_rays`` pixels, drawn with
    replacement, of one image drawn at random. Use as a context manager;
    ``blocked_s`` accumulates the seconds ``next_batch`` waited for the
    producer and copied its batch."""

    def __init__(self, images: np.ndarray, poses: np.ndarray, focal: float,
                 n_rays: int, seed: int = 0):
        n, h, w, _ = images.shape
        self.n_rays = n_rays
        self.shape = (n, h, w)
        self._images = np.ascontiguousarray(images, np.float32)
        self._poses = np.ascontiguousarray(poses, np.float32)
        self._focal = float(focal)
        self._seed = seed
        self._lib = load_library()
        self._handle = None
        self.blocked_s = 0.0

    def __enter__(self):
        self._handle = ctypes.c_void_p(self._lib.nerf_sampler_create(
            _fptr(self._images), _fptr(self._poses), *self.shape, self._focal, self.n_rays,
            self._seed or 1))
        return self

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._handle is None:
            raise RuntimeError("RayBatchSampler.next_batch outside its with block")
        rays_o, rays_d, rgb = (np.empty((self.n_rays, 3), np.float32) for _ in range(3))
        t0 = time.perf_counter()
        self._lib.nerf_sampler_next(self._handle, _fptr(rays_o), _fptr(rays_d), _fptr(rgb))
        self.blocked_s += time.perf_counter() - t0
        return rays_o, rays_d, rgb

    def __exit__(self, *exc):
        if self._handle is not None:
            self._lib.nerf_sampler_destroy(self._handle)
            self._handle = None
        return False


def assemble_tiles(tiles: Sequence[np.ndarray], offsets: Sequence[int], frame_rays: int,
                   channels: int) -> np.ndarray:
    """Stitch row-contiguous ray tiles (per-card render shards, say) into one
    ``[frame_rays, channels]`` float32 frame; rows no tile covers are 0, and
    a tile that would end past the frame is dropped."""
    frame = np.zeros((frame_rays, channels), np.float32)
    if not tiles:
        return frame
    flat: List[np.ndarray] = [np.asarray(t, np.float32).reshape(-1, channels) for t in tiles]
    cat = np.ascontiguousarray(np.concatenate(flat), np.float32)
    offs = np.asarray(offsets, np.uint64)
    lens = np.asarray([t.shape[0] for t in flat], np.uint64)
    load_library().nerf_assemble_tiles(_fptr(cat), offs.ctypes.data_as(_U64),
                                       lens.ctypes.data_as(_U64), len(flat), _fptr(frame),
                                       frame_rays, channels)
    return frame
