"""ctypes bindings for the port's host runtime: two C++ libraries.

Counterpart of ``nerf_tpu/runtime/__init__.py``. ``runtime.cpp`` holds
``RayBatchSampler``, a background C++ producer of shuffled training ray
batches (the streaming trainer's input), and ``assemble_tiles``, which
stitches ray tiles into a frame; ``png.cpp`` holds ``decode_png_batch``,
the threaded PNG decoder (libpng) that ``data/blender.py`` reads a dataset
with. The same C interfaces and arithmetic as the JAX package's library, so
one seed gives the same batches, and one file the same floats, bit for bit.
The decoder is a library of its own, so the ray producer needs no libpng.

Each library is built at first use with ``g++`` into
``build/nerf_tpu_torch/`` beside the package, named by a hash of its source
and its flags (an edited source is rebuilt), under a file lock, through a
temporary file and ``os.replace``; the compiler's output is kept in
``runtime.log`` / ``png.log`` there. Nothing falls back: a failed build or
load raises (the JAX module's numpy fallback would draw other batches from
the same seed), and so does a PNG that fails to decode (the JAX module
decodes it with PIL instead, which the card's machine lacks), naming it.
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
PNG_SOURCE = SOURCE.with_name("png.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
# library -> (source, its own compiler flags, what it links). The decoder's
# products and sums stay as written on any target (no contraction to FMA)
LIBRARIES = {
    "nerf_runtime": (SOURCE, (), ()),
    "nerf_png": (PNG_SOURCE, ("-ffp-contract=off",), ("-lpng", "-lz")),
}

_lib: Optional[ctypes.CDLL] = None        # libnerf_runtime, bound at first use
_png_lib: Optional[ctypes.CDLL] = None    # libnerf_png, bound at first use
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
_PNG_SIGNATURES = {
    "nerf_decode_png_batch": ([ctypes.c_char_p, ctypes.c_int, _F, ctypes.c_uint32,
                               ctypes.c_uint32, ctypes.c_int, ctypes.c_int], ctypes.c_int),
}


def library_path(name: str = "nerf_runtime") -> Path:
    source, flags, libs = LIBRARIES[name]
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((CXX,) + CXX_FLAGS + flags + libs).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str = "nerf_runtime") -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises with the compiler's output if the build fails."""
    source, flags, libs = LIBRARIES[name]
    so = library_path(name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / f"{source.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # another process may be building it
        if so.exists():
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, *flags, str(source), "-o", str(tmp), *libs],
                                  capture_output=True, text=True)
        except OSError as e:                    # no compiler at all
            raise RuntimeError(f"nerf_tpu_torch.runtime: cannot run {CXX}: {e}") from e
        (so.parent / f"{source.stem}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nerf_tpu_torch.runtime: {CXX} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def _bind(name: str, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def load_library() -> ctypes.CDLL:
    """The bound ray-producer library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind("nerf_runtime", _SIGNATURES)
        return _lib


def load_png_library() -> ctypes.CDLL:
    """The bound PNG decoder, built at first use (needs libpng's headers)."""
    global _png_lib
    with _lib_lock:
        if _png_lib is None:
            _png_lib = _bind("nerf_png", _PNG_SIGNATURES)
        return _png_lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


def decode_png_batch(paths: Sequence[str], img_wh: Tuple[int, int],
                     white_background: bool = True, n_threads: int = 0) -> np.ndarray:
    """Decode PNGs into ``[n, H, W, 3]`` float32 in ``[0, 1]`` on the host:
    bilinearly resized to ``img_wh = (W, H)`` (at the PNG's own size each
    pixel is its bytes / 255), RGBA composited onto white where
    ``white_background``, on ``n_threads`` threads (0: one per hardware
    thread). Raises naming the files that failed to decode."""
    w, h = img_wh
    paths = [os.fspath(p) for p in paths]
    if w <= 0 or h <= 0:
        raise ValueError(f"decode_png_batch: image size {img_wh}")
    if any("\n" in p for p in paths):
        raise ValueError("decode_png_batch: a path holds a newline")
    out = np.empty((len(paths), h, w, 3), np.float32)
    if not paths:
        return out
    lib = load_png_library()
    failures = lib.nerf_decode_png_batch("\n".join(paths).encode(), len(paths), _fptr(out),
                                         w, h, int(white_background), n_threads)
    if failures:
        probe = np.empty((h, w, 3), np.float32)
        bad = [p for p in paths if lib.nerf_decode_png_batch(p.encode(), 1, _fptr(probe), w, h,
                                                             0, 1)]
        raise RuntimeError(f"nerf_tpu_torch.runtime: {failures} of {len(paths)} PNGs failed "
                           f"to decode: {bad}")
    return out


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
