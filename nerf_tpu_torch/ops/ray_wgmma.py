"""The weight stream of the Hopper ray kernels (``csrc/ray_wgmma.cu``).

K1 and K3 on the bf16 weight route, raw output, run on ``csrc/ray_wgmma.cu``:
a producer warp copies the network into shared memory one chunk at a time
(``cp.async.bulk``, one contiguous copy a chunk) and two consumer
warpgroups multiply each chunk with ``wgmma``. This module lays the weights
out for that stream, once per ``PackedWeights`` (cached beside them):

- a chunk is a 64-row slab ``W[k0:k0 + 64, :]`` of one matrix (all its
  ``N`` columns: 256, or 128 for ``wc0``);
- in the stream it is the exact shared-memory image that ``wgmma``'s B
  descriptor reads: the slab transposed to ``[N, 64]`` (K-major: each output
  column's 64 weights contiguous, 128 bytes), in 1,024-byte atoms of 8
  columns, the 16-byte pieces of row ``r`` of an atom at position
  ``piece ^ r`` (the 128-byte swizzle);
- the chunks follow the consumers' order, the same for every tile
  (``chunk_schedule``): ``w0``; the four slabs of each trunk layer
  ``wt[0..6]``, with ``wskip`` after the layer at ``skip_pos``; the four of
  ``wbn`` (bmild); the four of ``wc0``. The producer walks it front to back.

``unpack_stream`` undoes the layout in plain PyTorch; the tests hold it
against ``pack_params`` bit for bit. Biases, ``wsig``, ``wc1`` and ``wdir``
are read from ``PackedWeights`` as they are.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.ops.mlp_kernel import HID, POS_ROWS, PackedWeights, skip_position

LIBRARY = "ray_wgmma"
CHUNK_K = 64          # weight rows per chunk
CH = HID // 2         # color layer width
_SWIZZLE = torch.arange(8)[:, None] ^ torch.arange(8)[None, :]   # [row, piece] -> piece ^ row


class Chunk(NamedTuple):
    name: str             # matrix of PackedWeights
    layer: Optional[int]  # index into wt, else None
    k0: int               # first row of the slab
    n: int                # columns (the product's N)

    @property
    def nbytes(self) -> int:
        return CHUNK_K * self.n * 2


def chunk_schedule(cfg: ModelConfig) -> List[Chunk]:
    """The chunks of one tile, in the order the consumers multiply them."""
    slabs = lambda name, layer=None, n=HID: [Chunk(name, layer, k, n)
                                             for k in range(0, HID, CHUNK_K)]
    out = [Chunk("w0", None, 0, HID)]
    skip_pos = skip_position(cfg)
    for i in range(1, 8):
        out += slabs("wt", i - 1)
        if i == skip_pos:
            out.append(Chunk("wskip", None, 0, HID))
    if cfg.variant == "bmild":
        out += slabs("wbn")
    return out + slabs("wc0", n=CH)


def _matrix(packed: PackedWeights, c: Chunk) -> torch.Tensor:
    w = getattr(packed, c.name)
    return w if c.layer is None else w[c.layer]


def _swizzled(slab: torch.Tensor) -> torch.Tensor:
    """``[64, N]`` slab -> its shared-memory image, flat."""
    t = slab.t().reshape(-1, 8, 8, 8)                       # [atom, row, piece, 8 values]
    return t[:, torch.arange(8)[:, None], _SWIZZLE.to(t.device)].reshape(-1)


def _unswizzled(flat: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``_swizzled``: the flat image -> ``[64, N]``."""
    t = flat.reshape(n // 8, 8, 8, 8)
    return t[:, torch.arange(8)[:, None], _SWIZZLE.to(t.device)].reshape(n, CHUNK_K).t()


def pack_stream(packed: PackedWeights, cfg: ModelConfig) -> torch.Tensor:
    """The weight stream: every chunk of ``chunk_schedule`` in its
    shared-memory image, concatenated (bf16, 1-D)."""
    for name in ("w0", "wskip"):
        if getattr(packed, name).shape[0] != POS_ROWS:
            raise ValueError(f"{name} must have {POS_ROWS} rows")
    return torch.cat([_swizzled(_matrix(packed, c)[c.k0:c.k0 + CHUNK_K])
                      for c in chunk_schedule(cfg)]).contiguous()


def unpack_stream(stream: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The matrices back from a stream: ``w0``, ``wt`` [7, 256, 256],
    ``wskip``, ``wc0`` and, for bmild, ``wbn``."""
    slabs: Dict[tuple, List[torch.Tensor]] = {}
    at = 0
    for c in chunk_schedule(cfg):
        size = CHUNK_K * c.n
        slabs.setdefault((c.name, c.layer), []).append(_unswizzled(stream[at:at + size], c.n))
        at += size
    if at != stream.numel():
        raise ValueError(f"stream of {stream.numel()} values, the schedule covers {at}")
    mats = {key: torch.cat(parts) for key, parts in slabs.items()}
    out = {name: m for (name, layer), m in mats.items() if layer is None}
    out["wt"] = torch.stack([mats[("wt", i)] for i in range(7)])
    return out


# id(PackedWeights.w0) -> (weak references to its matrices, variant, stream),
# dropped when w0 is freed
_STREAMS: Dict[int, tuple] = {}


def stream_for(packed: PackedWeights, cfg: ModelConfig) -> torch.Tensor:
    """``pack_stream`` of ``packed``, made once and cached beside it (keyed
    by its matrices' identity)."""
    mats = tuple(getattr(packed, n) for n in ("w0", "wt", "wskip", "wbn", "wc0"))
    key = id(packed.w0)
    hit = _STREAMS.get(key)
    if hit is not None and all(ref() is m for ref, m in zip(hit[0], mats)) and hit[1] == cfg.variant:
        return hit[2]
    stream = pack_stream(packed, cfg)
    refs = tuple((lambda: None) if m is None else weakref.ref(m) for m in mats)
    if hit is None:
        weakref.finalize(packed.w0, _STREAMS.pop, key, None)
    _STREAMS[key] = (refs, cfg.variant, stream)
    return stream


ARGTYPES = (
    [ctypes.c_void_p] * 3                 # rays_o, rays_d, z_vals (NULL: uniform)
    + [ctypes.c_longlong]                 # z row stride
    + [ctypes.c_int] * 2                  # n_rays, n_samples
    + [ctypes.c_float] * 2                # near, far - near
    + [ctypes.c_void_p] * 2               # weight stream, weights (PackedWeights order)
    + [ctypes.c_int] * 6 + [ctypes.c_float]   # net_args
    + [ctypes.c_int]                      # raw output form
    + [ctypes.c_void_p] * 2               # out, stream
)


def load() -> ctypes.CDLL:
    """The bound library, its signatures set once."""
    lib = _ext.load(LIBRARY)
    if lib.ray_wgmma_render.argtypes is None:
        lib.ray_wgmma_render.argtypes = ARGTYPES
        lib.ray_wgmma_render.restype = ctypes.c_int
        lib.ray_wgmma_smem_bytes.argtypes = [ctypes.c_int]
        lib.ray_wgmma_smem_bytes.restype = ctypes.c_longlong
        lib.ray_wgmma_stages.argtypes = [ctypes.c_int]
        lib.ray_wgmma_stages.restype = ctypes.c_int
        lib.l2_stream_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.l2_stream_probe.restype = ctypes.c_int
    return lib


def l2_probe(buf: torch.Tensor, reps: int, blocks: int) -> None:
    """Every one of ``blocks`` blocks streams ``buf`` (a multiple of 32 KB)
    ``reps`` times through a weight ring, as the producer does (a yardstick
    of the L2 rate the ray kernels' weight stream can reach)."""
    lib = load()
    err = lib.l2_stream_probe(_ext.ptr(buf), buf.numel() * buf.element_size(), reps, blocks,
                              _ext.stream_ptr(buf.device))
    _ext.check(lib, err, "l2_stream_probe launch")
