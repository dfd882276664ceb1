"""The weight streams of the Hopper MLP kernels (``csrc/ray_wgmma.cu``), and
the schedule of its composited modes.

K1 and K3 in their raw output forms and their composited modes, and the
per-sample forward K4 (K7 on quantized weights), run on
``csrc/ray_wgmma.cu``, built once per weight route
(``LIBRARIES``): bf16 weights (``PackedWeights``), int8 or int16 weights
dequantized in the kernel (``QuantizedPackedWeights``), and int8 compute
(``Int8PackedWeights``). A producer warpgroup copies the network into shared
memory one chunk at a time (``cp.async.bulk``, one contiguous copy a chunk)
and two consumer warpgroups multiply each chunk with ``wgmma``. This module
lays the weights out for that stream, once per set of weights (cached beside
them):

- a chunk is a slab of one matrix, all its ``N`` columns (256, or 128 for
  ``wc0``), in the order the consumers multiply them (``chunk_schedule``):
  ``w0``; the slabs of each trunk layer ``wt[0..6]``, with ``wskip`` after
  the layer at ``skip_pos``; those of ``wbn`` (bmild); those of ``wc0``. The
  producer walks it front to back;
- bf16 route: a 64-row slab ``W[k0:k0 + 64, :]`` in the exact shared-memory
  image that ``wgmma``'s B descriptor reads: the slab transposed to ``[N,
  64]`` (K-major: each output column's 64 weights contiguous, 128 bytes), in
  1,024-byte atoms of 8 columns, the 16-byte pieces of row ``r`` of an atom
  at position ``piece ^ r`` (the 128-byte swizzle);
- dequantize routes (int8, int16): the same chunks, each the bf16 chunk's
  image element for element in intN, followed by the matrix's ``N`` float32
  scales. An image row is one output column, so a scale covers one 128-byte
  row of the bf16 image the producer writes, ``bf16(f32(q) * s[col])``;
- int8 compute: ``w0``, ``wt`` and ``wskip`` are s8 operands. A 128-byte
  image row holds 128 of their K values, so a chunk is a 128-row slab
  (32 KB), copied as it is: a trunk layer is two chunks, and ``w0`` and
  ``wskip`` (64 rows) are padded with zero rows. The rows of each ``wt``
  matrix are permuted within every 16 (``K_PERM``): the s8 A fragment of a
  thread then holds its own accumulator columns in order (integer sums are
  exact, so the product is unchanged). ``wbn`` and ``wc0`` are dequantize
  chunks (int8).

``unpack_stream`` undoes the layout in plain PyTorch; the tests hold it
against the weights bit for bit. Biases, ``wsig``, ``wc1``, ``wdir`` and the
s8 matrices' scales are read from the weights as they are.

The per-sample kernel (``mlp_wgmma_forward``; ``forward_samples``) encodes
each sample's own direction, so its direction term is one more product: its
stream (``sample_chunk_schedule``, ``pack_sample_stream``,
``unpack_sample_stream``) is the ray kernels' followed by ``wdir`` as one
slab, its rows padded with zeros to 64; a dequantize chunk on the quantized
routes (int8 compute too: the route of the heads), made once per set of
weights (``sample_stream_for``).

The training backward K5 (``csrc/mlp_backward_wgmma.cu``) streams the
per-sample kernel's bf16 chunks, then the pre-transposed images of ``wc0``
and ``wt[6..0]`` for its input gradients ``dy @ W^T``, in the same layout
(``bwd_chunk_schedule``, ``bwd_stream``; ``unpack_bwd_stream`` undoes it).
So for the reference variant the per-sample stream is a prefix of K5's: a
train step gathers K5's stream once per network in the forward, and K4
reads its prefix.

The composited modes of K1 and K3 (``composited_grid``, ``lane_rays``,
``lane_steps``, ``composited_schedule``) give each consumer warpgroup a lane
of whole rays, a contiguous range of near-equal count, and walk its rows 64
at a time, in order, so that a ray's carried log-transmittance passes from
step to step within one consumer. ``composite_on_schedule_plain`` runs the
plain compositing along that schedule as the kernel does (32-row pieces of
each ray segment, carries from piece to piece and, through the lane's
state, from step to step); the tests hold it against the plain composited
versions of ``ops/render_kernel.py``.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.ops import _ext, quant
from nerf_tpu_torch.ops.mlp_kernel import HID, POS_ROWS, PackedWeights, net_args, skip_position

LIBRARY = "ray_wgmma"
# the build of csrc/ray_wgmma.cu for each weight route (0: bf16 weights)
LIBRARIES = {0: LIBRARY, quant.ROUTE_INT8: "ray_wgmma_q8", quant.ROUTE_INT16: "ray_wgmma_q16",
             quant.ROUTE_INT8_COMPUTE: "ray_wgmma_i8"}
CHUNK_K = 64          # weight rows per bf16 or dequantize chunk
S8_K = 128            # weight rows per s8 chunk
CH = HID // 2         # color layer width
_SWIZZLE = torch.arange(8)[:, None] ^ torch.arange(8)[None, :]   # [row, piece] -> piece ^ row
_BYTES = {"bf16": 2, "int8": 1, "int16": 2, "s8": 1}
_QDTYPE = {"int8": torch.int8, "int16": torch.int16}


def _k_perm() -> torch.Tensor:
    """Row ``C`` of a trunk matrix that K position ``P`` of the s8 stream
    holds: within each 32, ``P = 16 h + 4 q + 2 m + e`` holds ``C = 16 h + 8 m
    + 2 q + e`` (``csrc/ray_wgmma.cu`` quantize_rows: register ``r`` of a
    thread's A fragment, byte ``2 m + e``, holds its accumulator column ``8 (4
    kk + 2 h + m) + 2 q + e``)."""
    p = torch.arange(HID)
    kk, h, q, m, e = p // 32, p % 32 // 16, p % 16 // 4, p % 4 // 2, p % 2
    return 32 * kk + 16 * h + 8 * m + 2 * q + e


K_PERM = _k_perm()
K_UNPERM = torch.argsort(K_PERM)


class Chunk(NamedTuple):
    name: str             # matrix of PackedWeights
    layer: Optional[int]  # index into wt, else None
    k0: int               # first row of the slab
    n: int                # columns (the product's N)
    fmt: str = "bf16"     # "bf16", "int8" / "int16" (dequantized by the producer), "s8"
    k: int = CHUNK_K      # rows of the slab

    @property
    def nbytes(self) -> int:
        """Bytes in the stream: the image, and a dequantize chunk's scales."""
        scales = 4 * self.n if self.fmt in _QDTYPE else 0
        return self.k * self.n * _BYTES[self.fmt] + scales


def route_of(weights) -> int:
    """The weight route of ``PackedWeights`` (0) or quantized weights."""
    return quant.route_of(weights) if quant.is_quantized(weights) else 0


# the stream format of the heads' matrices (wbn, wc0, wdir) on each route
_HEAD = {0: "bf16", quant.ROUTE_INT8: "int8", quant.ROUTE_INT16: "int16",
         quant.ROUTE_INT8_COMPUTE: "int8"}


def chunk_schedule(cfg: ModelConfig, route: int = 0) -> List[Chunk]:
    """The chunks of one tile of the ray kernels on a weight route, in the
    order the consumers multiply them."""
    head = _HEAD[route]
    trunk, k = ("s8", S8_K) if route == quant.ROUTE_INT8_COMPUTE else (head, CHUNK_K)
    slabs = lambda name, layer=None, n=HID, fmt=head, k=CHUNK_K: [
        Chunk(name, layer, k0, n, fmt, k) for k0 in range(0, HID, k)]
    out = [Chunk("w0", None, 0, HID, trunk, k)]
    skip_pos = skip_position(cfg)
    for i in range(1, 8):
        out += slabs("wt", i - 1, fmt=trunk, k=k)
        if i == skip_pos:
            out.append(Chunk("wskip", None, 0, HID, trunk, k))
    if cfg.variant == "bmild":
        out += slabs("wbn")
    return out + slabs("wc0", n=CH)


def sample_chunk_schedule(cfg: ModelConfig, route: int = 0) -> List[Chunk]:
    """The chunks of one tile of the per-sample kernel: ``chunk_schedule``,
    then ``wdir`` as one slab, its rows padded with zeros to 64 (the
    direction term is a product of the per-sample encoding), in the heads'
    format."""
    return chunk_schedule(cfg, route) + [Chunk("wdir", None, 0, CH, _HEAD[route])]


def _matrix(weights, c: Chunk, pad=0) -> torch.Tensor:
    """The chunk's matrix as the stream carries it: bf16, intN, or the s8
    operand (``wt`` rows in ``K_PERM`` order, ``w0``/``wskip`` padded to 128
    rows); ``wdir`` with rows of ``pad`` up to 64."""
    w = getattr(weights, c.name if c.fmt == "bf16" else f"{c.name}_q")
    w = w if c.layer is None else w[c.layer]
    if c.name == "wdir":
        w = torch.cat([w, w.new_full((CHUNK_K - w.shape[0], w.shape[1]), pad)])
    if c.fmt == "s8":
        w = w[K_PERM.to(w.device)] if c.name == "wt" else torch.cat(
            [w, w.new_zeros(S8_K - w.shape[0], w.shape[1])])
    return w


def _scales(weights, c: Chunk) -> torch.Tensor:
    s = getattr(weights, f"{c.name}_s")
    return (s if c.layer is None else s[c.layer]).reshape(-1)


def _swizzled(slab: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` slab (K * element size = 128 bytes) -> its shared-memory
    image, flat: 16-byte pieces of K values, piece ``p`` of image row ``n``
    at position ``p ^ (n % 8)``."""
    per_piece = slab.shape[0] // 8
    t = slab.t().reshape(-1, 8, 8, per_piece)               # [atom, row, piece, values]
    return t[:, torch.arange(8)[:, None], _SWIZZLE.to(t.device)].reshape(-1)


def _unswizzled(flat: torch.Tensor, n: int, k: int = CHUNK_K) -> torch.Tensor:
    """The inverse of ``_swizzled``: the flat image -> ``[k, N]``."""
    t = flat.reshape(n // 8, 8, 8, k // 8)
    return t[:, torch.arange(8)[:, None], _SWIZZLE.to(t.device)].reshape(n, k).t()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _pack(weights, sched: List[Chunk]) -> torch.Tensor:
    route = route_of(weights)
    suffix = "_q" if route else ""
    for name in ("w0", "wskip"):
        if getattr(weights, name + suffix).shape[0] != POS_ROWS:
            raise ValueError(f"{name} must have {POS_ROWS} rows")
    if route == 0:
        return torch.cat([_swizzled(_matrix(weights, c)[c.k0:c.k0 + CHUNK_K])
                          for c in sched]).contiguous()
    parts = []
    for c in sched:
        parts.append(_bytes(_swizzled(_matrix(weights, c)[c.k0:c.k0 + c.k])))
        if c.fmt in _QDTYPE:
            parts.append(_bytes(_scales(weights, c).float()))
    return torch.cat(parts)


def pack_stream(weights, cfg: ModelConfig) -> torch.Tensor:
    """The ray kernels' weight stream of ``PackedWeights`` (bf16, 1-D) or of
    quantized weights (bytes, 1-D): every chunk of ``chunk_schedule`` in its
    shared-memory image, a dequantize chunk followed by its scales,
    concatenated."""
    return _pack(weights, chunk_schedule(cfg, route_of(weights)))


def pack_sample_stream(weights, cfg: ModelConfig) -> torch.Tensor:
    """The per-sample kernel's weight stream: ``pack_stream``'s layout over
    ``sample_chunk_schedule``."""
    return _pack(weights, sample_chunk_schedule(cfg, route_of(weights)))


def _unpack(stream: torch.Tensor, sched: List[Chunk], route: int) -> Dict[str, torch.Tensor]:
    slabs: Dict[tuple, List[torch.Tensor]] = {}
    scales: Dict[tuple, torch.Tensor] = {}
    at = 0
    for c in sched:
        size = c.k * c.n * _BYTES[c.fmt] if route else c.k * c.n
        img = stream[at:at + size]
        if c.fmt in _QDTYPE:
            img = img.view(_QDTYPE[c.fmt])
        elif c.fmt == "s8":
            img = img.view(torch.int8)
        slabs.setdefault((c.name, c.layer), []).append(_unswizzled(img, c.n, c.k))
        at += size
        if c.fmt in _QDTYPE:
            s = stream[at:at + 4 * c.n].view(torch.float32)
            if not torch.equal(scales.setdefault((c.name, c.layer), s), s):
                raise ValueError(f"the slabs of {c.name} carry different scales")
            at += 4 * c.n
    if at != stream.numel():
        raise ValueError(f"stream of {stream.numel()} values, the schedule covers {at}")
    mats = {key: torch.cat(parts) for key, parts in slabs.items()}
    if route == quant.ROUTE_INT8_COMPUTE:                  # undo K_PERM and the padding
        for key in [k for k in mats if k[0] == "wt"]:
            mats[key] = mats[key][K_UNPERM.to(stream.device)]
        for key in (("w0", None), ("wskip", None)):
            mats[key] = mats[key][:POS_ROWS]
    suffix = "_q" if route else ""
    out = {name + suffix: m for (name, layer), m in mats.items() if layer is None}
    out["wt" + suffix] = torch.stack([mats[("wt", i)] for i in range(7)])
    for (name, layer), s in scales.items():
        if layer is None:
            out[f"{name}_s"] = s[None]
    if ("wt", 0) in scales:
        out["wt_s"] = torch.stack([scales[("wt", i)][None] for i in range(7)])
    return out


def unpack_stream(stream: torch.Tensor, cfg: ModelConfig, route: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """The matrices back from a stream. bf16 route: ``w0``, ``wt`` [7, 256,
    256], ``wskip``, ``wc0`` and, for bmild, ``wbn``. Quantized routes: the
    same as ``*_q`` (the s8 rows back in their order, the padding dropped)
    and, for the dequantize chunks, ``*_s`` as the weights hold them (``[1,
    N]``; ``wt_s`` ``[7, 1, 256]``), each chunk's scales equal to its
    matrix's first chunk's."""
    return _unpack(stream, chunk_schedule(cfg, route), route)


def unpack_sample_stream(stream: torch.Tensor, cfg: ModelConfig, route: int = 0
                         ) -> Dict[str, torch.Tensor]:
    """The matrices back from a per-sample stream: ``unpack_stream``'s, and
    ``wdir`` (``wdir_q``, ``wdir_s``) with its padding rows (64)."""
    return _unpack(stream, sample_chunk_schedule(cfg, route), route)


# -- the stream of the training backward K5 (csrc/mlp_backward_wgmma.cu) -----

def bwd_chunk_schedule(cfg: ModelConfig) -> List[Chunk]:
    """The chunks of one tile of K5's row pass (reference variant, bf16), in
    the order its consumers multiply them: the per-sample forward's
    (``sample_chunk_schedule``: the ray kernels' chunks, then ``wdir``); then
    the pre-transposed
    images of the input-gradient products ``dy @ W^T``: ``wc0_t`` (``wc0^T``,
    two slabs of 256 columns) and ``wt_t`` of layers 6..0 (four slabs each).
    A ``*_t`` chunk is a slab of ``W^T``: rows ``k0 .. k0 + 63`` of it are
    columns ``k0 .. k0 + 63`` of ``W``."""
    if cfg.variant != "reference":
        raise ValueError("the backward kernel is written for the reference variant")
    out = sample_chunk_schedule(cfg)
    out += [Chunk("wc0_t", None, k0, HID) for k0 in (0, CHUNK_K)]
    for layer in range(6, -1, -1):
        out += [Chunk("wt_t", layer, k0, HID) for k0 in range(0, HID, CHUNK_K)]
    return out


def _bwd_matrix(weights, c: Chunk, pad=0) -> torch.Tensor:
    if c.name == "wt_t":
        return weights.wt[c.layer].t()
    if c.name == "wc0_t":
        return weights.wc0.t()
    return _matrix(weights, c, pad)


def pack_bwd_stream(weights, cfg: ModelConfig, pad=0) -> torch.Tensor:
    """The backward's weight stream of ``PackedWeights`` (1-D): every chunk of
    ``bwd_chunk_schedule`` in its shared-memory image, concatenated (``wdir``'s
    padding rows hold ``pad``)."""
    return torch.cat([_swizzled(_bwd_matrix(weights, c, pad)[c.k0:c.k0 + CHUNK_K])
                      for c in bwd_chunk_schedule(cfg)]).contiguous()


_BWD_SOURCES = ("w0", "wt", "wskip", "wc0", "wdir")
_BWD_INDEX: Dict[tuple, torch.Tensor] = {}


def bwd_stream(weights: PackedWeights, cfg: ModelConfig) -> torch.Tensor:
    """``pack_bwd_stream`` as one gather from the matrices: a train step packs
    new weights for every step, so this runs once per network and step (in
    the forward, whose K4 reads its prefix; the backward's two kernels take
    the rest). The gather's index is ``pack_bwd_stream`` of the matrices' own
    positions in their concatenation, the padding pointing at a zero
    appended to it; made once per device, skip layer and shapes."""
    shapes = tuple(tuple(getattr(weights, n).shape) for n in _BWD_SOURCES)
    key = (weights.w0.device, skip_position(cfg), shapes)
    if key not in _BWD_INDEX:
        at = [0]
        for s in shapes:
            at.append(at[-1] + math.prod(s))
        pos = SimpleNamespace(**{n: torch.arange(at[i], at[i + 1]).reshape(s)
                                 for i, (n, s) in enumerate(zip(_BWD_SOURCES, shapes))})
        _BWD_INDEX[key] = pack_bwd_stream(pos, cfg, pad=at[-1]).to(weights.w0.device)
    flat = torch.cat([getattr(weights, n).reshape(-1) for n in _BWD_SOURCES]
                     + [weights.w0.new_zeros(1)])
    return flat[_BWD_INDEX[key]]


def unpack_bwd_stream(stream: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The matrices back from a backward stream: those of ``unpack_stream``,
    ``wdir`` with its padding rows (64), ``wc0_t`` [128, 256] and ``wt_t`` [7,
    256, 256] (layer ``i`` at index ``i``)."""
    slabs: Dict[tuple, List[torch.Tensor]] = {}
    at = 0
    for c in bwd_chunk_schedule(cfg):
        size = CHUNK_K * c.n
        slabs.setdefault((c.name, c.layer), []).append(_unswizzled(stream[at:at + size], c.n))
        at += size
    if at != stream.numel():
        raise ValueError(f"stream of {stream.numel()} values, the schedule covers {at}")
    mats = {key: torch.cat(parts) for key, parts in slabs.items()}
    out = {name: m for (name, layer), m in mats.items() if layer is None}
    for name in ("wt", "wt_t"):
        out[name] = torch.stack([mats[(name, i)] for i in range(7)])
    return out


# (id(first matrix), per-sample) -> (weak references to the streamed
# tensors, variant, stream), dropped when that matrix is freed
_STREAMS: Dict[tuple, tuple] = {}
_STREAMED = ("w0", "wt", "wskip", "wbn", "wc0")


def _cached(weights, cfg: ModelConfig, per_sample: bool) -> torch.Tensor:
    names = list(_STREAMED) + (["wdir"] if per_sample else [])
    if quant.is_quantized(weights):
        names = [f"{n}_{x}" for n in names for x in "qs"]
    mats = tuple(getattr(weights, n) for n in names)
    key = (id(mats[0]), per_sample)
    hit = _STREAMS.get(key)
    if (hit is not None and len(hit[0]) == len(mats)
            and all(ref() is m for ref, m in zip(hit[0], mats)) and hit[1] == cfg.variant):
        return hit[2]
    stream = (pack_sample_stream if per_sample else pack_stream)(weights, cfg)
    refs = tuple((lambda: None) if m is None else weakref.ref(m) for m in mats)
    if hit is None:
        weakref.finalize(mats[0], _STREAMS.pop, key, None)
    _STREAMS[key] = (refs, cfg.variant, stream)
    return stream


def stream_for(weights, cfg: ModelConfig) -> torch.Tensor:
    """``pack_stream`` of ``weights``, made once and cached beside them
    (keyed by the identity of the tensors it is made from)."""
    return _cached(weights, cfg, False)


def sample_stream_for(weights, cfg: ModelConfig) -> torch.Tensor:
    """The per-sample stream of ``weights`` (``pack_sample_stream``), made
    once and cached beside them as ``stream_for`` does."""
    return _cached(weights, cfg, True)


ARGTYPES = (
    [ctypes.c_void_p] * 3                 # rays_o, rays_d, z_vals (NULL: uniform)
    + [ctypes.c_longlong]                 # z row stride
    + [ctypes.c_int] * 2                  # n_rays, n_samples
    + [ctypes.c_float] * 2                # near, far - near
    + [ctypes.c_void_p] * 3               # weight stream, weights (PackedWeights order), scales
    + [ctypes.c_int] * 6 + [ctypes.c_float]   # net_args
    + [ctypes.c_int] * 2                  # raw output form, composited
    + [ctypes.c_float] * 3                # uniform step dz, sentinel, eps
    + [ctypes.c_void_p] * 3               # out, w (NULL: none), stream
)


SAMPLE_ARGTYPES = (
    [ctypes.c_void_p] * 2                 # positions, directions
    + [ctypes.c_longlong]                 # N
    + [ctypes.c_void_p] * 3               # weight stream, weights (PackedWeights order), scales
    + [ctypes.c_int] * 6 + [ctypes.c_float]   # net_args
    + [ctypes.c_void_p] * 2               # out, stream
)


def load(library: str = LIBRARY) -> ctypes.CDLL:
    """A bound build of ``csrc/ray_wgmma.cu``, its signatures set once."""
    lib = _ext.load(library)
    if lib.ray_wgmma_render.argtypes is None:
        lib.ray_wgmma_render.argtypes = ARGTYPES
        lib.ray_wgmma_render.restype = ctypes.c_int
        lib.mlp_wgmma_forward.argtypes = SAMPLE_ARGTYPES
        lib.mlp_wgmma_forward.restype = ctypes.c_int
        lib.mlp_wgmma_smem_bytes.restype = ctypes.c_longlong
        lib.mlp_wgmma_stages.restype = ctypes.c_int
        lib.mlp_wgmma_stream_chunks.argtypes = [ctypes.c_int]
        lib.mlp_wgmma_stream_chunks.restype = ctypes.c_int
        lib.ray_wgmma_smem_bytes.argtypes = [ctypes.c_int]
        lib.ray_wgmma_smem_bytes.restype = ctypes.c_longlong
        lib.ray_wgmma_stages.argtypes = [ctypes.c_int]
        lib.ray_wgmma_stages.restype = ctypes.c_int
        lib.ray_wgmma_landing_slots.restype = ctypes.c_int
        lib.ray_wgmma_composited_lanes.argtypes = [ctypes.c_int]
        lib.ray_wgmma_composited_lanes.restype = ctypes.c_int
        lib.ray_wgmma_route.restype = ctypes.c_int
        lib.ray_wgmma_registers.argtypes = [ctypes.c_int]
        lib.ray_wgmma_registers.restype = ctypes.c_int
        lib.l2_stream_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.l2_stream_probe.restype = ctypes.c_int
    return lib


def sample_stream_bytes(cfg: ModelConfig, route: int = 0) -> int:
    """Bytes of the per-sample stream on a weight route."""
    return sum(c.nbytes for c in sample_chunk_schedule(cfg, route))


def forward_samples(library: str, weights, positions: torch.Tensor, directions: torch.Tensor,
                    cfg: ModelConfig, stream: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the per-sample kernel of ``library`` (the build of the
    weights' route) on float32 ``[N, 3]`` positions and directions into
    float32 ``out [N, 4]``, all contiguous on one card. ``stream``: the
    weights' per-sample stream, or a stream that begins with it (K5's, whose
    prefix it is for the reference variant). The caller has checked the
    weights (``check_packed``, ``quant.check_quantized``)."""
    route = route_of(weights)
    if LIBRARIES.get(route) != library:
        raise ValueError(f"{library} is not the Hopper build for weight route {route}")
    dev, n = positions.device, positions.shape[0]
    need = sample_stream_bytes(cfg, route)
    if (stream.device != dev or stream.dim() != 1 or not stream.is_contiguous()
            or stream.numel() * stream.element_size() < need):
        raise ValueError(f"the weight stream must be a contiguous 1-D tensor of at least "
                         f"{need} bytes on {dev}")
    if route:
        weights_ptrs, scales = quant.weight_pointers(weights)
    else:
        weights_ptrs, scales = _ext.pointer_array(weights), None
    lib = load(library)
    err = lib.mlp_wgmma_forward(_ext.ptr(positions), _ext.ptr(directions), n, _ext.ptr(stream),
                                weights_ptrs, scales, *net_args(cfg), _ext.ptr(out),
                                _ext.stream_ptr(dev))
    _ext.check(lib, err, f"mlp_wgmma_forward launch ({library})")


def l2_probe(buf: torch.Tensor, reps: int, blocks: int) -> None:
    """Every one of ``blocks`` blocks streams ``buf`` (a multiple of 32 KB)
    ``reps`` times through a weight ring, as the producer does (a yardstick
    of the L2 rate the ray kernels' weight stream can reach)."""
    lib = load()
    err = lib.l2_stream_probe(_ext.ptr(buf), buf.numel() * buf.element_size(), reps, blocks,
                              _ext.stream_ptr(buf.device))
    _ext.check(lib, err, "l2_stream_probe launch")


# -- the composited modes' schedule (csrc/ray_wgmma.cu lane_rows, block_steps) --

STEP_ROWS = 64        # rows a consumer warpgroup takes a step


def composited_grid(n_rays: int, sms: int) -> int:
    """Blocks of a composited launch: one an SM, but no more than half the
    rays, rounded up (two consumer lanes a block)."""
    return max(1, min(sms, (n_rays + 1) // 2))


def lane_rays(n_rays: int, lanes: int) -> List[Tuple[int, int]]:
    """Rays ``[begin, end)`` of each consumer lane: lane ``L`` (consumer
    ``L % 2`` of block ``L // 2``) takes ``L R // lanes .. (L + 1) R //
    lanes - 1``, so the counts differ by at most one."""
    return [(lane * n_rays // lanes, (lane + 1) * n_rays // lanes) for lane in range(lanes)]


def lane_steps(rays: Tuple[int, int], n_samples: int) -> int:
    """Steps of 64 rows a lane's rays take."""
    return -(-(rays[1] - rays[0]) * n_samples // STEP_ROWS)


def composited_schedule(n_rays: int, n_samples: int, grid: int
                        ) -> List[List[Tuple[Tuple[int, int], Tuple[int, int]]]]:
    """Per block, per step: the flat rows ``[n0, stop)`` of each of its two
    consumers (empty past its lane's rows). A block runs the larger of its
    lanes' step counts, the producer streaming the network once a step."""
    lanes = lane_rays(n_rays, 2 * grid)
    out = []
    for b in range(grid):
        pair = lanes[2 * b:2 * b + 2]
        steps = max(lane_steps(r, n_samples) for r in pair)
        block = []
        for k in range(steps):
            rows = []
            for begin, end in pair:
                n0, n_end = begin * n_samples + k * STEP_ROWS, end * n_samples
                rows.append((n0, min(n0 + STEP_ROWS, n_end)) if n0 < n_end else (n0, n0))
            block.append(tuple(rows))
        out.append(block)
    return out


def composite_on_schedule_plain(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                                grid: int, sentinel: float = 1e10, eps: float = 1e-10,
                                dz: Optional[float] = None):
    """The composited modes' volume rendering of ``raw [R, 4S]`` in the
    kernel's order: each consumer's rows step by step
    (``composited_schedule``), each step's ray segments in 32-row pieces, the
    exclusive sum of ``log(max(1 - alpha, eps))`` within a piece continued
    from the carry, the carry and the five sums kept in the lane's state
    where a segment ends mid-ray. ``dz``: K1's constant step. Returns
    ``(out [R, 8], w [R, S])`` in float32."""
    R, S = z_vals.shape
    raw = raw.float().reshape(R, S, 4)
    z = z_vals.float()
    dnorm = torch.linalg.norm(rays_d.float(), dim=-1)
    out = torch.zeros(R, 8)
    w = torch.zeros(R, S)
    for block in composited_schedule(R, S, grid):
        state = [None, None]                       # per consumer: (carry, sums [5])
        for rows in block:
            for c, (n0, stop) in enumerate(rows):
                if stop == n0:                     # past this lane's rows
                    continue
                for r in range(n0 // S, (stop - 1) // S + 1):
                    a, b = max(n0, r * S), min(stop, (r + 1) * S)
                    carry, sums = state[c] if a > r * S else (torch.zeros(()), torch.zeros(5))
                    for c0 in range(a, b, 32):
                        s = torch.arange(c0, min(c0 + 32, b)) - r * S
                        sigma, rgb = raw[r, s, 0], raw[r, s, 1:]
                        zs = z[r, s]
                        nxt = z[r, torch.clamp(s + 1, max=S - 1)]
                        step = nxt - zs if dz is None else torch.full_like(zs, dz)
                        dist = torch.where(s == S - 1, torch.full_like(zs, sentinel), step)
                        alpha = 1.0 - torch.exp(-torch.relu(sigma) * (dist * dnorm[r]))
                        incl = torch.cumsum(torch.log(torch.clamp(1.0 - alpha, min=eps)), 0)
                        excl = torch.cat([incl.new_zeros(1), incl[:-1]])
                        wv = alpha * torch.exp(carry + excl)
                        w[r, s] = wv
                        sums = sums + torch.cat([(wv[:, None] * rgb).sum(0),
                                                 (wv * zs).sum()[None], wv.sum()[None]])
                        carry = carry + incl[-1]
                    if b == (r + 1) * S:
                        out[r, :5] = sums
                    else:
                        state[c] = (carry, sums)
    return out, w
