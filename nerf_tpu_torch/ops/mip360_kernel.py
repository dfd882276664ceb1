"""Mip-NeRF 360's networks on the card: their weights laid out for the
kernels, and the NeRF pass (``csrc/mip360_wgmma.cu``) with its plain
version.

The variant (``models/mip360.py``) has two networks. The proposal network
runs on the ray kernels' body (``csrc/ray_wgmma.cu``,
``ray_z_prop360_wgmma_kernel``; its wrapper is
``render_kernel.fused_render_prop_mip360``) from ``PropWeights``: ``w0``
padded to 512 rows (the 504-feature encoding and zeros), the three hidden
layers, the density head, and the resident parameters that body reads,
with the basis ``[3][21]`` in the slot of the color layer's bias it does
not have; its stream is ``w0``'s eight 64-row slabs, then each hidden
layer's four, in ``ops/ray_wgmma.py``'s slab images.

The NeRF network (8 x 1,024) runs as a GEMM a layer (``nerf_mip360_raw``,
``NerfWeights``). Its activations live in device memory as bf16 images of
128-row tiles and 64-feature K steps (16 KB each, the 128-byte swizzle), the
layout every kernel of the pass writes and reads by bulk copies; a matrix
``[K, N]`` is streamed as the images of its 64-row slabs of 256 columns
(128 for the color layer), column tile by column tile. A chunk of rays:
``mip360_encode`` (the encoding, K 512), eight trunk layers
(``mip360_dense``; the skip layer reads K 1,024 of ``h`` then 512 of the
encoding), the bottleneck with the density head (``mip360_bottleneck``),
the direction term once a ray (``mip360_dir``), the color layer and rgb
(``mip360_color``). Each wrapper call counts its launches in ``launches``
by kernel and records the span ``kernel.nerf``; ``nerf_mip360_plain`` is its
arithmetic in plain PyTorch, which CPU tensors take.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.encoding import N_BASIS, encode_intervals_360, mip_dir_encoding
from nerf_tpu_torch.models.encoding import basis as basis_of
from nerf_tpu_torch.models.mip import softplus
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.ops.ray_wgmma import _swizzled
from nerf_tpu_torch.utils.device import disable_tf32
from nerf_tpu_torch.utils.monitor import span

LIBRARY = "mip360_wgmma"
TILE = 128          # rows a tile of the activations' images
CHUNK_K = 64        # features a K step
ENC_K = 512         # the encoding's padded width
PROP_HID = 256      # the proposal network's width (the ray kernels' body)
TRUNK_COLS = 256    # columns a tile of the trunk's products
COLOR_COLS = 128    # the color layer's width
PARAM_FLOATS = 128  # the basis's slot in the proposal body's resident parameters

# Launches of each CUDA kernel of the NeRF pass (not of the plain version)
launches = {"encode": 0, "dense": 0, "bottleneck": 0, "dir": 0, "color": 0}


def slab_images(w: torch.Tensor, cols: int) -> torch.Tensor:
    """``w [K, N]`` (``K`` a multiple of 64, ``N`` of ``cols``) as its 64-row
    slabs' images, column tile by column tile, then K step by K step, flat."""
    K, N = w.shape
    return torch.cat([_swizzled(w[k0:k0 + CHUNK_K, c0:c0 + cols].contiguous())
                      for c0 in range(0, N, cols) for k0 in range(0, K, CHUNK_K)])


def _padded_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([w, w.new_zeros(rows - w.shape[0], w.shape[1])])


def enc_order(cfg: ModelConfig) -> torch.Tensor:
    """The encoding's feature at each of the kernels' 512 positions: pair ``q
    = k n_deg + l`` (positions ``2q``, ``2q + 1``) holds direction ``k`` of the
    basis at degree ``l``, its sine, then its shifted sine (``csrc/mip360.cuh``);
    the published order (``encode_intervals_360``) puts the sines of every
    degree and direction (degree-major) before the shifted sines. Positions
    past the encoding map to themselves (the padding's zero rows)."""
    nb, n_deg = N_BASIS, cfg.ipe_max_deg - cfg.ipe_min_deg
    half = nb * n_deg
    q = torch.arange(half)
    k, l = q // n_deg, q % n_deg
    sines = l * nb + k
    pairs = torch.stack([sines, sines + half], dim=1).reshape(-1)
    return torch.cat([pairs, torch.arange(2 * half, ENC_K)])


class PropWeights(NamedTuple):
    """The proposal network as ``ray_z_prop360_wgmma_kernel`` takes it, in
    the order of its 14 weight pointers (``PackedWeights``'): the matrices
    in bf16, the rest in float32."""

    w0: torch.Tensor        # [512, 256] bf16, the published feature order
    b0: torch.Tensor        # [256]
    wt: torch.Tensor        # [3, 256, 256] bf16
    bt: torch.Tensor        # [7, 256], zero past the three hidden layers
    wskip: torch.Tensor     # unused: [1] bf16
    wsig: torch.Tensor      # [256] bf16
    bsig: torch.Tensor      # [1]
    wbn: torch.Tensor       # unused: [1] bf16
    bbn: torch.Tensor       # unused: [1]
    wc0: torch.Tensor       # unused: [1] bf16
    basis: torch.Tensor     # [128]: the basis [3][n] row-major, zeros after (bc0's slot)
    wdir: torch.Tensor      # unused: [1] bf16
    wc1: torch.Tensor       # [384] bf16 zeros
    bc1: torch.Tensor       # [3] zeros
    stream: torch.Tensor    # bf16, 1-D: w0's eight slabs (rows in enc_order), then wt[0..2]'s
                            # four each


def prop_fits(cfg: ModelConfig) -> bool:
    """Whether the proposal entry computes ``cfg``'s proposal network: the
    mip360 variant at 4 x 256, an encoding from degree 0 of at most 512
    features."""
    return (cfg.variant == "mip360" and cfg.prop_hidden_dim == PROP_HID and cfg.prop_layers == 4
            and cfg.pos_dim <= ENC_K and cfg.ipe_min_deg == 0)


def nerf_fits(cfg: ModelConfig) -> bool:
    """Whether the NeRF pass computes ``cfg``'s NeRF network: the mip360
    variant, a trunk a multiple of 256 wide, bottleneck 256, color 128, an
    encoding from degree 0 of at most 512 features, a direction encoding of
    at most 64."""
    return (cfg.variant == "mip360" and cfg.hidden_dim % TRUNK_COLS == 0
            and cfg.bottleneck_dim == TRUNK_COLS and cfg.color_hidden_dim == COLOR_COLS
            and cfg.pos_dim <= ENC_K and cfg.ipe_min_deg == 0 and cfg.dir_dim <= 64)


def pack_prop(params, cfg: ModelConfig) -> PropWeights:
    """The proposal network's params (``{'trunk', 'density'}``, float32) laid
    out for its kernel, matrices rounded to bf16. Other widths than the
    kernel's (``prop_fits``) are packed for the plain version, without a
    stream."""
    if cfg.pos_dim > ENC_K:
        raise ValueError(f"the encoding is padded to {ENC_K} features")
    dev = params["density"]["w"].device
    bf = torch.bfloat16
    trunk = params["trunk"]
    w0 = _padded_rows(trunk[0]["w"], ENC_K).to(bf).contiguous()
    wt = torch.stack([layer["w"] for layer in trunk[1:]]).to(bf).contiguous()
    width = trunk[0]["w"].shape[1]
    bt = torch.zeros(max(7, len(trunk) - 1), width, device=dev)
    bt[:len(trunk) - 1] = torch.stack([layer["b"] for layer in trunk[1:]])
    b = basis_of(dev).reshape(-1)
    basis = torch.cat([b, b.new_zeros(PARAM_FLOATS - b.numel())])
    one = torch.zeros(1, dtype=bf, device=dev)
    stream = (torch.cat([slab_images(w0[enc_order(cfg).to(dev)], PROP_HID)]
                        + [slab_images(w, PROP_HID) for w in wt])
              if prop_fits(cfg) else w0.new_zeros(0))
    return PropWeights(w0, trunk[0]["b"].float().contiguous(), wt, bt.contiguous(), one,
                       params["density"]["w"][:, 0].to(bf).contiguous(),
                       params["density"]["b"].float().contiguous(), one,
                       torch.zeros(1, device=dev), one, basis.contiguous(), one,
                       torch.zeros(COLOR_COLS * 3, dtype=bf, device=dev),
                       torch.zeros(3, device=dev), stream.contiguous())


class NerfWeights(NamedTuple):
    """The NeRF network as the NeRF pass takes it: each matrix in bf16 (rows
    padded: the encoding's to 512) and its slab images, biases and the
    small heads in float32."""

    w: List[torch.Tensor]         # trunk [K, 1024] bf16: 512, 1,024 or 1,536 (skip) rows, the
                                  # published feature order
    b: List[torch.Tensor]         # [1024]
    wbn: torch.Tensor             # [1024, 256] bf16
    bbn: torch.Tensor             # [256]
    wsig: torch.Tensor            # [1024] bf16
    bsig: torch.Tensor            # [1]
    wc0: torch.Tensor             # [256, 128] bf16: the bottleneck's rows of color0
    wdir: torch.Tensor            # [27, 128] float32 values of the bf16 direction rows
    bc0: torch.Tensor             # [128]
    wc1: torch.Tensor             # [128, 3] float32 values of the bf16 weights
    bc1: torch.Tensor             # [3]
    streams: List[torch.Tensor]   # each trunk matrix's slab images, 256 columns a tile, the
                                  # encoding's rows in enc_order (none
                                  # for widths the pass does not compute: nerf_fits)
    bn_stream: torch.Tensor       # wbn's
    sig_stream: torch.Tensor      # wsig in column 0 of 8, 1 KB a K step
    c0_stream: torch.Tensor       # wc0's, 128 columns


def pack_nerf(params, cfg: ModelConfig) -> NerfWeights:
    """The NeRF network's params laid out for the NeRF pass, matrices
    rounded to bf16. Other widths than the pass's (``nerf_fits``) are packed
    for the plain version, without streams."""
    h = cfg.hidden_dim
    if cfg.pos_dim > ENC_K:
        raise ValueError(f"the encoding is padded to {ENC_K} features")
    bf = torch.bfloat16
    wide = cfg.skip_layer + 1
    ws = []
    for i, layer in enumerate(params["trunk"]):
        w = layer["w"]
        if i == 0:
            w = _padded_rows(w, ENC_K)
        elif i == wide:
            w = torch.cat([w[:h], _padded_rows(w[h:], ENC_K)])
        ws.append(w.to(bf).contiguous())
    wsig = params["density"]["w"][:, 0].to(bf).contiguous()
    sig8 = torch.zeros(h, 8, dtype=bf, device=wsig.device)
    sig8[:, 0] = wsig
    c0 = params["color0"]["w"]
    nb = cfg.bottleneck_dim
    wbn = params["bottleneck"]["w"].to(bf).contiguous()
    wc0 = c0[:nb].to(bf).contiguous()
    fits = nerf_fits(cfg)
    empty = wbn.new_zeros(0)
    if fits:
        # the rows that multiply the encoding in the kernels' order
        order = enc_order(cfg).to(wbn.device)
        kernel_ws = [ws[0][order]] + ws[1:wide] + [
            torch.cat([ws[wide][:h], ws[wide][h:][order]])] + ws[wide + 1:]
    return NerfWeights(
        ws, [layer["b"].float().contiguous() for layer in params["trunk"]], wbn,
        params["bottleneck"]["b"].float().contiguous(), wsig,
        params["density"]["b"].float().contiguous(), wc0,
        c0[nb:].to(bf).float().contiguous(), params["color0"]["b"].float().contiguous(),
        params["color1"]["w"].to(bf).float().contiguous(),
        params["color1"]["b"].float().contiguous(),
        [slab_images(w, TRUNK_COLS).contiguous() for w in kernel_ws] if fits else [],
        slab_images(wbn, TRUNK_COLS).contiguous() if fits else empty,
        slab_images(sig8, 8).contiguous() if fits else empty,
        slab_images(wc0, COLOR_COLS).contiguous() if fits else empty)


def pack_mip360(params, cfg: ModelConfig) -> dict:
    """``{'coarse': PropWeights, 'fine': NerfWeights}`` of the variant's
    params (``{'coarse': proposal, 'fine': NeRF}``)."""
    return {"coarse": pack_prop(params["coarse"], cfg), "fine": pack_nerf(params["fine"], cfg)}


# -- the NeRF pass ----------------------------------------------------------------

def nerf_mip360_plain(packed: NerfWeights, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      radius: float, edges: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch version of the NeRF pass at the metric ``edges [R, S +
    1]``: ``raw [R, 4S]``, per interval ``(density, r, g, b)`` in float32.
    The encoding in float32 (``encode_intervals_360``), each product on bf16
    operands summed in float32, the bias (and the direction term) added
    before the rounding to bf16, as the kernels do."""
    disable_tf32()
    o, d = rays_o.float(), rays_d.float()
    R, S = edges.shape[0], edges.shape[1] - 1
    bf = torch.bfloat16

    def mm(a, w):
        return a.to(bf).float() @ w.float()

    r = torch.full((R,), radius, dtype=torch.float32, device=o.device)
    enc = encode_intervals_360(o, d, r, edges.float(), cfg.ipe_min_deg,
                               cfg.ipe_max_deg).reshape(R * S, -1)
    enc = torch.nn.functional.pad(enc, (0, ENC_K - enc.shape[1])).to(bf)
    h = torch.relu(mm(enc, packed.w[0]) + packed.b[0]).to(bf)
    for i in range(1, len(packed.w)):
        x = torch.cat([h, enc], dim=-1) if i == cfg.skip_layer + 1 else h
        h = torch.relu(mm(x, packed.w[i]) + packed.b[i]).to(bf)
    density = softplus((mm(h, packed.wsig[:, None])[:, 0] + packed.bsig) + cfg.density_bias)
    bn = (mm(h, packed.wbn) + packed.bbn).to(bf)
    dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    denc = mip_dir_encoding(dn, cfg.dir_freqs).to(bf).float()
    cdir = denc @ packed.wdir
    c = torch.relu((mm(bn, packed.wc0) + packed.bc0) + cdir.repeat_interleave(S, dim=0)).to(bf)
    rgb = torch.sigmoid(c.float() @ packed.wc1 + packed.bc1)
    rgb = rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding
    return torch.cat([density[:, None], rgb], dim=-1).reshape(R, 4 * S)


def load() -> ctypes.CDLL:
    """The bound ``csrc/mip360_wgmma.cu``, its signatures set once."""
    lib = _ext.load(LIBRARY)
    if lib.mip360_dense.argtypes is None:
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.mip360_encode.argtypes = [P, P, P, L, I, I, F, P, I, I, P, L, P]
        lib.mip360_dense.argtypes = [P, I, P, I, P, P, I, I, P, P]
        lib.mip360_bottleneck.argtypes = [P, I, P, P, P, P, F, I, L, P, P, P]
        lib.mip360_dir.argtypes = [P, P, I, I, P, P]
        lib.mip360_color.argtypes = [P, P, P, P, I, P, P, F, F, I, L, P, P]
        for fn in (lib.mip360_encode, lib.mip360_dense, lib.mip360_bottleneck, lib.mip360_dir,
                   lib.mip360_color, lib.mip360_tile_rows, lib.mip360_enc_chunks,
                   lib.mip360_stages):
            fn.restype = ctypes.c_int
        lib.mip360_dense_smem.argtypes = [I]
        lib.mip360_dense_smem.restype = L
    return lib


def _launch(packed: NerfWeights, rays_o, rays_d, radius: float, edges, cfg: ModelConfig
            ) -> torch.Tensor:
    """The NeRF pass's kernels on CUDA tensors: ``raw [R, 4S]`` float32."""
    dev = rays_o.device
    R, S = edges.shape[0], edges.shape[1] - 1
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.shape != (R, 3) or t.device != dev:
            raise ValueError(f"{name} must be float32 [R, 3] on {dev}")
    if edges.dtype != torch.float32 or edges.device != dev or edges.stride(1) != 1 or S < 1:
        raise ValueError("edges must be float32 [R, S + 1] with unit stride along the ray")
    if not nerf_fits(cfg) or len(packed.streams) != cfg.n_layers:
        raise ValueError("the NeRF pass computes the mip360 variant: a trunk a multiple of 256 "
                         "wide, bottleneck 256, color 128, the encoding from degree 0")
    if any(w.device != dev for w in packed.streams) or packed.c0_stream.device != dev:
        raise ValueError(f"the packed weights must be on {dev}")
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    rows = R * S
    m_tiles = -(-rows // TILE)
    raw = torch.empty(rows, 4, dtype=torch.float32, device=dev)
    if rows == 0:
        return raw.reshape(R, 4 * S)
    lib = load()
    stream = _ext.stream_ptr(dev)
    h = cfg.hidden_dim
    enc = torch.empty(m_tiles * TILE * ENC_K, dtype=torch.bfloat16, device=dev)
    b = basis_of("cpu").reshape(-1)
    host_basis = (ctypes.c_float * b.numel())(*b.tolist())
    n_deg = cfg.ipe_max_deg - cfg.ipe_min_deg
    _ext.check(lib, lib.mip360_encode(
        _ext.ptr(rays_o), _ext.ptr(rays_d), _ext.ptr(edges), edges.stride(0), R, S,
        float(radius), host_basis, b.numel() // 3, n_deg, _ext.ptr(enc), m_tiles * TILE, stream),
        "mip360_encode launch")
    ran = _ext.ran()
    launches["encode"] += ran
    k_enc, k_h = ENC_K // CHUNK_K, h // CHUNK_K
    bufs = [torch.empty(m_tiles * TILE * h, dtype=torch.bfloat16, device=dev) for _ in range(2)]
    src = enc
    for i, (w, bias) in enumerate(zip(packed.streams, packed.b)):
        dst = bufs[i % 2]
        kc1, a2, kc2 = (k_enc, None, 0) if i == 0 else (
            (k_h, enc, k_enc) if i == cfg.skip_layer + 1 else (k_h, None, 0))
        _ext.check(lib, lib.mip360_dense(
            _ext.ptr(src), kc1, None if a2 is None else _ext.ptr(a2), kc2, _ext.ptr(w),
            _ext.ptr(bias), h // TRUNK_COLS, m_tiles, _ext.ptr(dst), stream), "mip360_dense launch")
        launches["dense"] += ran
        src = dst
    bn = torch.empty(m_tiles * TILE * TRUNK_COLS, dtype=torch.bfloat16, device=dev)
    _ext.check(lib, lib.mip360_bottleneck(
        _ext.ptr(src), k_h, _ext.ptr(packed.bn_stream), _ext.ptr(packed.bbn),
        _ext.ptr(packed.sig_stream), _ext.ptr(packed.bsig), float(cfg.density_bias), m_tiles,
        rows, _ext.ptr(bn), _ext.ptr(raw), stream), "mip360_bottleneck launch")
    launches["bottleneck"] += ran
    cdir = torch.empty(R, COLOR_COLS, dtype=torch.float32, device=dev)
    _ext.check(lib, lib.mip360_dir(_ext.ptr(rays_d), _ext.ptr(packed.wdir), R, cfg.dir_freqs,
                                   _ext.ptr(cdir), stream), "mip360_dir launch")
    launches["dir"] += ran
    _ext.check(lib, lib.mip360_color(
        _ext.ptr(bn), _ext.ptr(packed.c0_stream), _ext.ptr(packed.bc0), _ext.ptr(cdir), S,
        _ext.ptr(packed.wc1), _ext.ptr(packed.bc1), float(1 + 2 * cfg.rgb_padding),
        float(cfg.rgb_padding), m_tiles, rows, _ext.ptr(raw), stream), "mip360_color launch")
    launches["color"] += ran
    return raw.reshape(R, 4 * S)


def nerf_mip360_raw(packed: NerfWeights, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    radius: float, edges: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The NeRF network at the intervals between the metric ``edges [R, S +
    1]`` of every ray's cone, base radius ``radius``: ``raw [R, 4S]``, per
    interval ``(density, r, g, b)`` in float32. CPU tensors take the plain
    version; CUDA tensors the kernels, or raise."""
    from nerf_tpu_torch.ops import render_kernel   # it imports this module

    with span("kernel.nerf"):
        if rays_o.device.type == "cpu":
            return nerf_mip360_plain(packed, rays_o, rays_d, radius, edges, cfg)
        out = _launch(packed, rays_o, rays_d, radius, edges, cfg)
        render_kernel.launches["nerf_mip360"] += _ext.ran()
        return out
