"""Alpha compositing kernels: over the ray kernel's interleaved output (K2)
and over planar per-sample fields (K6).

Counterparts of ``nerf_tpu/ops/composite_kernel.py``:

- ``fused_volume_render_interleaved`` (the Pallas kernel
  ``_composite_kernel_interleaved``) takes ``raw [N, 4S]``, per sample
  ``(sigma, r, g, b)``, in float32 or bfloat16 (the ray kernels'
  ``raw_dtype``), and computes in float32 either way;
- ``fused_volume_render`` (``_composite_kernel``, ``_pallas_composite``) is
  the drop-in for ``volume_render``: ``sigma [N, S]`` and ``rgb`` as
  ``[N, S, 3]`` or a tuple of three ``[N, S]`` planes. Its gradient, as in
  the JAX package, is a recompute through ``volume_render`` under autograd.

Both take depths ``z [N, S]`` and ``rays_d [N, 3]`` and compute ``dists``
(adjacent differences, sentinel last, times ``||d||``),
``alpha = 1 - exp(-relu(sigma) * dist)``, the exclusive transmittance
``exp(cumsum(log(max(1 - alpha, eps))))`` and the weights, then rgb, depth
and accumulated opacity. The white background is added here, in the wrappers.

The transmittance follows the TPU kernels, ``log(max(1 - alpha, eps))``,
not ``volume_render``'s ``cumprod(1 - alpha + eps)``: the two differ by at
most ``eps`` per factor (1e-10), far below float32 resolution at any
transmittance that contributes.

On CUDA tensors the wrappers launch ``csrc/composite.cu`` and count the
launch (``launches`` for K2, of which ``bf16_launches`` read a bfloat16
``raw`` and ``weightless_launches`` wrote no weights; ``planar_launches``
for K6); on CPU tensors both run ``fused_volume_render_interleaved_plain``
(the planar wrapper stacks its input for it). Under a profiler each call
records one span, ``kernel.k2`` or ``kernel.k6`` (``utils/monitor.span``),
from that choice until the launch is enqueued.

K2's edges form (``composite_edges``, ``composite_edges_kernel``; plain
twin ``composite_edges_plain``, counted in ``edges_launches``, span
``kernel.k2``) composites the mip variant's intervals: ``raw [N, 4S]``
between edges ``[N, S + 1]``, ``utils/rendering.composite_intervals``'
arithmetic (no sentinel, no ReLU, ``exp(-cumsum)`` transmittance, depth at
the midpoints, normalized and clipped in the kernel).

K2's opaque edges form (``composite_edges_360_kernel``, counted in
``edges360_launches``, span ``kernel.k2``) composites Mip-NeRF 360's levels,
the last interval opaque: ``composite_weights_360`` the weights ``[N, S]``
of a proposal level from its density ``[N, S]`` (plain twin
``composite_weights_360_plain``), ``composite_edges_360`` the NeRF level's
``raw [N, 4S]`` (plain twin ``composite_edges_360_plain``).

K2 is ``composite_rays_kernel``. Its launch, ``_launch(raw, z_vals, rays_d,
sentinel, eps, with_weights=True)``, writes the weights ``w [N, S]`` only
with ``with_weights``, and returns ``(out [N, 8], w or None)``;
``composite_rays(raw, z_vals, rays_d, cfg, with_weights)`` is the engines'
entry, ``fused_volume_render_interleaved`` the same with the weights. Its
schedule (``segment_lanes``, ``run_length``, ``rays_per_warp``,
``rays_grid``, ``rays_schedule``) is the one the library exports.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.utils.monitor import span
from nerf_tpu_torch.utils.rendering import RenderOutputs, composite_intervals, volume_render

# Launches of the CUDA kernels (not of the plain version); a launch recorded
# into a CUDA graph is not one (_ext.ran).
launches = 0          # K2, interleaved
bf16_launches = 0     # those of K2's launches that read a bfloat16 raw
weightless_launches = 0   # those of K2's launches that wrote no weights
planar_launches = 0   # K6, planar
edges_launches = 0    # K2's edges form (EDGES_KERNEL), the mip variant's intervals
edges360_launches = 0  # K2's opaque edges form (EDGES360_KERNEL), Mip-NeRF 360's levels

KERNEL = "composite_rays_kernel"            # K2
EDGES_KERNEL = "composite_edges_kernel"     # K2's edges form
EDGES360_KERNEL = "composite_edges_360_kernel"   # K2's opaque edges form


# -- K2's schedule (csrc/composite.cu segment_lanes, run_length, rays_grid) ----

RAYS_THREADS = 256    # a block: 8 warps
RAYS_WARPS = RAYS_THREADS // 32
MAX_RUN = 7           # samples a lane a chunk at most; one chunk up to S = 32 * MAX_RUN


def segment_lanes(n_samples: int) -> int:
    """Lanes a ray takes: S / 4 (runs of 4) for a power-of-two S >= 16, at
    most 32; else the smallest power of two >= S, at most 32."""
    if n_samples >= 16 and n_samples & (n_samples - 1) == 0:
        return min(n_samples // 4, 32)
    p = 1
    while p < n_samples and p < 32:
        p <<= 1
    return p


def run_length(n_samples: int) -> int:
    """Samples a lane owns, a contiguous run: ceil(S / segment_lanes(S)),
    at most MAX_RUN."""
    return min(-(-n_samples // segment_lanes(n_samples)), MAX_RUN)


def ray_chunks(n_samples: int) -> List[Tuple[int, int]]:
    """``(first sample, run length)`` of each chunk a ray is walked in: one
    up to S = 32 * MAX_RUN; past it, as many chunks of 32 * MAX_RUN as the
    ray holds, then the rest 32 samples a chunk, one a lane (S = 300: 224 in
    runs of 7, then 32, 32 and 12 in runs of 1)."""
    k = run_length(n_samples)
    if n_samples <= 32 * k:
        return [(0, k)]
    full = n_samples // (32 * k)
    return ([(c * 32 * k, k) for c in range(full)]
            + [(c0, 1) for c0 in range(full * 32 * k, n_samples, 32)])


def rays_per_warp(n_samples: int) -> int:
    return 32 // segment_lanes(n_samples)


def rays_grid(n_rays: int, n_samples: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of a launch: enough for every warp's group of rays, but no
    more than are resident at once (persistent blocks)."""
    groups = -(-n_rays // rays_per_warp(n_samples))
    return min(-(-groups // RAYS_WARPS), blocks_per_sm * sms)


def rays_schedule(n_rays: int, n_samples: int, grid: int):
    """What every lane of a launch of ``grid`` blocks takes, as flat numpy
    arrays over (block, warp, step, lane) for the lanes that own samples:
    ``(block, warp, step, ray, first, stop)``, samples ``[first, stop)`` of
    ``ray``. Warp ``g = block * RAYS_WARPS + warp`` takes the groups ``g,
    g + warps, ...`` of ``rays_per_warp`` consecutive rays; lane ``l``
    serves ray ``group * rays_per_warp + l // P`` and owns, in each chunk
    of ``ray_chunks`` (first sample ``c0``, runs of ``k``), the samples
    ``c0 + (l % P) k ..`` the next ``k - 1`` below S."""
    P, rpw = segment_lanes(n_samples), rays_per_warp(n_samples)
    warps = grid * RAYS_WARPS
    groups = -(-n_rays // rpw)
    chunks = np.array(ray_chunks(n_samples))
    n_c = len(chunks)
    g = np.repeat(np.arange(groups), 32 * n_c)
    l = np.tile(np.repeat(np.arange(32), n_c), groups)
    c0, k = (np.tile(chunks[:, i], 32 * groups) for i in (0, 1))
    ray = g * rpw + l // P
    first = c0 + (l % P) * k
    stop = np.minimum(first + k, np.minimum(c0 + 32 * k, n_samples))
    own = (ray < n_rays) & (first < stop)
    gw = g % warps
    return (gw[own] // RAYS_WARPS, gw[own] % RAYS_WARPS, g[own] // warps, ray[own],
            first[own], stop[own])


def fused_volume_render_interleaved_plain(
    raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
    sentinel: float = 1e10, eps: float = 1e-10, dz: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the kernel: ``(out [N, 8], w [N, S])`` with
    ``out = (r, g, b, depth, acc, 0, 0, 0)``. With ``dz`` the distances are
    that constant step (uniform depths, as the composited ray kernels take
    them) instead of adjacent depth differences; the sentinel stays last."""
    raw = raw.float()
    sigma, rgb = raw[:, 0::4], torch.stack([raw[:, 1::4], raw[:, 2::4],
                                            raw[:, 3::4]], dim=-1)
    z = z_vals.float()
    steps = z[:, 1:] - z[:, :-1] if dz is None else torch.full_like(z[:, 1:], dz)
    dists = torch.cat([steps, torch.full_like(z[:, :1], sentinel)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d.float(), dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    log_t = torch.log(torch.clamp(1.0 - alpha, min=eps))
    t_excl = torch.exp(torch.cat([torch.zeros_like(log_t[:, :1]),
                                  torch.cumsum(log_t, dim=-1)[:, :-1]], dim=-1))
    w = alpha * t_excl
    zeros = torch.zeros_like(w[:, :3])
    out = torch.cat([(w[..., None] * rgb).sum(1), (w * z).sum(1, keepdim=True),
                     w.sum(1, keepdim=True), zeros], dim=-1)
    return out, w


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _launch(raw, z_vals, rays_d, sentinel, eps, with_weights=True):
    """Launch K2 on CUDA tensors: ``(out [N, 8], w [N, S] or None)``, the
    weights written only ``with_weights``."""
    global launches, bf16_launches, weightless_launches
    n, s4 = raw.shape
    s = s4 // 4
    dev = raw.device
    if raw.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"raw must be float32 or bfloat16, got {raw.dtype}")
    for name, t in (("z_vals", z_vals), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    if (not raw.is_contiguous() or z_vals.shape != (n, s) or z_vals.stride(1) != 1
            or rays_d.shape != (n, 3)):
        raise ValueError("raw must be contiguous [N, 4S], z_vals [N, S] with unit "
                         "sample stride and rays_d [N, 3]")
    raw_bf16 = raw.dtype == torch.bfloat16
    if raw.data_ptr() % (8 if raw_bf16 else 16):
        raise ValueError("raw must start on a sample's boundary: 16-byte aligned for "
                         "float32, 8-byte for bfloat16")
    rays_d = rays_d.contiguous()
    out = torch.empty(n, 8, dtype=torch.float32, device=dev)
    w = torch.empty(n, s, dtype=torch.float32, device=dev) if with_weights else None
    if n == 0:
        return out, w
    lib = _ext.load("composite")
    fn = lib.composite_rays
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(_ext.ptr(raw), int(raw_bf16), _ext.ptr(z_vals), z_vals.stride(0), _ext.ptr(rays_d),
             n, s, float(sentinel), float(eps), _ext.ptr(out),
             None if w is None else _ext.ptr(w), _ext.stream_ptr(dev))
    _ext.check(lib, err, f"{KERNEL} launch")
    ran = _ext.ran()
    launches += ran
    bf16_launches += ran * int(raw_bf16)
    weightless_launches += ran * int(not with_weights)
    return out, w


def _outputs(out: torch.Tensor, w: torch.Tensor, cfg: RenderConfig) -> RenderOutputs:
    """``[N, 8]`` + weights -> ``RenderOutputs`` with the white background."""
    rgb = out[:, 0:3]
    acc = out[:, 4]
    if cfg.white_background:
        rgb = rgb + (1.0 - acc[:, None])
    return RenderOutputs(rgb, out[:, 3], acc, w)


def fused_volume_render_interleaved(
    raw: torch.Tensor,        # [N, 4S] interleaved (sigma, r, g, b), float32 or bfloat16
    z_vals: torch.Tensor,     # [N, S]
    rays_d: torch.Tensor,     # [N, 3]
    cfg: RenderConfig = RenderConfig(),
) -> RenderOutputs:
    return composite_rays(raw, z_vals, rays_d, cfg, with_weights=True)


def composite_rays(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                   cfg: RenderConfig = RenderConfig(),
                   with_weights: bool = True) -> RenderOutputs:
    """``fused_volume_render_interleaved`` whose ``weights`` are None
    unless ``with_weights``: on the card K2 then writes none."""
    if raw.shape[1] % 4:
        raise ValueError(f"raw must be [N, 4S], got {tuple(raw.shape)}")
    with span("kernel.k2"):
        if raw.device.type == "cpu":
            out, w = fused_volume_render_interleaved_plain(
                raw, z_vals, rays_d, cfg.dist_sentinel, cfg.transmittance_eps)
            w = w if with_weights else None
        else:
            out, w = _launch(raw, z_vals, rays_d, cfg.dist_sentinel,
                             cfg.transmittance_eps, with_weights)
    return _outputs(out, w, cfg)


# -- K2's edges form: Mip-NeRF's intervals -------------------------------------

def composite_edges_plain(raw: torch.Tensor, edges: torch.Tensor, rays_d: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of ``composite_edges_kernel``: ``raw [N, 4S]``
    (per interval ``(density, r, g, b)``, float32 or bfloat16) between
    ``edges [N, S + 1]`` -> ``(out [N, 8], w [N, S])``, ``out = (r, g, b,
    depth, acc, 0, 0, 0)``: ``utils/rendering.composite_intervals`` without
    the background (the depth normalized and clipped there)."""
    raw = raw.float()
    n = raw.shape[0]
    dens = raw[:, 0::4]
    rgb = torch.stack([raw[:, 1::4], raw[:, 2::4], raw[:, 3::4]], dim=-1)
    res = composite_intervals(dens, rgb, edges.float(), rays_d.float(), False)
    zeros = torch.zeros(n, 3, dtype=torch.float32, device=raw.device)
    out = torch.cat([res.rgb, res.depth[:, None], res.acc[:, None], zeros], dim=-1)
    return out, res.weights


_EDGES_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]


def _launch_edges(raw, edges, rays_d, with_weights=True):
    """Launch ``composite_edges_kernel`` on CUDA tensors: ``(out [N, 8], w
    [N, S] or None)``."""
    global edges_launches
    n, s4 = raw.shape
    s = s4 // 4
    dev = raw.device
    if raw.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"raw must be float32 or bfloat16, got {raw.dtype}")
    for name, t in (("edges", edges), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    if (not raw.is_contiguous() or edges.shape != (n, s + 1) or edges.stride(1) != 1
            or rays_d.shape != (n, 3)):
        raise ValueError("raw must be contiguous [N, 4S], edges [N, S + 1] with unit "
                         "stride along the ray and rays_d [N, 3]")
    raw_bf16 = raw.dtype == torch.bfloat16
    if raw.data_ptr() % (8 if raw_bf16 else 16):
        raise ValueError("raw must start on a sample's boundary")
    rays_d = rays_d.contiguous()
    out = torch.empty(n, 8, dtype=torch.float32, device=dev)
    w = torch.empty(n, s, dtype=torch.float32, device=dev) if with_weights else None
    if n == 0:
        return out, w
    lib = _ext.load("composite")
    fn = lib.composite_edges
    fn.argtypes = _EDGES_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(_ext.ptr(raw), int(raw_bf16), _ext.ptr(edges), edges.stride(0), _ext.ptr(rays_d),
             n, s, _ext.ptr(out), None if w is None else _ext.ptr(w), _ext.stream_ptr(dev))
    _ext.check(lib, err, f"{EDGES_KERNEL} launch")
    edges_launches += _ext.ran()
    return out, w


def composite_edges(raw: torch.Tensor, edges: torch.Tensor, rays_d: torch.Tensor,
                    cfg: RenderConfig = RenderConfig(),
                    with_weights: bool = True) -> RenderOutputs:
    """K2's edges form: the mip variant's ``raw [N, 4S]`` composited over
    the intervals ``edges [N, S + 1]`` (``composite_intervals``), the white
    background added here; ``weights`` None unless ``with_weights``."""
    if raw.shape[1] % 4:
        raise ValueError(f"raw must be [N, 4S], got {tuple(raw.shape)}")
    with span("kernel.k2"):
        if raw.device.type == "cpu":
            out, w = composite_edges_plain(raw, edges, rays_d)
            w = w if with_weights else None
        else:
            out, w = _launch_edges(raw, edges, rays_d, with_weights)
    return _outputs(out, w, cfg)


# -- K2's opaque edges form: Mip-NeRF 360's levels ------------------------------

def composite_weights_360_plain(density: torch.Tensor, edges: torch.Tensor,
                                rays_d: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of ``composite_edges_360_kernel``'s weights
    entry: a proposal level's ``w [N, S]`` from ``density [N, S]`` between
    the metric ``edges [N, S + 1]``, the last interval opaque."""
    rgb = density.new_zeros(*density.shape, 3)
    return composite_intervals(density.float(), rgb, edges.float(), rays_d.float(), False,
                               opaque=True).weights


def composite_edges_360_plain(raw: torch.Tensor, edges: torch.Tensor,
                              rays_d: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of ``composite_edges_360_kernel``'s NeRF entry:
    ``raw [N, 4S]`` float32 between ``edges [N, S + 1]``, the last interval
    opaque -> ``out [N, 8] = (r, g, b, depth, acc, 0, 0, 0)`` without the
    background."""
    raw = raw.float()
    dens = raw[:, 0::4]
    rgb = torch.stack([raw[:, 1::4], raw[:, 2::4], raw[:, 3::4]], dim=-1)
    res = composite_intervals(dens, rgb, edges.float(), rays_d.float(), False, opaque=True)
    zeros = torch.zeros(raw.shape[0], 3, dtype=torch.float32, device=raw.device)
    return torch.cat([res.rgb, res.depth[:, None], res.acc[:, None], zeros], dim=-1)


_EDGES360_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]


def _launch_edges_360(x, edges, rays_d, weights: bool):
    """Launch ``composite_edges_360_kernel`` on CUDA tensors: the weights
    ``[N, S]`` of a density ``x [N, S]`` (``weights``), or ``out [N, 8]`` of a
    raw ``x [N, 4S]``, both float32."""
    global edges360_launches
    n = x.shape[0]
    s = x.shape[1] if weights else x.shape[1] // 4
    dev = x.device
    for name, t in (("density" if weights else "raw", x), ("edges", edges), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    if (not x.is_contiguous() or edges.shape != (n, s + 1) or edges.stride(1) != 1
            or rays_d.shape != (n, 3) or (not weights and x.shape[1] != 4 * s)):
        raise ValueError("the density must be contiguous [N, S] (raw [N, 4S]), edges [N, S + 1] "
                         "with unit stride along the ray and rays_d [N, 3]")
    if not weights and x.data_ptr() % 16:
        raise ValueError("raw must start on a sample's boundary")
    rays_d = rays_d.contiguous()
    out = None if weights else torch.empty(n, 8, dtype=torch.float32, device=dev)
    w = torch.empty(n, s, dtype=torch.float32, device=dev) if weights else None
    if n == 0:
        return w if weights else out
    lib = _ext.load("composite")
    fn = lib.composite_edges_360
    fn.argtypes = _EDGES360_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(_ext.ptr(x), int(weights), _ext.ptr(edges), edges.stride(0), _ext.ptr(rays_d), n, s,
             None if out is None else _ext.ptr(out), None if w is None else _ext.ptr(w),
             _ext.stream_ptr(dev))
    _ext.check(lib, err, f"{EDGES360_KERNEL} launch")
    edges360_launches += _ext.ran()
    return w if weights else out


def composite_weights_360(density: torch.Tensor, edges: torch.Tensor,
                          rays_d: torch.Tensor) -> torch.Tensor:
    """K2's opaque edges form, weights entry: a proposal level's ``w [N, S]``
    from its ``density [N, S]`` between the metric ``edges [N, S + 1]``."""
    with span("kernel.k2"):
        if density.device.type == "cpu":
            return composite_weights_360_plain(density, edges, rays_d)
        return _launch_edges_360(density, edges, rays_d, True)


def composite_edges_360(raw: torch.Tensor, edges: torch.Tensor, rays_d: torch.Tensor,
                        cfg: RenderConfig = RenderConfig()) -> RenderOutputs:
    """K2's opaque edges form, NeRF entry: the NeRF level's ``raw [N, 4S]``
    composited over ``edges [N, S + 1]``, the last interval opaque, the
    background added here; no weights."""
    if raw.shape[1] % 4:
        raise ValueError(f"raw must be [N, 4S], got {tuple(raw.shape)}")
    with span("kernel.k2"):
        if raw.device.type == "cpu":
            out = composite_edges_360_plain(raw, edges, rays_d)
        else:
            out = _launch_edges_360(raw, edges, rays_d, False)
    return _outputs(out, None, cfg)


def fused_volume_render_plain(sigma, planes, z_vals, rays_d, sentinel=1e10, eps=1e-10):
    """Plain-PyTorch version of the planar kernel: the interleaved plain
    version on the stacked input. ``planes``: three ``[N, S]`` tensors."""
    raw = torch.stack([sigma, *planes], dim=-1).reshape(sigma.shape[0], -1)
    return fused_volume_render_interleaved_plain(raw, z_vals, rays_d, sentinel, eps)


_PLANAR_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] * 2   # sigma, planes, strides
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]         # z, z row stride, rays_d
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2                     # N, S, sentinel, eps
    + [ctypes.c_void_p] * 3                                         # out, w, stream
)


def _launch_planar(sigma, planes, z_vals, rays_d, sentinel, eps):
    """Launch ``composite_planar_kernel``. sigma and the three color planes
    are ``[N, S]`` views of any strides (a slice of the MLP kernel's
    ``[N * S, 4]`` output needs no copy); the planes must share theirs."""
    global planar_launches
    n, s = sigma.shape
    dev = sigma.device
    for name, t in (("sigma", sigma), ("z_vals", z_vals), ("rays_d", rays_d),
                    *((f"rgb plane {i}", p) for i, p in enumerate(planes))):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    if (any(p.shape != (n, s) for p in planes) or z_vals.shape != (n, s)
            or z_vals.stride(1) != 1 or rays_d.shape != (n, 3)):
        raise ValueError("sigma and the rgb planes must be [N, S], z_vals [N, S] with "
                         "unit sample stride and rays_d [N, 3]")
    if any(p.stride() != planes[0].stride() for p in planes):
        planes = [p.contiguous() for p in planes]
    rays_d = rays_d.contiguous()
    out = torch.empty(n, 8, dtype=torch.float32, device=dev)
    w = torch.empty(n, s, dtype=torch.float32, device=dev)
    if n == 0:
        return out, w
    lib = _ext.load("composite")
    fn = lib.composite_planar
    fn.argtypes = _PLANAR_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(_ext.ptr(sigma), *(_ext.ptr(p) for p in planes),
             sigma.stride(0), sigma.stride(1), planes[0].stride(0), planes[0].stride(1),
             _ext.ptr(z_vals), z_vals.stride(0), _ext.ptr(rays_d), n, s,
             float(sentinel), float(eps), _ext.ptr(out), _ext.ptr(w), _ext.stream_ptr(dev))
    _ext.check(lib, err, "composite_planar launch")
    planar_launches += _ext.ran()
    return out, w


class _FusedVolumeRender(torch.autograd.Function):
    """Forward: the planar kernel (the plain version on the CPU). Backward:
    recompute through ``volume_render`` under autograd."""

    @staticmethod
    def forward(ctx, cfg, sigma, z_vals, rays_d, *planes):
        ctx.cfg = cfg
        ctx.save_for_backward(sigma, z_vals, rays_d, *planes)
        with span("kernel.k6"):
            launch = (fused_volume_render_plain if sigma.device.type == "cpu"
                      else _launch_planar)
            out, w = launch(sigma, planes, z_vals, rays_d, cfg.dist_sentinel,
                            cfg.transmittance_eps)
        return tuple(_outputs(out, w, cfg))

    @staticmethod
    def backward(ctx, *cotangents):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[1:])]
            sigma, z_vals, rays_d, *planes = inputs
            res = volume_render(sigma, torch.stack(planes, dim=-1), z_vals, rays_d, ctx.cfg)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(tuple(res), wanted, cotangents,
                                             allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None for t in inputs))


def fused_volume_render(
    sigma: torch.Tensor,                                     # [N, S]
    rgb: Union[torch.Tensor, Sequence[torch.Tensor]],        # [N, S, 3] or three [N, S]
    z_vals: torch.Tensor,                                    # [N, S]
    rays_d: torch.Tensor,                                    # [N, 3]
    cfg: RenderConfig = RenderConfig(),
) -> RenderOutputs:
    """Fused replacement for ``volume_render`` (the deterministic path;
    density noise is a training-only feature of ``volume_render``)."""
    planes = rgb.unbind(-1) if torch.is_tensor(rgb) else tuple(rgb)
    if len(planes) != 3 or sigma.dim() != 2:
        raise ValueError("sigma must be [N, S] and rgb [N, S, 3] or three [N, S] planes")
    return RenderOutputs(*_FusedVolumeRender.apply(cfg, sigma, z_vals, rays_d, *planes))
