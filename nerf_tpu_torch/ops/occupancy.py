"""Occupancy-grid sample placement: the accel engine's grid and depths.

Counterpart of ``nerf_tpu/ops/occupancy.py`` (which has no Pallas kernel):
a dense density grid baked once from the trained network marks where in the
scene's box there is matter; at render time every ray probes the grid at
``n_probe`` depths (a gather, not a network evaluation) and places its
samples by inverse CDF of the probed profile, so the same sample budget is
spent where the scene is.

- ``build_occupancy_grid``: the network's ``relu(sigma)`` at every cell
  centre, in chunks of ``1 << 18`` points, through ``apply_fn`` (the accel
  engine passes the per-sample MLP kernel, K4, on bf16 packed weights);
  ``store="binary"`` thresholds it to {0, 1}, ``store="density"`` keeps it;
- ``downsample_grid``: a max-pool (a dilating mip);
- ``query_occupancy``: the nearest cell, 0 outside the box;
- ``grid_guided_z_vals``: the probe profile's weights (``occupancy``,
  ``alpha`` or ``transmittance``) and ``sample_pdf`` over them, once per
  group of ``ray_stride`` rays: ``occupancy_z_kernel`` of
  ``csrc/occupancy.cu``, one launch a call, for rays on the card;
  ``grid_guided_z_vals_plain``, the same function in plain PyTorch, for rays
  on the CPU. ``launches`` counts the kernel's launches.

Each function keeps its JAX counterpart's arithmetic in the same order, so
equal float32 points fall in equal cells in both packages, and the kernel
keeps the plain version's. The rest is plain PyTorch on the device of its
inputs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import apply_nerf
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.utils.rendering import draw_uniforms, sample_pdf
from nerf_tpu_torch.utils.tree import tree_leaves

LIBRARY = "occupancy"
KERNEL = "occupancy_z_kernel"
WEIGHT_MODES = {"occupancy": 0, "alpha": 1, "transmittance": 2}   # the kernel's codes
MAX_PROBES = 1024      # the kernel's knots a warp in shared memory (csrc/occupancy.cu)
MAX_SORTED = 256       # its sort of a ray's depths in the stochastic form

# Launches of the CUDA kernel (not of the plain version); one a chunk of the
# accel engine's benchmark mode. A launch recorded into a CUDA graph is not
# one (_ext.ran).
launches = 0

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4        # grid, G, lo, hi, ro, rd
             + [ctypes.c_int] * 5                                           # N, stride, P, S, mode
             + [ctypes.c_float] * 4                                         # near, span, dz, floor
             + [ctypes.c_void_p] * 3)                                       # u, out, stream


class OccupancyGrid(NamedTuple):
    occupancy: torch.Tensor   # [G^3] float32, flat, x-major: {0, 1} (store="binary")
                              # or relu(sigma) (store="density")
    aabb_lo: torch.Tensor     # [3]
    aabb_hi: torch.Tensor     # [3]
    resolution: int


def build_occupancy_grid(
    params,
    cfg: ModelConfig,
    resolution: int = 128,
    aabb: Tuple[float, float] = (-1.5, 1.5),
    density_threshold: float = 5.0,
    apply_fn=apply_nerf,
    chunk: int = 1 << 18,
    compute_dtype: torch.dtype = torch.bfloat16,
    store: str = "binary",
) -> OccupancyGrid:
    """Bake the grid: ``relu(sigma)`` of the network at every cell centre
    ``(i + 0.5) / G * (hi - lo) + lo`` with zero directions, thresholded at
    ``density_threshold`` (``store="binary"``) or kept (``"density"``). The
    grid lives on the device of ``params`` (a params dict or packed
    weights, whatever ``apply_fn`` takes)."""
    dev = next(leaf for _, leaf in tree_leaves(params) if leaf is not None).device
    g = resolution
    lo, hi = float(aabb[0]), float(aabb[1])
    centers = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g * (hi - lo) + lo
    X, Y, Z = torch.meshgrid(centers, centers, centers, indexing="ij")
    pts = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)          # [G^3, 3]
    sigma = []
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        s, _ = apply_fn(params, p, torch.zeros_like(p), cfg, compute_dtype=compute_dtype)
        sigma.append(torch.relu(s))
    sigma = torch.cat(sigma)
    if store == "density":
        occupancy = sigma.float()
    else:
        occupancy = (sigma > density_threshold).float()
    return OccupancyGrid(occupancy=occupancy, aabb_lo=torch.full((3,), lo, device=dev),
                         aabb_hi=torch.full((3,), hi, device=dev), resolution=g)


def downsample_grid(grid: OccupancyGrid, factor: int) -> OccupancyGrid:
    """Max-pool over ``factor^3`` cells: a supercell holds matter iff any of
    its cells does, so a coarser probe never misses what the grid found."""
    g = grid.resolution
    assert g % factor == 0, (g, factor)
    gc = g // factor
    occ = grid.occupancy.reshape(gc, factor, gc, factor, gc, factor).amax(dim=(1, 3, 5))
    return OccupancyGrid(occupancy=occ.reshape(-1), aabb_lo=grid.aabb_lo,
                         aabb_hi=grid.aabb_hi, resolution=gc)


def query_occupancy(grid: OccupancyGrid, points: torch.Tensor) -> torch.Tensor:
    """The grid's value at the nearest cell of each of ``points [..., 3]``:
    ``[...]``, 0 outside the box."""
    g = grid.resolution
    t = (points - grid.aabb_lo) / (grid.aabb_hi - grid.aabb_lo)
    idx = torch.floor(t * g).to(torch.int32)
    in_bounds = ((idx >= 0) & (idx < g)).all(dim=-1)
    idx = idx.clamp(0, g - 1)
    flat = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
    occ = grid.occupancy[flat.reshape(-1).long()].reshape(flat.shape)
    return occ * in_bounds.to(occ.dtype)


def grid_guided_z_vals_plain(
    grid: OccupancyGrid,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    n_probe: int = 128,
    generator: Optional[torch.Generator] = None,
    floor: float = 1e-3,
    ray_stride: int = 1,
    weight_mode: str = "occupancy",
) -> torch.Tensor:
    """``[N, n_samples]`` depths per ray, placed where the grid says the
    scene is. ``n_probe`` uniform probes per ray give a piecewise-constant
    pdf (plus ``floor``, so a ray that finds nothing samples near-uniformly);
    ``weight_mode`` weighs a probe by its occupancy, its opacity
    ``1 - exp(-sigma * dz)`` (density grids) or that opacity times the
    exclusive transmittance along the probes. With ``ray_stride > 1`` only
    every ``stride``-th ray (a group leader, rays in scanline order) probes,
    and its group shares the profile. Without ``generator`` the draws are
    the deterministic midpoints: one ``sample_pdf`` per group, repeated, and
    sorted as drawn; with it each ray draws its own depths, then sorts."""
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    t = (torch.arange(n_probe, dtype=torch.float32, device=dev) + 0.5) / n_probe
    z_probe_row = near + (far - near) * t                            # [P]
    if ray_stride > 1:
        n_groups = -(-n_rays // ray_stride)
        rep = torch.clamp(torch.arange(n_groups, device=dev) * ray_stride, max=n_rays - 1)
        ro_p, rd_p = rays_o[rep], rays_d[rep]
    else:
        n_groups = n_rays
        ro_p, rd_p = rays_o, rays_d
    z_probe = z_probe_row.expand(n_groups, n_probe)
    pts = ro_p[:, None, :] + rd_p[:, None, :] * z_probe[..., None]
    occ = query_occupancy(grid, pts)                                  # [N/stride, P]
    if weight_mode == "occupancy":
        weights = occ + floor
    else:
        dz = (far - near) / n_probe * torch.linalg.norm(rd_p, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-occ * dz)
        if weight_mode == "alpha":
            weights = alpha + floor
        elif weight_mode == "transmittance":
            log_t = torch.log1p(-torch.clamp(alpha, max=1.0 - 1e-7))
            t_excl = torch.exp(torch.cumsum(log_t, dim=-1) - log_t)   # exclusive
            weights = alpha * t_excl + floor
        else:
            raise ValueError(f"unknown weight_mode {weight_mode!r}")
    if generator is None:
        z = sample_pdf(z_probe, weights, n_samples, deterministic=True)
        if ray_stride > 1:
            z = z.repeat_interleave(ray_stride, dim=0)[:n_rays]
        return z
    if ray_stride > 1:
        weights = weights.repeat_interleave(ray_stride, dim=0)[:n_rays]
    z = sample_pdf(z_probe_row.expand(n_rays, n_probe), weights, n_samples,
                   generator=generator)
    return torch.sort(z, dim=-1).values


def load() -> ctypes.CDLL:
    """The bound library, its signature set once."""
    lib = _ext.load(LIBRARY)
    if lib.occupancy_z_vals.argtypes is None:
        lib.occupancy_z_vals.argtypes = _ARGTYPES
        lib.occupancy_z_vals.restype = ctypes.c_int
    return lib


def _check(grid: OccupancyGrid, rays_o: torch.Tensor, rays_d: torch.Tensor, n_samples: int,
           n_probe: int, u: Optional[torch.Tensor], ray_stride: int) -> None:
    """What the kernel takes: float32 contiguous rays ``[N, 3]``, the grid's
    ``G^3`` values and its corners, and the draws ``[N, n_samples]`` if
    given, on one device; ``n_probe`` knots that fit a warp's shared memory
    and, drawn at random, ``n_samples`` depths that fit its sort."""
    if not 1 <= n_probe <= MAX_PROBES:
        raise ValueError(f"the depths kernel takes 1 to {MAX_PROBES} probes (MAX_PROBES, its "
                         f"knots in shared memory), not {n_probe}")
    if u is not None and not 1 <= n_samples <= MAX_SORTED:
        raise ValueError(f"the depths kernel sorts 1 to {MAX_SORTED} random depths a ray "
                         f"(MAX_SORTED), not {n_samples}")
    if n_samples < 1 or ray_stride < 1:
        raise ValueError(f"n_samples and ray_stride must be positive, not {n_samples}, "
                         f"{ray_stride}")
    dev, n, g = rays_o.device, rays_o.shape[0], grid.resolution
    for name, t, shape in (("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)),
                           ("grid.occupancy", grid.occupancy, (g ** 3,)),
                           ("grid.aabb_lo", grid.aabb_lo, (3,)),
                           ("grid.aabb_hi", grid.aabb_hi, (3,)),
                           *((("u", u, (n, n_samples)),) if u is not None else ())):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}")


def _launch(grid: OccupancyGrid, rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
            far: float, n_samples: int, n_probe: int, u: Optional[torch.Tensor], floor: float,
            ray_stride: int, mode: int) -> torch.Tensor:
    """Launch the kernel: ``[N, n_samples]`` float32 depths in a new tensor
    on the rays' device. ``u`` gives each ray's draws ``[N, n_samples]``
    (None: the midpoints); ``mode`` is ``WEIGHT_MODES``' code. The box's
    corners reach the kernel as the grid's device tensors: nothing is read
    back to the host."""
    global launches
    # a frame without padding hands on generate_rays' broadcast origins
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    _check(grid, rays_o, rays_d, n_samples, n_probe, u, ray_stride)
    n_rays, dev = rays_o.shape[0], rays_o.device
    out = torch.empty(n_rays, n_samples, dtype=torch.float32, device=dev)
    lib = load()
    err = lib.occupancy_z_vals(
        _ext.ptr(grid.occupancy), grid.resolution, _ext.ptr(grid.aabb_lo), _ext.ptr(grid.aabb_hi),
        _ext.ptr(rays_o), _ext.ptr(rays_d), n_rays, ray_stride, n_probe, n_samples, mode,
        near, far - near, (far - near) / n_probe, floor,
        None if u is None else _ext.ptr(u), _ext.ptr(out), _ext.stream_ptr(dev))
    _ext.check(lib, err, "occupancy_z_vals launch")
    launches += _ext.ran()
    return out


def grid_guided_z_vals(
    grid: OccupancyGrid,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    n_probe: int = 128,
    generator: Optional[torch.Generator] = None,
    floor: float = 1e-3,
    ray_stride: int = 1,
    weight_mode: str = "occupancy",
) -> torch.Tensor:
    """``grid_guided_z_vals_plain``'s depths: the plain version for rays on
    the CPU, one launch of the kernel for any other device. With
    ``generator`` the kernel takes ``draw_uniforms``' ``[N, n_samples]``
    draws, the ones the plain version's ``sample_pdf`` makes."""
    if rays_o.device.type == "cpu":
        return grid_guided_z_vals_plain(grid, rays_o, rays_d, near, far, n_samples, n_probe,
                                        generator, floor, ray_stride, weight_mode)
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"unknown weight_mode {weight_mode!r}")
    u = None if generator is None else draw_uniforms(rays_o, n_samples, generator)
    return _launch(grid, rays_o, rays_d, near, far, n_samples, n_probe, u, floor, ray_stride,
                   WEIGHT_MODES[weight_mode])
