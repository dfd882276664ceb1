"""Plain float32 frames: what each engine's frame computes, worked out again.

- ``uniform``: one network at ``S`` evenly spaced depths from near to far;
- ``hierarchical``: the coarse network at ``n_coarse`` uniform depths, its
  weights, ``n_fine`` depths drawn by inverse CDF at the midpoints, merged
  and sorted with the coarse ones, the fine network there;
- ``accel``: a density grid baked from the fine network (``relu(sigma)`` at
  every cell centre), max-pooled to the probe resolution, probed at
  ``n_probe`` depths by every ``ray_stride``-th ray, the alpha profile's
  inverse CDF for the group's depths, the fine network there.

Compositing: ``alpha = 1 - exp(-relu(sigma) * dist)`` with the last
distance a sentinel, all distances scaled by ``|d|``, exclusive transmittance
``prod(1 - alpha + eps)``, white background where the configuration asks.
The rays of a frame are rendered in blocks whose size is a multiple of the
probe stride, so that groups of rays are the frame's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerfbench.reference.nerf import Rounding, mlp


def camera_rays(pose: np.ndarray, width: int, height: int, focal: float, device):
    """``(rays_o, rays_d)`` ``[H * W, 3]`` row-major, OpenGL camera (x right,
    y up, looking down -z), directions not normalized."""
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    i = torch.arange(width, dtype=torch.float32, device=device)[None, :].expand(height, width)
    j = torch.arange(height, dtype=torch.float32, device=device)[:, None].expand(height, width)
    dirs = torch.stack([(i - width * 0.5) / focal, -(j - height * 0.5) / focal,
                        -torch.ones_like(i)], dim=-1).reshape(-1, 3)
    rays_d = (dirs[:, None, :] * pose[:3, :3]).sum(-1)
    return pose[:3, 3].expand(rays_d.shape), rays_d


def uniform_depths(n_rays: int, near: float, far: float, n: int, device) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n, device=device)
    return (near * (1.0 - t) + far * t).expand(n_rays, n)


def composite(sigma, rgb, z, rays_d, render: dict):
    """``(rgb [R, 3], depth [R], weights [R, S])``."""
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], render["dist_sentinel"])], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(1.0 - alpha + render["transmittance_eps"], dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha * trans
    out = (w[..., None] * rgb).sum(-2)
    if render["white_background"]:
        out = out + (1.0 - w.sum(-1, keepdim=True))
    return out, (w * z).sum(-1), w


def sample_pdf(z: torch.Tensor, weights: torch.Tensor, n: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse CDF of the piecewise-constant pdf ``weights + 1e-5`` over the
    knots ``z``: midpoint draws ``(i + 0.5) / n`` unless ``u`` is given."""
    n_rays, n_bins = z.shape
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if u is None:
        u = ((torch.arange(n, dtype=z.dtype, device=z.device) + 0.5) / n).expand(n_rays, n)
        u = u.contiguous()
    below = (torch.searchsorted(cdf[:, :n_bins].contiguous(), u, right=True) - 1)
    below = below.clamp(0, n_bins - 1)
    above = (below + 1).clamp(max=n_bins - 1)
    c0, c1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, below + 1)
    z0, z1 = torch.gather(z, 1, below), torch.gather(z, 1, above)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return z0 + (u - c0) / denom * (z1 - z0)


def at_depths(net, ro, rd, z, model, render, rnd: Rounding):
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    sigma, rgb = mlp(net, pts, rd, model, rnd)
    return composite(sigma, rgb, z, rd, render)


# -- the accel engine's grid ---------------------------------------------------


def bake_grid(net, model: dict, accel: dict, rnd: Rounding, chunk: int = 1 << 18):
    """``relu(sigma)`` of ``net`` at every cell centre of the ``G^3`` grid
    (x-major, zero view direction), max-pooled to ``probe_resolution``:
    ``(grid [g^3], resolution g)``."""
    g = accel["grid_resolution"]
    lo, hi = accel["aabb"]
    dev = net["density"]["w"].device
    c = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g * (hi - lo) + lo
    X, Y, Z = torch.meshgrid(c, c, c, indexing="ij")
    pts = torch.stack([X, Y, Z], dim=-1).reshape(-1, 1, 3)
    sig = []
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        s, _ = mlp(net, p, torch.zeros_like(p[:, 0]), model, rnd)
        sig.append(torch.relu(s[:, 0]))
    grid = torch.cat(sig)
    pr = accel["probe_resolution"]
    if pr and pr < g:
        f = g // pr
        grid = grid.reshape(pr, f, pr, f, pr, f).amax(dim=(1, 3, 5)).reshape(-1)
        g = pr
    return grid, g


def grid_depths(grid, g: int, ro, rd, near: float, far: float, n: int, accel: dict):
    """The deterministic grid-guided depths: every ``ray_stride``-th ray (a
    group leader) probes the grid at ``n_probe`` midpoints, weighs the
    probes by ``1 - exp(-sigma * dz) + 1e-3`` and its group takes the
    profile's midpoint inverse-CDF depths."""
    lo, hi = accel["aabb"]
    stride, n_probe = accel["probe_ray_stride"], accel["n_probe"]
    if accel["weight_mode"] != "alpha":
        raise ValueError("the reference places depths by the alpha profile only")
    n_rays = ro.shape[0]
    t = (torch.arange(n_probe, dtype=torch.float32, device=ro.device) + 0.5) / n_probe
    z_row = near + (far - near) * t
    lead = torch.clamp(torch.arange(-(-n_rays // stride), device=ro.device) * stride,
                       max=n_rays - 1)
    ro_p, rd_p = ro[lead], rd[lead]
    zp = z_row.expand(lead.shape[0], n_probe)
    pts = ro_p[:, None, :] + rd_p[:, None, :] * zp[..., None]
    tt = (pts - lo) / (hi - lo)
    idx = torch.floor(tt * g).to(torch.int32)
    inside = ((idx >= 0) & (idx < g)).all(dim=-1)
    idx = idx.clamp(0, g - 1)
    flat = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
    occ = grid[flat.reshape(-1).long()].reshape(flat.shape) * inside.float()
    dz = (far - near) / n_probe * torch.linalg.norm(rd_p, dim=-1, keepdim=True)
    w = 1.0 - torch.exp(-occ * dz) + 1e-3
    z = sample_pdf(zp, w, n)
    return z.repeat_interleave(stride, dim=0)[:n_rays]


# -- frames ---------------------------------------------------------------------


def frame(kind: str, nets: Dict[str, dict], pose, width: int, height: int, focal: float,
          model: dict, render: dict, samples: int, rnd: Rounding = None,
          grid: Optional[Tuple[torch.Tensor, int]] = None,
          accel: Optional[dict] = None, block: int = 8192):
    """``(rgb [H, W, 3], depth [H, W])`` float32 of one frame, on the
    networks' device. ``kind``: ``uniform`` (``samples`` depths),
    ``hierarchical`` (``render['n_coarse'] + render['n_fine']``) or
    ``accel`` (``samples`` grid-placed depths; ``grid`` from ``bake_grid``)."""
    dev = nets["fine"]["density"]["w"].device
    ro_all, rd_all = camera_rays(pose, width, height, focal, dev)
    near, far = render["near"], render["far"]
    rgbs, depths = [], []
    with torch.no_grad():
        for i in range(0, ro_all.shape[0], block):
            ro, rd = ro_all[i:i + block], rd_all[i:i + block]
            if kind == "uniform":
                z = uniform_depths(ro.shape[0], near, far, samples, dev)
            elif kind == "hierarchical":
                z_c = uniform_depths(ro.shape[0], near, far, render["n_coarse"], dev)
                _, _, w = at_depths(nets["coarse"], ro, rd, z_c, model, render, rnd)
                z_new = sample_pdf(z_c, w, render["n_fine"])
                z = torch.sort(torch.cat([z_c, z_new], dim=-1), dim=-1).values
            elif kind == "accel":
                z = grid_depths(grid[0], grid[1], ro, rd, near, far, samples, accel)
            else:
                raise ValueError(f"unknown frame kind {kind!r}")
            rgb, depth, _ = at_depths(nets["fine"], ro, rd, z, model, render, rnd)
            rgbs.append(rgb)
            depths.append(depth)
    return (torch.cat(rgbs).reshape(height, width, 3), torch.cat(depths).reshape(height, width))
