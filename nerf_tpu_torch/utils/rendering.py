"""Volume-rendering math in plain PyTorch.

Counterpart of ``nerf_tpu/utils/rendering.py`` for the benchmark render:
uniform (optionally jittered) depths ``z = near*(1-t) + far*t`` and the
compositor with a 1e10 sentinel last distance scaled by ``||d||``,
``alpha = 1 - exp(-relu(sigma) * dist)`` and exclusive cumulative-product
transmittance with a ``+1e-10`` epsilon. Hierarchical sampling
(``sample_pdf``, ``importance_sample``) arrives with the hierarchical slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from nerf_tpu_torch.config import RenderConfig


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor      # [N, 3]
    depth: torch.Tensor    # [N]
    acc: torch.Tensor      # [N] accumulated opacity
    weights: torch.Tensor  # [N, S]


def sample_points_on_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    perturb: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(points [N, S, 3], z_vals [N, S])``. With ``perturb`` each
    depth is jittered uniformly within its stratum; the draws come from
    ``generator`` (which must live on the rays' device)."""
    n_rays = rays_o.shape[0]
    t = torch.linspace(0.0, 1.0, n_samples, dtype=rays_o.dtype,
                       device=rays_o.device)
    z_vals = (near * (1.0 - t) + far * t).expand(n_rays, n_samples)
    if perturb:
        if generator is None:
            raise ValueError("perturb=True requires a torch.Generator")
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = torch.rand(z_vals.shape, dtype=z_vals.dtype,
                            device=z_vals.device, generator=generator)
        z_vals = lower + (upper - lower) * t_rand
    points = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return points, z_vals


def volume_render(
    sigma: torch.Tensor,
    rgb: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    cfg: RenderConfig = RenderConfig(),
) -> RenderOutputs:
    """Alpha-composite ``(sigma [N, S], rgb [N, S, 3])`` into per-ray maps."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], cfg.dist_sentinel)],
                      dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(1.0 - alpha + cfg.transmittance_eps, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    if cfg.white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, depth_map, acc_map, weights)
