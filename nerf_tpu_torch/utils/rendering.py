"""Volume-rendering math in plain PyTorch.

Counterpart of ``nerf_tpu/utils/rendering.py``: uniform (optionally
jittered) depths ``z = near*(1-t) + far*t``; hierarchical inverse-CDF
sampling from coarse weights (``sample_pdf``, ``importance_sample``); and
the compositor with a 1e10 sentinel last distance scaled by ``||d||``,
``alpha = 1 - exp(-relu(sigma) * dist)`` and exclusive cumulative-product
transmittance with a ``+1e-10`` epsilon, with optional density noise during
training; ``normalized_depth`` divides a map's depth by its opacity.
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


def draw_uniforms(z_vals: torch.Tensor, n_importance: int,
                  generator: torch.Generator) -> torch.Tensor:
    """``sample_pdf``'s random draws ``[N, n_importance]`` in [0, 1)."""
    return torch.rand((z_vals.shape[0], n_importance), dtype=z_vals.dtype,
                      device=z_vals.device, generator=generator)


def sample_pdf(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_importance`` new depths from the coarse
    weights: ``z_vals [N, S]``, ``weights [N, S]`` -> ``[N, n_importance]``.
    ``u [N, n_importance]`` gives the draws themselves (``draw_uniforms``),
    for a caller that fixes their place in the generator's sequence.

    A piecewise-constant pdf over the coarse depths (weights + 1e-5), a CDF
    with a leading zero, draws ``u`` (evenly spaced midpoints
    ``(i + 0.5) / n`` when ``deterministic``, else uniform from
    ``generator``), the bin of each draw and linear interpolation between
    the bracketing knots (a bin narrower than 1e-5 counts as 1 wide). The
    bin is the last knot ``j < S`` with ``cdf[j] <= u``: the final knot
    counts as +inf, so a draw past ``cdf[-1]`` (rounding can leave the sum
    just under 1) falls in the last bin."""
    n_rays, n_bins = z_vals.shape
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)      # [N, S+1]

    if u is not None:
        if u.shape != (n_rays, n_importance):
            raise ValueError(f"u must be {(n_rays, n_importance)}, got {tuple(u.shape)}")
    elif deterministic:
        u = (torch.arange(n_importance, dtype=z_vals.dtype, device=z_vals.device)
             + 0.5) / n_importance
        u = u.expand(n_rays, n_importance).contiguous()
    else:
        if generator is None:
            raise ValueError("stochastic sample_pdf requires a torch.Generator")
        u = draw_uniforms(z_vals, n_importance, generator)

    below = torch.searchsorted(cdf[:, :n_bins].contiguous(), u, right=True) - 1
    below = below.clamp(0, n_bins - 1)
    above = (below + 1).clamp(max=n_bins - 1)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, below + 1)
    z_below = torch.gather(z_vals, 1, below)
    z_above = torch.gather(z_vals, 1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return z_below + t * (z_above - z_below)


def importance_sample(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = False,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical fine sampling: ``(points [N, S', 3], z [N, S'])`` with
    ``S' = S + n_importance``, the coarse and new depths merged and sorted
    (so adjacent differences stay valid distances). No gradient flows into
    the weights."""
    z_new = sample_pdf(z_vals, weights.detach(), n_importance,
                       generator=generator, deterministic=deterministic, u=u)
    z_all = torch.sort(torch.cat([z_vals, z_new], dim=-1), dim=-1).values
    points = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
    return points, z_all


def volume_render(
    sigma: torch.Tensor,
    rgb: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    cfg: RenderConfig = RenderConfig(),
    noise_generator: Optional[torch.Generator] = None,
) -> RenderOutputs:
    """Alpha-composite ``(sigma [N, S], rgb [N, S, 3])`` into per-ray maps.
    With a ``noise_generator`` and ``cfg.raw_noise_std > 0`` Gaussian noise
    of that deviation is added to the density first (training only)."""
    if noise_generator is not None and cfg.raw_noise_std > 0.0:
        sigma = sigma + cfg.raw_noise_std * torch.randn(
            sigma.shape, dtype=sigma.dtype, device=sigma.device, generator=noise_generator)
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


def normalized_depth(out: RenderOutputs, eps: float = 1e-6) -> torch.Tensor:
    """Expected depth normalized by accumulated opacity, ``sum(w z) /
    max(sum(w), eps)``: the documented depth of the reference, where
    ``RenderOutputs.depth`` is the unnormalized ``sum(w z)`` its code
    computes (background pixels read near the far plane, not 0)."""
    return out.depth / torch.clamp(out.acc, min=eps)
