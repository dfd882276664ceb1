"""The coarse/fine hierarchical rendering pipeline.

Counterpart of ``nerf_tpu/render/pipeline.py``:

- coarse: ``rcfg.n_coarse`` stratified (optionally jittered) depths -> MLP
  -> composite;
- fine: ``rcfg.n_fine`` depths drawn by inverse CDF from the coarse weights,
  merged with the coarse depths and sorted (``rcfg.use_importance``), or
  ``rcfg.n_fine`` uniform depths (``use_importance=False``, the reference's
  uniform fine pass) -> MLP -> composite.

``apply_fn`` and ``composite_fn`` are injectable, so an engine swaps the
evaluator or the compositor without repeating the pipeline. Stochastic
draws come from one ``torch.Generator``, in this order: the jitter of the
coarse depths, the importance draws, the coarse pass's density noise, the
fine pass's density noise (the last two only with ``raw_noise_std > 0``);
for a ``RayShard`` of a batch, each draw is the whole batch's, of which the
shard keeps its rows (``utils/rendering.draw``).
The JAX package splits one key four ways instead, so the two packages'
stochastic renders agree in distribution, not draw for draw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.models.nerf import NeRFParams, apply_nerf
from nerf_tpu_torch.utils.rendering import (
    RayShard,
    RenderOutputs,
    draw_uniforms,
    importance_sample,
    sample_points_on_rays,
    volume_render,
)


class RayRenderResult(NamedTuple):
    coarse: RenderOutputs
    fine: RenderOutputs


def _eval_and_composite(params, points, z_vals, rays_d, mcfg, rcfg, compute_dtype,
                        noise_generator, apply_fn, composite_fn, shard) -> RenderOutputs:
    dirs = rays_d[..., None, :].expand(points.shape)
    sigma, rgb = apply_fn(params, points, dirs, mcfg, compute_dtype=compute_dtype)
    if composite_fn is not None and noise_generator is None:
        return composite_fn(sigma, rgb, z_vals, rays_d, rcfg)
    return volume_render(sigma, rgb, z_vals, rays_d, rcfg, noise_generator=noise_generator,
                         shard=shard)


def render_rays(
    params_coarse: NeRFParams,
    params_fine: NeRFParams,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mcfg: ModelConfig,
    rcfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    perturb: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    apply_fn=apply_nerf,
    composite_fn=None,
    shard: Optional[RayShard] = None,
) -> RayRenderResult:
    """Render a batch of rays through the coarse and fine networks.

    With ``perturb`` the coarse depths are jittered, and with a
    ``generator`` and ``rcfg.use_importance`` the fine depths are random
    draws; without a generator they are the deterministic midpoint draws.
    ``composite_fn`` (``fn(sigma, rgb, z, rays_d, rcfg) -> RenderOutputs``)
    replaces ``volume_render`` on unperturbed passes; perturbed passes use
    ``volume_render`` (with density noise where ``rcfg.raw_noise_std > 0``),
    as the JAX pipeline does. With a ``shard`` the rays are that shard of a
    batch, and every draw is the whole batch's, of which it keeps its rows."""
    if perturb and generator is None:
        raise ValueError("perturb=True requires a torch.Generator")
    noise_generator = generator if perturb else None

    pts_c, z_c = sample_points_on_rays(rays_o, rays_d, rcfg.near, rcfg.far,
                                       rcfg.n_coarse, perturb=perturb,
                                       generator=generator, shard=shard)
    u = None
    if rcfg.use_importance and generator is not None:
        u = draw_uniforms(z_c, rcfg.n_fine, generator, shard)   # before any density noise
    coarse = _eval_and_composite(params_coarse, pts_c, z_c, rays_d, mcfg, rcfg,
                                 compute_dtype, noise_generator, apply_fn, composite_fn, shard)

    if rcfg.use_importance:
        pts_f, z_f = importance_sample(rays_o, rays_d, z_c, coarse.weights,
                                       rcfg.n_fine, deterministic=generator is None, u=u)
    else:
        pts_f, z_f = sample_points_on_rays(rays_o, rays_d, rcfg.near, rcfg.far,
                                           rcfg.n_fine)
    fine = _eval_and_composite(params_fine, pts_f, z_f, rays_d, mcfg, rcfg,
                               compute_dtype, noise_generator, apply_fn, composite_fn, shard)
    return RayRenderResult(coarse=coarse, fine=fine)
