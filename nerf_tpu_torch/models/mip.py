"""Mip-NeRF (Barron et al., ICCV 2021) as plain functions: the port's plain
path of the ``mip`` variant (``TorchEngine``) and the arithmetic the mip ray
kernels' plain versions (``ops/render_kernel.py``) repeat.

google/mipnerf (``internal/models.py`` ``MipNerfModel`` and ``MLP``,
``internal/mip.py``), Blender configuration. Each sample is an interval
``[t_i, t_{i+1}]`` of the pixel's cone, encoded by the integrated positional
encoding of its Gaussian (``models/encoding.py``); one network serves the
coarse pass at ``n_coarse`` uniform intervals and the fine pass at the
``n_fine`` intervals ``utils/rendering.mip_resample`` draws from the coarse
weights; ``utils/rendering.composite_intervals`` composites each pass.

The network has bmild's layout (``models/nerf.py``) on the IPE: an 8 x 256
ReLU trunk with ``[h, enc]`` after layer ``skip_layer``, density
``softplus(raw + density_bias)``, a bottleneck without activation, ``[b,
dir_enc]`` -> 128 ReLU -> 3, rgb ``sigmoid * (1 + 2 pad) - pad``. Params are
the port's layout, with ``'bottleneck'``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.models.encoding import cast_intervals, integrated_pos_enc, mip_dir_encoding
from nerf_tpu_torch.models.nerf import NeRFParams, _dense
from nerf_tpu_torch.utils.device import disable_tf32
from nerf_tpu_torch.utils.rendering import (
    RenderOutputs,
    composite_intervals,
    mip_resample,
    uniform_edges,
)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def apply_mip(params: NeRFParams, enc: torch.Tensor, viewdirs: torch.Tensor,
              cfg: ModelConfig, compute_dtype: torch.dtype = torch.float32):
    """The network on IPE features ``enc [R, S, F]`` of rays seen along unit
    ``viewdirs [R, 3]``: ``(density [R, S], rgb [R, S, 3])``. A bf16 compute
    dtype rounds each product's operands and sums in float32."""
    disable_tf32()
    x = enc
    for i, layer in enumerate(params["trunk"]):
        x = torch.relu(_dense(x, layer, compute_dtype))
        if i == cfg.skip_layer:
            x = torch.cat([x, enc], dim=-1)
    density = softplus(_dense(x, params["density"], compute_dtype)[..., 0] + cfg.density_bias)
    feat = _dense(x, params["bottleneck"], compute_dtype)
    d_enc = mip_dir_encoding(viewdirs, cfg.dir_freqs)[:, None, :].expand(
        *feat.shape[:-1], -1)
    c = torch.relu(_dense(torch.cat([feat, d_enc], dim=-1), params["color0"], compute_dtype))
    rgb = torch.sigmoid(_dense(c, params["color1"], compute_dtype))
    rgb = rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding
    return density, rgb


def render_intervals(params: NeRFParams, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     radius: torch.Tensor, edges: torch.Tensor, cfg: ModelConfig,
                     rcfg: RenderConfig, compute_dtype: torch.dtype = torch.float32
                     ) -> RenderOutputs:
    """One pass of the network at the intervals ``edges [R, S + 1]``,
    composited."""
    mean, cov = cast_intervals(rays_o, rays_d, radius, edges)
    enc = integrated_pos_enc(mean, cov, cfg.ipe_min_deg, cfg.ipe_max_deg)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    density, rgb = apply_mip(params, enc, viewdirs, cfg, compute_dtype)
    return composite_intervals(density, rgb, edges, rays_d, rcfg.white_background)


class MipOutputs(NamedTuple):
    coarse: RenderOutputs
    fine: Optional[RenderOutputs]


def render_mip_rays(params: NeRFParams, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    radius: float, cfg: ModelConfig, rcfg: RenderConfig,
                    compute_dtype: torch.dtype = torch.float32,
                    n_samples: Optional[int] = None) -> MipOutputs:
    """Serving-mode Mip-NeRF on rays ``[R, 3]`` of base radius ``radius``:
    the coarse pass at ``n_coarse`` uniform intervals (``n_samples`` of
    them and no fine pass where given), the resample, the fine pass at
    ``n_fine`` intervals (``n_fine`` must equal ``n_coarse``: the resample
    keeps the number of edges)."""
    rays_o, rays_d = rays_o.float(), rays_d.float()
    n_c = n_samples or rcfg.n_coarse
    if n_samples is None and rcfg.n_fine != rcfg.n_coarse:
        raise ValueError(f"Mip-NeRF resamples as many intervals as the coarse pass has: "
                         f"n_fine {rcfg.n_fine} != n_coarse {rcfg.n_coarse}")
    r = torch.full((rays_o.shape[0],), radius, dtype=torch.float32, device=rays_o.device)
    edges = uniform_edges(rcfg.near, rcfg.far, n_c + 1, rays_o.device).expand(
        rays_o.shape[0], n_c + 1)
    coarse = render_intervals(params, rays_o, rays_d, r, edges, cfg, rcfg, compute_dtype)
    if n_samples is not None:
        return MipOutputs(coarse, None)
    edges = mip_resample(edges, coarse.weights, rcfg.resample_padding)
    return MipOutputs(coarse, render_intervals(params, rays_o, rays_d, r, edges, cfg, rcfg,
                                               compute_dtype))
