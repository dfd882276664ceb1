"""Mip-NeRF 360 (Barron et al., CVPR 2022) as plain functions: the port's
plain path of the ``mip360`` variant (``TorchEngine``) and the arithmetic the
variant's kernels' plain versions repeat.

google-research/multinerf, ``configs/360.gin``: ``Model``, ``MLP``,
``PropMLP`` and ``NerfMLP`` (``internal/models.py``), with
``internal/coord.py``, ``internal/stepfun.py``, ``internal/render.py`` and
``internal/geopoly.py``; serving mode (no jitter, the anneal at 1). A ray's
normalized distance ``s`` in ``[0, 1]`` maps to metric depth in disparity
spacing (``utils/rendering.s_to_t``). Three levels: two proposal levels of
``n_coarse`` intervals each and the NeRF level of ``n_fine``; each level's
intervals are drawn from the level before's weights (the first from one
interval of weight 1, ``utils/rendering.first_level_360``), the step
function dilated before every level but the first (``resample_360``). The
level count, the dilation and the opaque last interval are 360.gin's and
fixed here. An interval is a full-covariance
Gaussian of its cone's frustum, contracted (``contract_gaussian``) and
encoded by its integrated positional encoding on the icosahedral basis
(``models/encoding.encode_intervals_360``).

Two networks. The proposal network (params ``'coarse'``; one network for
both proposal levels): ``prop_layers`` x (Dense ``prop_hidden_dim``, ReLU)
on the encoding, density ``softplus(Dense_1 + density_bias)``. The NeRF
network (params ``'fine'``): ``models/mip.apply_mip``'s layout at
``hidden_dim`` (an 8 x 1,024 trunk, ``[h, enc]`` after layer
``skip_layer``), a bottleneck of ``bottleneck_dim``, ``[b, dir_enc(v)]`` ->
``color_hidden_dim`` ReLU -> 3. Weights are He-uniform, biases zero
(multinerf's ``weight_init``). Compositing: the last interval opaque, the
background 1; the proposal levels keep only their weights.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.models.encoding import encode_intervals_360
from nerf_tpu_torch.models.mip import apply_mip, softplus
from nerf_tpu_torch.models.nerf import NeRFParams, _dense
from nerf_tpu_torch.utils.device import disable_tf32, resolve_device
from nerf_tpu_torch.utils.rendering import (
    RenderOutputs,
    composite_intervals,
    first_level_360,
    max_dilate_weights,
    s_to_t,
    sample_intervals,
)

N_PROP_LEVELS = 2         # proposal levels before the NeRF level
DILATION_BIAS = 0.0025    # a level's step function is dilated by DILATION_BIAS
DILATION_MULTIPLIER = 0.5  # + DILATION_MULTIPLIER / (the intervals of the levels before)


def layer_shapes(cfg: ModelConfig) -> dict:
    """``[fan_in, fan_out]`` of each layer: ``{'coarse': proposal, 'fine':
    NeRF}``."""
    pos, dirs = cfg.pos_dim, cfg.dir_dim
    ph, h = cfg.prop_hidden_dim, cfg.hidden_dim
    prop = {"trunk": [[pos if i == 0 else ph, ph] for i in range(cfg.prop_layers)],
            "density": [ph, 1]}
    nerf = {"trunk": [[pos if i == 0 else h + (pos if i == cfg.skip_layer + 1 else 0), h]
                      for i in range(cfg.n_layers)],
            "density": [h, 1], "bottleneck": [h, cfg.bottleneck_dim],
            "color0": [cfg.bottleneck_dim + dirs, cfg.color_hidden_dim],
            "color1": [cfg.color_hidden_dim, 3]}
    return {"coarse": prop, "fine": nerf}


def init_mip360_params(generator: torch.Generator, cfg: ModelConfig,
                       device="cuda") -> dict:
    """He-uniform weights (``U(-sqrt(6 / fan_in), sqrt(6 / fan_in))``), zero
    biases, drawn on the CPU from ``generator``, then moved to ``device``:
    ``{'coarse': proposal, 'fine': NeRF}``."""
    dev = resolve_device(device)

    def layer(shape):
        fan_in, fan_out = shape
        lim = math.sqrt(6.0 / fan_in)
        w = (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * lim
        return {"w": w.to(dev), "b": torch.zeros(fan_out, device=dev)}

    return {net: {k: [layer(s) for s in v] if k == "trunk" else layer(v)
                  for k, v in sorted(shapes.items())}
            for net, shapes in layer_shapes(cfg).items()}


def apply_prop(params: NeRFParams, enc: torch.Tensor, cfg: ModelConfig,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The proposal network on encodings ``enc [..., F]``: ``density [...]``."""
    disable_tf32()
    x = enc
    for layer in params["trunk"]:
        x = torch.relu(_dense(x, layer, compute_dtype))
    return softplus(_dense(x, params["density"], compute_dtype)[..., 0] + cfg.density_bias)


class Mip360Outputs(NamedTuple):
    out: RenderOutputs           # the NeRF level, composited
    s_edges: List[torch.Tensor]  # each level's normalized edges [R, n + 1]
    weights: List[torch.Tensor]  # each proposal level's weights [R, n]


def level_sizes(rcfg: RenderConfig) -> List[int]:
    """The intervals of each level: the proposal levels', then the NeRF's."""
    return [rcfg.n_coarse] * N_PROP_LEVELS + [rcfg.n_fine]


def resample_360(s: torch.Tensor, w: torch.Tensor, n: int, prod: int,
                 rcfg: RenderConfig) -> torch.Tensor:
    """The normalized edges ``[R, n + 1]`` of a level after the first from
    the level before's ``(s, w)``: the step function dilated by
    ``DILATION_BIAS + DILATION_MULTIPLIER / prod`` (``prod``: the product of
    the intervals of the levels before), then ``n`` intervals drawn
    (``sample_intervals``, padding ``resample_padding``)."""
    s, w = max_dilate_weights(s, w, DILATION_BIAS + DILATION_MULTIPLIER / prod)
    return sample_intervals(s, w, n, rcfg.resample_padding)


def render_mip360_rays(params: dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
                       radius: float, cfg: ModelConfig, rcfg: RenderConfig,
                       compute_dtype: torch.dtype = torch.float32) -> Mip360Outputs:
    """Serving-mode Mip-NeRF 360 on rays ``[R, 3]`` of base radius ``radius``
    (``params``: ``{'coarse': proposal, 'fine': NeRF}``)."""
    rays_o, rays_d = rays_o.float(), rays_d.float()
    R = rays_o.shape[0]
    r = torch.full((R,), radius, dtype=torch.float32, device=rays_o.device)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    sizes = level_sizes(rcfg)
    s_edges, weights, prod, w = [], [], 1, None
    for level, n in enumerate(sizes):
        s = (first_level_360(n, R, rays_o.device) if level == 0
             else resample_360(s, w, n, prod, rcfg))
        prod *= n
        t = s_to_t(s, rcfg.near, rcfg.far)
        enc = encode_intervals_360(rays_o, rays_d, r, t, cfg.ipe_min_deg, cfg.ipe_max_deg)
        s_edges.append(s)
        if level < len(sizes) - 1:
            density = apply_prop(params["coarse"], enc, cfg, compute_dtype)
            rgb = density.new_zeros(*density.shape, 3)
            w = composite_intervals(density, rgb, t, rays_d, False, opaque=True).weights
            weights.append(w)
        else:
            density, rgb = apply_mip(params["fine"], enc, viewdirs, cfg, compute_dtype)
            out = composite_intervals(density, rgb, t, rays_d, rcfg.white_background,
                                      opaque=True)
    return Mip360Outputs(out, s_edges, weights)
