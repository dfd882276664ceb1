"""Mip-NeRF's serving-mode frame in plain float32 PyTorch: the benchmark's
reference of the ``mip`` variant.

google/mipnerf, Blender configuration (``internal/models.py`` ``MipNerfModel``
and ``MLP``, ``internal/mip.py``, ``internal/math.py``,
``internal/datasets.py``), written again from the published code, each
operation in its order; it imports nothing of the port. Products take
operands rounded as the configuration states (``nerf.Rounding``) and sum in
float32; TF32 is off.

- Rays: the pinhole rays of ``render.camera_rays``; base radius ``(2 /
  sqrt(12)) dx``, ``dx = 1 / focal`` the distance between neighbouring
  rays' directions (``radius``); unit view directions ``d / ||d||``.
- Frustums: ``conical_frustum_to_gaussian`` (the stable form),
  ``lift_gaussian`` (diagonal), the intervals between ``S + 1`` edges.
- The integrated positional encoding at degrees ``ipe_min_deg ..
  ipe_max_deg - 1``: ``exp(-y_var / 2) sin(y)`` and ``exp(-y_var / 2)
  sin(y + pi / 2)``, degree-major, sines first. ``sin`` at full range
  reduction, not the published ``safe_sin`` (which folds phases of ``100
  pi`` and more into ``[0, 100 pi)`` because a TPU's ``sin`` loses accuracy
  there; the two differ by under 1e-3 where the attenuation is not zero).
- The MLP: 8 x 256 ReLU, ``[h, enc]`` after layer ``skip_layer``, density
  ``softplus(raw + density_bias)``, a bottleneck without activation, ``[b,
  pos_enc(viewdirs)]`` -> 128 ReLU -> 3, rgb ``sigmoid * (1 + 2 pad) -
  pad``; one network for both passes.
- ``volumetric_rendering``: ``delta = (t1 - t0) ||d||``, ``w = (1 -
  exp(-density delta)) exp(-exclusive cumsum)``, depth the weights' mean of
  the midpoints, clipped to the first and last edge (the published
  ``nan_to_num(x, inf)`` passes ``inf`` as ``copy``, so a 0 / 0 depth reads
  0 and clips to the first edge), the white background ``+ (1 - acc)``.
- ``resample_along_rays`` over ``sorted_piecewise_constant_pdf``, not
  randomized: the weights max-pooled by 2, averaged by 2, plus the padding;
  the CDF's interval of each draw found by the published mask (a block of
  rays at a time).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from nerfbench.reference.nerf import Rounding, disable_tf32
from nerfbench.reference.render import camera_rays

HALF_PI = 0.5 * math.pi


def radius(focal: float) -> float:
    """The base radius of a pixel's cone, in float32."""
    return float(np.float32(2.0 / math.sqrt(12.0) / focal))


def layer_shapes(model: dict) -> Dict[str, list]:
    """``[fan_in, fan_out]`` of each layer of the network."""
    pos = 6 * (model["ipe_max_deg"] - model["ipe_min_deg"])
    dirs = 3 * (1 + 2 * model["dir_freqs"])
    h, skip = model["hidden_dim"], model["skip_layer"]
    return {"trunk": [[pos if i == 0 else h + (pos if i == skip + 1 else 0), h]
                      for i in range(model["n_layers"])],
            "density": [h, 1], "bottleneck": [h, h],
            "color0": [h + dirs, model["color_hidden_dim"]],
            "color1": [model["color_hidden_dim"], 3]}


def seeded_weights(model: dict, seed: int, device) -> dict:
    """The one network, drawn on ``device`` from ``seed`` as the published
    Dense layers start: every ``w`` uniform within ``sqrt(6 / (fan_in +
    fan_out))`` (Glorot uniform), every ``b`` zero; one draw, layers in the
    sorted order of their names."""
    shapes = layer_shapes(model)
    flat = [s for k in sorted(shapes) for s in (shapes[k] if k == "trunk" else [shapes[k]])]
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(a * b for a, b in flat), generator=g, device=device)
    it = iter(torch.split(draw, [a * b for a, b in flat]))

    def layer(shape):
        fan_in, fan_out = shape
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return {"w": ((next(it) * 2 - 1) * lim).view(fan_in, fan_out),
                "b": torch.zeros(fan_out, device=device)}

    return {k: ([layer(s) for s in shapes[k]] if k == "trunk" else layer(shapes[k]))
            for k in sorted(shapes)}


def conical_frustum_to_gaussian(t0, t1, base_radius):
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * (hw * hw)) / (3 * (mu * mu) + hw * hw)
    t_var = (hw * hw) / 3 - (4 / 15) * (((hw * hw) * (hw * hw) * (12 * (mu * mu) - hw * hw))
                                        / ((3 * (mu * mu) + hw * hw) * (3 * (mu * mu) + hw * hw)))
    r_var = (base_radius * base_radius) * ((mu * mu) / 4 + (5 / 12) * (hw * hw)
                                           - 4 / 15 * ((hw * hw) * (hw * hw))
                                           / (3 * (mu * mu) + hw * hw))
    return t_mean, t_var, r_var


def lift_gaussian(d, t_mean, t_var, r_var):
    mean = d[..., None, :] * t_mean[..., None]
    d2 = d * d
    d_mag_sq = torch.clamp(d2[..., 0:1] + d2[..., 1:2] + d2[..., 2:3], min=1e-10)
    null_outer = 1 - d2 / d_mag_sq
    cov = t_var[..., None] * d2[..., None, :] + r_var[..., None] * null_outer[..., None, :]
    return mean, cov


def cast(ro, rd, base_radius, t_vals):
    """``(mean, cov)`` of the intervals between ``t_vals [R, S + 1]``."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    mean, cov = lift_gaussian(rd, *conical_frustum_to_gaussian(t0, t1, base_radius[..., None]))
    return mean + ro[..., None, :], cov


def integrated_pos_enc(mean, cov, min_deg: int, max_deg: int):
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=torch.float32,
                          device=mean.device)
    shape = list(mean.shape[:-1]) + [-1]
    y = torch.reshape(mean[..., None, :] * scales[:, None], shape)
    y_var = torch.reshape(cov[..., None, :] * (scales * scales)[:, None], shape)
    x = torch.cat([y, y + HALF_PI], dim=-1)
    x_var = torch.cat([y_var, y_var], dim=-1)
    return torch.exp(-0.5 * x_var) * torch.sin(x)


def pos_enc(x, min_deg: int, max_deg: int):
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=torch.float32,
                          device=x.device)
    xb = torch.reshape(x[..., None, :] * scales[:, None], list(x.shape[:-1]) + [-1])
    four_feat = torch.sin(torch.cat([xb, xb + HALF_PI], dim=-1))
    return torch.cat([x, four_feat], dim=-1)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _dense(x, layer, rnd: Rounding):
    w = layer["w"]
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    return x @ w + layer["b"]


def mlp(net: dict, enc, viewdirs, model: dict, rnd: Rounding):
    """``(density [R, S], rgb [R, S, 3])`` on the IPE ``enc [R, S, F]``."""
    x = enc
    for i, layer in enumerate(net["trunk"]):
        x = torch.relu(_dense(x, layer, rnd))
        if i % model["skip_layer"] == 0 and i > 0:
            x = torch.cat([x, enc], dim=-1)
    raw_density = _dense(x, net["density"], rnd)[..., 0]
    bottleneck = _dense(x, net["bottleneck"], rnd)
    cond = pos_enc(viewdirs, 0, model["dir_freqs"])
    cond = cond[:, None, :].expand(*bottleneck.shape[:-1], cond.shape[-1])
    x = torch.relu(_dense(torch.cat([bottleneck, cond], dim=-1), net["color0"], rnd))
    raw_rgb = _dense(x, net["color1"], rnd)
    pad = model["rgb_padding"]
    rgb = torch.sigmoid(raw_rgb) * (1 + 2 * pad) - pad
    return softplus(raw_density + model["density_bias"]), rgb


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd: bool):
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2)
    acc = weights.sum(dim=-1)
    distance = (weights * t_mids).sum(dim=-1) / acc
    distance = torch.clamp(torch.nan_to_num(distance, nan=0.0), t_vals[:, 0], t_vals[:, -1])
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, distance, acc, weights


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int):
    eps = 1e-5
    weight_sum = weights.sum(dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)
    u = torch.linspace(0.0, 1.0 - float(torch.finfo(torch.float32).eps), num_samples,
                       dtype=torch.float32).to(bins.device)
    u = u.expand(*cdf.shape[:-1], num_samples)
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.where(mask, x[..., None], x[..., :1, None]).amax(dim=-2)
        x1 = torch.where(~mask, x[..., None], x[..., -1:, None]).amin(dim=-2)
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(t_vals, weights, resample_padding: float):
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    return sorted_piecewise_constant_pdf(t_vals, weights_blur + resample_padding,
                                         t_vals.shape[-1])


def render_rays(net: dict, ro, rd, base_radius: float, model: dict, render: dict,
                rnd: Rounding, n_samples: Optional[int] = None):
    """``(rgb [R, 3], depth [R])`` of the fine pass (of the coarse pass at
    ``n_samples`` intervals where given), and the fine edges (or None)."""
    n_rays = ro.shape[0]
    n = n_samples or render["n_coarse"]
    t = torch.linspace(0.0, 1.0, n + 1, dtype=torch.float32).to(ro.device)
    t_vals = (render["near"] * (1.0 - t) + render["far"] * t).expand(n_rays, n + 1)
    r = torch.full((n_rays,), base_radius, dtype=torch.float32, device=ro.device)
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    lo, hi = model["ipe_min_deg"], model["ipe_max_deg"]
    fine_edges = None
    for level in range(1 if n_samples else 2):
        if level == 1:
            t_vals = resample_along_rays(t_vals, weights, render["resample_padding"])
            fine_edges = t_vals
        mean, cov = cast(ro, rd, r, t_vals)
        density, rgb = mlp(net, integrated_pos_enc(mean, cov, lo, hi), viewdirs, model, rnd)
        comp_rgb, distance, _, weights = volumetric_rendering(
            rgb, density, t_vals, rd, render["white_background"])
    return comp_rgb, distance, fine_edges


def fine_pass(net: dict, ro, rd, base_radius: float, model: dict, render: dict,
              rnd: Rounding, at=None):
    """``(edges [R, S + 1], density [R, S], rgb [R, S, 3])``: the fine edges
    of the rays and the network at the edges ``at`` (the fine edges where
    None)."""
    _, _, edges = render_rays(net, ro, rd, base_radius, model, render, rnd)
    at = edges if at is None else at
    r = torch.full((ro.shape[0],), base_radius, dtype=torch.float32, device=ro.device)
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    mean, cov = cast(ro, rd, r, at)
    enc = integrated_pos_enc(mean, cov, model["ipe_min_deg"], model["ipe_max_deg"])
    density, rgb = mlp(net, enc, viewdirs, model, rnd)
    return edges, density, rgb


def frame(net: dict, pose, width: int, height: int, focal: float, model: dict, render: dict,
          rnd: Rounding, n_samples: Optional[int] = None, block: int = 4096):
    """``(rgb [H, W, 3], depth [H, W])`` of one view, ``block`` rays at a
    time."""
    disable_tf32()
    dev = net["density"]["w"].device
    ro, rd = camera_rays(pose, width, height, focal, dev)
    rgbs, depths = [], []
    with torch.no_grad():
        for i in range(0, ro.shape[0], block):
            rgb, depth, _ = render_rays(net, ro[i:i + block], rd[i:i + block], radius(focal),
                                        model, render, rnd, n_samples)
            rgbs.append(rgb)
            depths.append(depth)
    return (torch.cat(rgbs).reshape(height, width, 3), torch.cat(depths).reshape(height, width))
