"""Mip-NeRF 360's serving-mode frame in plain float32 PyTorch: the
benchmark's reference of the ``mip360`` variant.

google-research/multinerf, ``configs/360.gin`` (``internal/models.py``
``Model``, ``MLP``, ``PropMLP``, ``NerfMLP``; ``internal/coord.py``,
``internal/stepfun.py``, ``internal/render.py``, ``internal/geopoly.py``),
written again from the published code; it imports nothing of the port.
Products take operands rounded as the configuration states
(``nerf.Rounding``) and sum in float32; TF32 is off. Rays are the pinhole
rays of ``render.camera_rays`` (``d`` not normalized), base radius
``mip.radius``. Each frame is computed ``block`` rays at a time.

1. Warps: ``t(s) = 1 / (s s_far + (1 - s) s_near)``, ``s_near = 1 / near``,
   ``s_far = 1 / far`` in float32. Level 0 starts from the edges ``[0, 1]``
   and the weights ``[1]``; levels 0 and 1 are the proposal's at
   ``n_coarse`` intervals, level 2 the NeRF's at ``n_fine``
   (``N_PROP_LEVELS``).
2. Dilation before levels 1 and 2 (``max_dilate_weights``, the published
   mask over every pair of edge and interval, in blocks of rays):
   ``DILATION_BIAS + DILATION_MULTIPLIER / (product of the intervals of the
   levels before)``, renormalized, the first and last edge and weight
   dropped.
3. Sampling (``sample_intervals``, not jittered, the anneal at 1): logits
   ``log(w + resample_padding)`` where ``ds > 0``, else ``-inf``; the
   softmax's CDF ``[0, min(1, cumsum), 1]``; the centres by the published
   ``sorted_interp`` mask at ``linspace(1 / 2n, 1 - 1 / 2n - eps, n)``;
   edges at the midpoints, the ends reflected and clipped to ``[0, 1]``.
4. Gaussians: ``conical_frustum_to_gaussian`` in the stable form on
   ``s = t0 + t1``, ``dl = t1 - t0``, ``rho = dl^2 / max(eps^2, 3 s^2 +
   dl^2)``; ``lift_gaussian`` with the full covariance.
5. The contraction and its Jacobian, applied to the covariance ``J cov
   J^T``.
6. The encoding on the 21 directions of ``geopoly.generate_basis
   ('icosahedron', BASIS_SUBDIVISIONS)``: ``exp(-4^l var / 2) sin(2^l m)``, then the same at
   ``+ pi / 2``, degree-major, degrees ``ipe_min_deg .. ipe_max_deg - 1``;
   ``sin`` at full range reduction.
7. The networks (He-uniform weights, zero biases): the proposal
   ``prop_layers`` x (Dense ``prop_hidden_dim``, ReLU), density
   ``softplus(Dense_1 + density_bias)``; the NeRF ``n_layers`` x (Dense
   ``hidden_dim``, ReLU) with ``[h, enc]`` after layer ``skip_layer``,
   density as above, a bottleneck of ``bottleneck_dim``, ``[b, dir_enc(v)]``
   -> ``color_hidden_dim`` ReLU -> 3, rgb ``sigmoid * (1 + 2 pad) - pad``.
8. Compositing: ``tau = density (t1 - t0) |d|``, the last ``tau`` infinite;
   ``w = (1 - exp(-tau)) exp(-exclusive cumsum tau)``; rgb ``sum w c + (1 -
   sum w)``; depth the weights' mean of the midpoints, 0 / 0 read as 0,
   clipped to the first and last edge. The proposal levels keep ``w``.

Products of three terms (the Gaussian's mean, the Jacobian's products, the
basis projection) are summed in one order, ``((x0 + x1) + x2)``: the
contraction's Jacobian cancels terms of size ``2 / |x|`` into ``1 / |x|^2``
far from the scene, so a change of that order moves far intervals'
variances by more than the products' rounding.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from nerfbench.reference.mip import pos_enc, softplus
from nerfbench.reference.nerf import Rounding, disable_tf32
from nerfbench.reference.render import camera_rays

HALF_PI = 0.5 * math.pi
EPS = float(np.finfo(np.float32).eps)

# 360.gin's, fixed for the variant (the configuration file states them under
# ``published``)
N_PROP_LEVELS = 2
DILATION_BIAS, DILATION_MULTIPLIER = 0.0025, 0.5
BASIS_SUBDIVISIONS = 2


# -- the basis -----------------------------------------------------------------

def generate_basis(subdivisions: int = BASIS_SUBDIVISIONS, eps: float = 1e-4) -> np.ndarray:
    """``[3, n]`` float32: geopoly's icosahedron tessellated by
    ``subdivisions``, vertices merged in their first order, one of each
    antipodal pair, coordinates reversed, transposed."""
    a = (np.sqrt(5) + 1) / 2
    verts = np.array([(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a), (0, a, 1), (0, a, -1),
                      (0, -a, 1), (0, -a, -1), (a, 1, 0), (-a, 1, 0), (a, -1, 0),
                      (-a, -1, 0)]) / np.sqrt(a + 2)
    faces = np.array([(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1), (8, 10, 1),
                      (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3), (7, 10, 3), (7, 6, 10),
                      (7, 11, 6), (11, 0, 6), (0, 1, 6), (6, 1, 10), (9, 0, 11), (9, 11, 2),
                      (9, 2, 5), (7, 2, 11)])
    v = subdivisions
    weights = np.array([(i, j, v - (i + j)) for i in range(v + 1) for j in range(v + 1 - i)],
                       dtype=np.float64) / v
    new = []
    for face in faces:
        x = weights @ verts[face, :]
        new.append(x / np.sqrt(np.sum(x ** 2, 1, keepdims=True)))
    verts = np.concatenate(new, 0)

    def sq_dist(m0, m1):
        d = np.sum(m0 ** 2, 0)[:, None] + np.sum(m1 ** 2, 0)[None, :] - 2 * m0.T @ m1
        return np.maximum(0, d)

    assignment = np.array([np.min(np.argwhere(d <= eps)) for d in sq_dist(verts.T, verts.T)])
    verts = verts[np.unique(assignment), :]
    match = sq_dist(verts.T, -verts.T) < eps
    verts = verts[np.any(np.triu(match), axis=-1), :]
    return np.ascontiguousarray(verts[:, ::-1].T).astype(np.float32)


# -- the weights -----------------------------------------------------------------

def layer_shapes(model: dict) -> Dict[str, Dict[str, list]]:
    """``[fan_in, fan_out]`` of each layer of the proposal and NeRF networks."""
    n_b = generate_basis().shape[1]
    pos = 2 * n_b * (model["ipe_max_deg"] - model["ipe_min_deg"])
    dirs = 3 * (1 + 2 * model["dir_freqs"])
    ph, h, skip = model["prop_hidden_dim"], model["hidden_dim"], model["skip_layer"]
    return {
        "prop": {"trunk": [[pos if i == 0 else ph, ph] for i in range(model["prop_layers"])],
                 "density": [ph, 1]},
        "nerf": {"trunk": [[pos if i == 0 else h + (pos if i == skip + 1 else 0), h]
                           for i in range(model["n_layers"])],
                 "density": [h, 1], "bottleneck": [h, model["bottleneck_dim"]],
                 "color0": [model["bottleneck_dim"] + dirs, model["color_hidden_dim"]],
                 "color1": [model["color_hidden_dim"], 3]},
    }


def seeded_weights(model: dict, seed: int, device) -> dict:
    """``{'prop', 'nerf'}``, drawn on ``device`` from ``seed`` as multinerf's
    Dense layers start: every ``w`` uniform within ``sqrt(6 / fan_in)``
    (He uniform), every ``b`` zero; one draw, the proposal network first,
    layers in the sorted order of their names."""
    shapes = layer_shapes(model)
    flat = [s for net in ("prop", "nerf") for k in sorted(shapes[net])
            for s in (shapes[net][k] if k == "trunk" else [shapes[net][k]])]
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(a * b for a, b in flat), generator=g, device=device)
    it = iter(torch.split(draw, [a * b for a, b in flat]))

    def layer(shape):
        fan_in, fan_out = shape
        lim = math.sqrt(6.0 / fan_in)
        return {"w": ((next(it) * 2 - 1) * lim).view(fan_in, fan_out),
                "b": torch.zeros(fan_out, device=device)}

    return {net: {k: ([layer(s) for s in shapes[net][k]] if k == "trunk"
                      else layer(shapes[net][k])) for k in sorted(shapes[net])}
            for net in ("prop", "nerf")}


# -- 1. warps, 2. dilation, 3. sampling ------------------------------------------

def s_to_t(s, near: float, far: float):
    s_near = float(np.float32(1) / np.float32(near))
    s_far = float(np.float32(1) / np.float32(far))
    return 1.0 / (s * s_far + (1 - s) * s_near)


def max_dilate_weights(s, w, dilation: float):
    """The published mask form: ``[R, 3n + 1, n]`` comparisons."""
    eps2 = EPS * EPS
    p = w / torch.clamp(s[..., 1:] - s[..., :-1], min=eps2)
    t0 = s[..., :-1] - dilation
    t1 = s[..., 1:] + dilation
    e = torch.sort(torch.cat([s, t0, t1], dim=-1), dim=-1).values
    e = torch.clamp(e, 0.0, 1.0)
    mask = (t0[..., None, :] <= e[..., None]) & (t1[..., None, :] > e[..., None])
    p_d = torch.where(mask, p[..., None, :], torch.zeros((), device=p.device)).amax(dim=-1)
    p_d = p_d[..., :-1]
    w_d = p_d * (e[..., 1:] - e[..., :-1])
    w_d = w_d / torch.clamp(w_d.sum(dim=-1, keepdim=True), min=eps2)
    return e[..., 1:-1], w_d[..., 1:-1]


def sorted_interp(x, xp, fp):
    """multinerf's ``math.sorted_interp``."""
    mask = x[..., None, :] >= xp[..., :, None]

    def find_interval(v):
        v0 = torch.where(mask, v[..., None], v[..., :1, None]).amax(dim=-2)
        v1 = torch.where(~mask, v[..., None], v[..., -1:, None]).amin(dim=-2)
        return v0, v1

    fp0, fp1 = find_interval(fp)
    xp0, xp1 = find_interval(xp)
    offset = torch.clamp(torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0), 0, 1)
    return fp0 + offset * (fp1 - fp0)


def sample_intervals(s, w, n: int, padding: float):
    logits = torch.where(s[..., 1:] > s[..., :-1], torch.log(w + padding),
                         torch.full_like(w, -math.inf))
    pw = torch.softmax(logits, dim=-1)
    cw = torch.clamp(torch.cumsum(pw[..., :-1], dim=-1), max=1)
    zeros = torch.zeros(*cw.shape[:-1], 1, device=cw.device)
    cw = torch.cat([zeros, cw, zeros + 1], dim=-1)
    pad = 1 / (2 * n)
    u = torch.from_numpy(np.linspace(pad, 1.0 - pad - EPS, n, dtype=np.float64)
                         .astype(np.float32)).to(s.device).expand(*s.shape[:-1], n)
    centers = sorted_interp(u, cw, s)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=0.0)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=1.0)
    return torch.cat([first, mid, last], dim=-1)


# -- 4. Gaussians, 5. contraction, 6. encoding --------------------------------------

def gaussians(ro, rd, radius: float, t):
    """``(mean [R, S, 3], cov [R, S, 3, 3])`` of the intervals between the
    depths ``t [R, S + 1]``."""
    t0, t1 = t[..., :-1], t[..., 1:]
    s = t0 + t1
    dl = t1 - t0
    s2, d2 = s * s, dl * dl
    rho = d2 / torch.clamp(3 * s2 + d2, min=EPS * EPS)
    t_mean = s * (0.5 + rho)
    t_var = d2 / 12 - ((rho * rho) * (12 * s2 - d2)) / 15
    r = torch.tensor(radius, dtype=torch.float32, device=t.device)
    r_var = (r * r) * (s2 / 16 + d2 * (float(np.float32(5 / 48)) - rho / 15))
    d = rd[:, None, :]
    mean = d * t_mean[..., None] + ro[:, None, :]
    dd = d * d
    d_mag_sq = torch.clamp((dd[..., 0] + dd[..., 1]) + dd[..., 2], min=1e-10)
    eye = torch.eye(3, device=t.device)
    outer = d[..., :, None] * d[..., None, :]
    null_outer = eye - d[..., :, None] * (d / d_mag_sq[..., None])[..., None, :]
    cov = t_var[..., None, None] * outer + r_var[..., None, None] * null_outer
    return mean, cov


def _mm3(a, b):
    out = [[(a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]) + a[..., i, 2] * b[..., 2, j]
            for j in range(3)] for i in range(3)]
    return torch.stack([torch.stack(row, dim=-1) for row in out], dim=-2)


def contract(mean, cov):
    x_mag_sq = torch.clamp((mean[..., 0] * mean[..., 0] + mean[..., 1] * mean[..., 1])
                           + mean[..., 2] * mean[..., 2], min=EPS)
    q = torch.sqrt(x_mag_sq)
    outside = x_mag_sq > 1
    scale = torch.where(outside, (2 * q - 1) / x_mag_sq, torch.ones_like(q))
    slope = torch.where(outside, (2 * (1 - q)) / (x_mag_sq * x_mag_sq), torch.zeros_like(q))
    jac = (scale[..., None, None] * torch.eye(3, device=mean.device)
           + slope[..., None, None] * (mean[..., :, None] * mean[..., None, :]))
    return scale[..., None] * mean, _mm3(_mm3(jac, cov), jac.transpose(-1, -2))


def encode(mean, cov, basis, min_deg: int, max_deg: int):
    """``lift_and_diagonalize`` then ``integrated_pos_enc``."""
    b0, b1, b2 = basis[0], basis[1], basis[2]
    m = (mean[..., 0:1] * b0 + mean[..., 1:2] * b1) + mean[..., 2:3] * b2
    cb = [(cov[..., i, 0:1] * b0 + cov[..., i, 1:2] * b1) + cov[..., i, 2:3] * b2
          for i in range(3)]
    var = (b0 * cb[0] + b1 * cb[1]) + b2 * cb[2]
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=torch.float32,
                          device=mean.device)
    shape = list(m.shape[:-1]) + [-1]
    y = torch.reshape(m[..., None, :] * scales[:, None], shape)
    y_var = torch.reshape(var[..., None, :] * (scales * scales)[:, None], shape)
    x = torch.cat([y, y + HALF_PI], dim=-1)
    x_var = torch.cat([y_var, y_var], dim=-1)
    return torch.exp(-0.5 * x_var) * torch.sin(x)


# -- 7. networks, 8. compositing ----------------------------------------------------

def _dense(x, layer, rnd: Rounding):
    w = layer["w"]
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    return x @ w + layer["b"]


def prop_mlp(net, enc, model: dict, rnd: Rounding):
    x = enc
    for layer in net["trunk"]:
        x = torch.relu(_dense(x, layer, rnd))
    return softplus(_dense(x, net["density"], rnd)[..., 0] + model["density_bias"])


def nerf_mlp(net, enc, viewdirs, model: dict, rnd: Rounding):
    x = enc
    for i, layer in enumerate(net["trunk"]):
        x = torch.relu(_dense(x, layer, rnd))
        if i % model["skip_layer"] == 0 and i > 0:
            x = torch.cat([x, enc], dim=-1)
    density = softplus(_dense(x, net["density"], rnd)[..., 0] + model["density_bias"])
    bottleneck = _dense(x, net["bottleneck"], rnd)
    d_enc = pos_enc(viewdirs, 0, model["dir_freqs"])
    d_enc = d_enc[:, None, :].expand(*bottleneck.shape[:-1], d_enc.shape[-1])
    x = torch.relu(_dense(torch.cat([bottleneck, d_enc], dim=-1), net["color0"], rnd))
    pad = model["rgb_padding"]
    rgb = torch.sigmoid(_dense(x, net["color1"], rnd)) * (1 + 2 * pad) - pad
    return density, rgb


def alpha_weights(density, t, rd):
    delta = (t[..., 1:] - t[..., :-1]) * torch.linalg.norm(rd[:, None, :], dim=-1)
    dd = density * delta
    dd = torch.cat([dd[..., :-1], torch.full_like(dd[..., -1:], math.inf)], dim=-1)
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]),
                                  torch.cumsum(dd[..., :-1], dim=-1)], dim=-1))
    return alpha * trans


def composite(rgb, w, t):
    acc = w.sum(dim=-1)
    comp = (w[..., None] * rgb).sum(dim=-2) + (1 - acc[..., None])
    mids = 0.5 * (t[..., :-1] + t[..., 1:])
    depth = torch.nan_to_num((w * mids).sum(dim=-1) / acc, nan=0.0)
    return comp, torch.clamp(depth, t[:, 0], t[:, -1])


# -- rays -------------------------------------------------------------------------

def render_rays(nets, ro, rd, radius: float, model: dict, render: dict, rnd: Rounding,
                at_s=None):
    """``(rgb [R, 3], depth [R], levels)``: ``levels`` holds each level's own
    normalized edges ``s`` and the proposal levels' weights ``w``, and the
    NeRF level's raw ``(density, r, g, b)`` ``[R, S, 4]``; with ``at_s`` the
    NeRF level runs at those normalized edges instead of its own (``s``
    stays its own)."""
    R = ro.shape[0]
    basis = torch.from_numpy(generate_basis()).to(ro.device)
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    s = torch.tensor([0.0, 1.0], device=ro.device).expand(R, 2)
    w = torch.ones(R, 1, device=ro.device)
    n_levels = N_PROP_LEVELS + 1
    levels: List[dict] = []
    prod = 1
    for level in range(n_levels):
        is_prop = level < n_levels - 1
        n = render["n_coarse"] if is_prop else render["n_fine"]
        dilation = DILATION_BIAS + DILATION_MULTIPLIER / prod
        prod *= n
        if level > 0:
            s, w = max_dilate_weights(s, w, dilation)
        s = own = sample_intervals(s, w, n, render["resample_padding"])
        if not is_prop and at_s is not None:
            s = at_s
        t = s_to_t(s, render["near"], render["far"])
        mean, cov = gaussians(ro, rd, radius, t)
        mean, cov = contract(mean, cov)
        enc = encode(mean, cov, basis, model["ipe_min_deg"], model["ipe_max_deg"])
        if is_prop:
            density = prop_mlp(nets["prop"], enc, model, rnd)
            w = alpha_weights(density, t, rd)
            levels.append({"s": s, "w": w})
        else:
            density, rgb = nerf_mlp(nets["nerf"], enc, viewdirs, model, rnd)
            w = alpha_weights(density, t, rd)
            comp, depth = composite(rgb, w, t)
            levels.append({"s": own, "raw": torch.cat([density[..., None], rgb], dim=-1)})
    return comp, depth, levels


def probe(nets, ro, rd, radius: float, model: dict, render: dict, rnd: Rounding,
          at_s=None, block: int = 2048) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(level-1 proposal weights [R, n_coarse], NeRF normalized edges [R,
    n_fine + 1], NeRF raw [R, n_fine, 4])`` of the rays, the raw at ``at_s``
    (the NeRF level's normalized edges; its own where None)."""
    disable_tf32()
    outs = []
    with torch.no_grad():
        for i in range(0, ro.shape[0], block):
            _, _, lv = render_rays(nets, ro[i:i + block], rd[i:i + block], radius, model,
                                   render, rnd, None if at_s is None else at_s[i:i + block])
            outs.append((lv[1]["w"], lv[-1]["s"], lv[-1]["raw"]))
    return tuple(torch.cat(x) for x in zip(*outs))


def frame(nets, pose, width: int, height: int, focal: float, model: dict, render: dict,
          rnd: Rounding, block: int = 2048):
    """``(rgb [H, W, 3], depth [H, W])`` of one view, ``block`` rays at a
    time."""
    from nerfbench.reference.mip import radius

    disable_tf32()
    dev = nets["nerf"]["density"]["w"].device
    ro, rd = camera_rays(pose, width, height, focal, dev)
    rgbs, depths = [], []
    with torch.no_grad():
        for i in range(0, ro.shape[0], block):
            rgb, depth, _ = render_rays(nets, ro[i:i + block], rd[i:i + block], radius(focal),
                                        model, render, rnd)
            rgbs.append(rgb)
            depths.append(depth)
    return (torch.cat(rgbs).reshape(height, width, 3), torch.cat(depths).reshape(height, width))
