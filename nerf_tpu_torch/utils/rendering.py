"""Volume-rendering math in plain PyTorch.

Counterpart of ``nerf_tpu/utils/rendering.py``: uniform (optionally
jittered) depths ``z = near*(1-t) + far*t``; hierarchical inverse-CDF
sampling from coarse weights (``sample_pdf``, ``importance_sample``); and
the compositor with a 1e10 sentinel last distance scaled by ``||d||``,
``alpha = 1 - exp(-relu(sigma) * dist)`` and exclusive cumulative-product
transmittance with a ``+1e-10`` epsilon, with optional density noise during
training; ``normalized_depth`` divides a map's depth by its opacity.
Mip-NeRF's intervals (google/mipnerf, internal/mip.py): ``uniform_edges``,
``composite_intervals`` (``volumetric_rendering``) and ``mip_resample``
(``resample_along_rays`` over ``sorted_piecewise_constant_pdf``).
Mip-NeRF 360's proposal sampling (google-research/multinerf,
internal/stepfun.py and the ray warps of internal/coord.py), as ATen glue
on ``[R, K]`` rows: ``s_to_t`` (disparity spacing), ``max_dilate_weights``
and ``sample_intervals``.

A ``RayShard`` names one of ``count`` equal, contiguous row blocks of a
batch of rays (``parallel/``: a rank's share of the data axis). The
stochastic functions take one: they draw for the whole batch from the
generator every rank holds alike, and keep the shard's rows, so the
shards of one step together draw exactly what the unsharded step draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerf_tpu_torch.config import RenderConfig


class RayShard(NamedTuple):
    index: int     # which block of rows
    count: int     # of how many equal blocks

    def rows(self, n_local: int) -> slice:
        """This shard's rows of the whole batch, ``n_local`` rows a shard."""
        return slice(self.index * n_local, (self.index + 1) * n_local)


def draw(shape, generator: torch.Generator, dtype=torch.float32, device=None,
         shard: Optional[RayShard] = None, normal: bool = False) -> torch.Tensor:
    """``torch.rand`` (``torch.randn`` if ``normal``) of ``shape``; with a
    ``shard``, ``shape`` is the shard's and the draw is the whole batch's
    (``shape[0] * count`` rows), of which the shard's rows are kept."""
    fn = torch.randn if normal else torch.rand
    if shard is None:
        return fn(shape, dtype=dtype, device=device, generator=generator)
    full = fn((shape[0] * shard.count, *shape[1:]), dtype=dtype, device=device,
              generator=generator)
    return full[shard.rows(shape[0])]


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
    shard: Optional[RayShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(points [N, S, 3], z_vals [N, S])``. With ``perturb`` each
    depth is jittered uniformly within its stratum; the draws come from
    ``generator`` (which must live on the rays' device), the whole batch's
    where the rays are a ``shard`` of it."""
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
        t_rand = draw(z_vals.shape, generator, z_vals.dtype, z_vals.device, shard)
        z_vals = lower + (upper - lower) * t_rand
    points = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return points, z_vals


def draw_uniforms(z_vals: torch.Tensor, n_importance: int,
                  generator: torch.Generator, shard: Optional[RayShard] = None) -> torch.Tensor:
    """``sample_pdf``'s random draws ``[N, n_importance]`` in [0, 1) (the
    shard's rows of the whole batch's draws)."""
    return draw((z_vals.shape[0], n_importance), generator, z_vals.dtype, z_vals.device, shard)


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


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of a tensor without zeros. Its
    backward is ATen's for an input without zeros (the reversed cumulative
    sum of ``output * grad``, over the input), without ATen's test for
    zeros first: that test reads a flag back to the host, which a CUDA graph
    of a train step (``make_multi_train_step``) cannot capture."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] == 1:
            return grad
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def volume_render(
    sigma: torch.Tensor,
    rgb: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    cfg: RenderConfig = RenderConfig(),
    noise_generator: Optional[torch.Generator] = None,
    shard: Optional[RayShard] = None,
) -> RenderOutputs:
    """Alpha-composite ``(sigma [N, S], rgb [N, S, 3])`` into per-ray maps.
    With a ``noise_generator`` and ``cfg.raw_noise_std > 0`` Gaussian noise
    of that deviation is added to the density first (training only; the
    shard's rows of the whole batch's noise)."""
    if noise_generator is not None and cfg.raw_noise_std > 0.0:
        sigma = sigma + cfg.raw_noise_std * draw(
            sigma.shape, noise_generator, sigma.dtype, sigma.device, shard, normal=True)
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], cfg.dist_sentinel)],
                      dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    factors = 1.0 - alpha + cfg.transmittance_eps
    if cfg.transmittance_eps >= torch.finfo(factors.dtype).tiny:   # every factor > 0
        trans = _PositiveCumprod.apply(factors)
    else:
        trans = torch.cumprod(factors, dim=-1)
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


# -- Mip-NeRF's intervals -----------------------------------------------------

_RESAMPLE_U = {}


def uniform_edges(near: float, far: float, n_edges: int, device) -> torch.Tensor:
    """``[n_edges]`` float32 depths ``near (1 - t) + far t`` at ``t = k /
    (n_edges - 1)``: the coarse intervals' edges (not jittered)."""
    # a division by a tensor: a CUDA division by a host scalar multiplies by its
    # reciprocal, which can differ from the kernels' quotient in the last bit
    t = torch.arange(n_edges, dtype=torch.float32, device=device) / torch.full(
        (), n_edges - 1, dtype=torch.float32, device=device)
    return near * (1 - t) + far * t


def composite_intervals(density: torch.Tensor, rgb: torch.Tensor, edges: torch.Tensor,
                        rays_d: torch.Tensor, white_background: bool,
                        opaque: bool = False) -> RenderOutputs:
    """Interval compositing of ``(density [N, S], rgb [N, S, 3])`` between
    ``edges [N, S + 1]``: ``delta = (t1 - t0) ||d||``, ``w = (1 - exp(-density
    delta)) exp(-exclusive cumsum of density delta)``; depth is the weights'
    mean of the midpoints, 0 / 0 read as 0, clipped to the first and last
    edge. ``opaque``: the last interval's ``density delta`` is infinite (its
    alpha 1: multinerf's ``opaque_background``)."""
    mids = 0.5 * (edges[:, :-1] + edges[:, 1:])
    delta = (edges[:, 1:] - edges[:, :-1]) * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    sd = density * delta
    if opaque:
        sd = torch.cat([sd[:, :-1], torch.full_like(sd[:, -1:], float("inf"))], dim=-1)
    alpha = 1 - torch.exp(-sd)
    trans = torch.exp(-torch.cat([torch.zeros_like(sd[:, :1]),
                                  torch.cumsum(sd[:, :-1], dim=-1)], dim=-1))
    w = alpha * trans
    rgb_map = (w[..., None] * rgb).sum(dim=-2)
    acc = w.sum(dim=-1)
    depth = torch.nan_to_num((w * mids).sum(dim=-1) / acc, nan=0.0)
    depth = torch.minimum(torch.maximum(depth, edges[:, 0]), edges[:, -1])
    if white_background:
        rgb_map = rgb_map + (1 - acc[..., None])
    return RenderOutputs(rgb_map, depth, acc, w)


def _resample_u(n: int, device) -> torch.Tensor:
    """``linspace(0, 1 - eps_f32, n)``, the draws of a serving-mode
    resample, made on the host once per device (the same bits on every
    device)."""
    key = (n, torch.device(device))
    if key not in _RESAMPLE_U:
        eps = float(torch.finfo(torch.float32).eps)
        _RESAMPLE_U[key] = torch.linspace(0.0, 1.0 - eps, n, dtype=torch.float32).to(device)
    return _RESAMPLE_U[key]


def mip_resample(edges: torch.Tensor, weights: torch.Tensor, padding: float) -> torch.Tensor:
    """The fine edges ``[N, S + 1]`` from the coarse ``edges [N, S + 1]``
    and weights ``[N, S]``: the weights max-pooled by 2 and averaged by 2
    (over ``[w_0, w, w_{S-1}]``) plus ``padding``, a pdf padded to a sum of
    at least 1e-5, its CDF from exactly 0 to exactly 1, and the inverse CDF
    at ``linspace(0, 1 - eps, S + 1)``: sorted, no merge with the coarse
    edges. The interval of a draw is found by ``searchsorted``, which picks
    the published mask's last ``u >= cdf`` knot."""
    n_edges = edges.shape[1]
    wp = torch.cat([weights[:, :1], weights, weights[:, -1:]], dim=-1)
    wmax = torch.maximum(wp[:, :-1], wp[:, 1:])
    w = 0.5 * (wmax[:, :-1] + wmax[:, 1:]) + padding
    wsum = w.sum(dim=-1, keepdim=True)
    pad = torch.clamp(1e-5 - wsum, min=0)
    w = w + pad / w.shape[-1]
    wsum = wsum + pad
    pdf = w / wsum
    cdf = torch.clamp(torch.cumsum(pdf[:, :-1], dim=-1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], dim=-1)
    u = _resample_u(n_edges, edges.device).expand(edges.shape[0], n_edges).contiguous()
    lo = torch.searchsorted(cdf, u, right=True) - 1
    hi = lo + 1
    cdf0, cdf1 = cdf.gather(1, lo), cdf.gather(1, hi)
    e0, e1 = edges.gather(1, lo), edges.gather(1, hi)
    t = torch.clamp(torch.nan_to_num((u - cdf0) / (cdf1 - cdf0), nan=0.0), 0, 1)
    return e0 + t * (e1 - e0)


# -- Mip-NeRF 360's proposal sampling -------------------------------------------

EPS2 = float(torch.finfo(torch.float32).eps) ** 2
_CENTER_U = {}


def s_to_t(s: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Metric depths of normalized distances ``s`` in disparity spacing:
    ``1 / (s s_far + (1 - s) s_near)``, ``s_near = 1 / near`` and ``s_far =
    1 / far`` in float32 (multinerf's ``construct_ray_warps`` with
    ``jnp.reciprocal``)."""
    s_near = float(np.float32(1) / np.float32(near))
    s_far = float(np.float32(1) / np.float32(far))
    return torch.reciprocal(s * s_far + (1 - s) * s_near)


def _range_max(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``max(p[r, lo..hi])`` for each ``[r, k]`` (0 where ``lo > hi``), from a
    sparse table of ``p [R, n]`` (``p >= 0``): ``log2 n`` levels of maxima of
    runs of ``2^l``, each query the larger of two overlapping runs."""
    R, n = p.shape
    tabs = [p]
    while 2 ** len(tabs) <= n:
        half = 2 ** (len(tabs) - 1)
        prev = tabs[-1]
        tabs.append(torch.maximum(prev[:, :-half], prev[:, half:]))
    table = torch.stack([torch.nn.functional.pad(t, (0, n - t.shape[1])) for t in tabs])
    length = (hi - lo + 1).clamp(min=1)
    lvl = torch.floor(torch.log2(length.float())).long().clamp(max=len(tabs) - 1)
    # log2 of an exact power of two can round below it: one step up where it fits
    up = (2 ** (lvl + 1) <= length) & (lvl + 1 < len(tabs))
    lvl = lvl + up.long()
    a = lo.clamp(0, n - 1)
    b = (hi - 2 ** lvl + 1).clamp(0, n - 1)
    flat = table.reshape(-1)
    rows = torch.arange(R, device=p.device)[:, None] * n
    va = flat[lvl * (R * n) + rows + a]
    vb = flat[lvl * (R * n) + rows + b]
    return torch.where(hi >= lo, torch.maximum(va, vb), torch.zeros_like(va))


def max_dilate_weights(s: torch.Tensor, w: torch.Tensor, dilation: float) -> tuple:
    """multinerf's ``max_dilate_weights`` on the domain ``[0, 1]``, renormalized,
    and the first and last edge and weight dropped: the pdf ``p = w /
    max(eps^2, ds)``; the edges ``e = clip(sort(s, s[:-1] - dilation, s[1:] +
    dilation), 0, 1)``; ``p'_k = max p_j`` over the ``j`` with ``s_j - dilation
    <= e_k < s_{j+1} + dilation`` (0 where none), for every edge but the
    last; ``w' = p' de``, over ``max(eps^2, sum w')``. ``(s [R, n + 1], w [R,
    n])`` -> ``([R, 3n - 1], [R, 3n - 2])``. The ``j`` of an edge are a run
    (both bounds are sorted), found by ``searchsorted``, and its maximum
    read from a sparse table, so no ``[R, 3n + 1, n]`` mask is made."""
    p = w / torch.clamp(s[:, 1:] - s[:, :-1], min=EPS2)
    t0 = (s[:, :-1] - dilation).contiguous()
    t1 = (s[:, 1:] + dilation).contiguous()
    e = torch.sort(torch.cat([s, t0, t1], dim=-1), dim=-1).values.clamp(0, 1)
    hi = torch.searchsorted(t0, e, right=True) - 1
    lo = torch.searchsorted(t1, e, right=True)
    pd = _range_max(p, lo, hi)[:, :-1]
    wd = pd * (e[:, 1:] - e[:, :-1])
    wd = wd / torch.clamp(wd.sum(dim=-1, keepdim=True), min=EPS2)
    return e[:, 1:-1], wd[:, 1:-1]


def _center_u(n: int, device) -> torch.Tensor:
    """``linspace(1 / (2n), 1 - 1 / (2n) - eps_f32, n)`` in float64, rounded to
    float32 once, made once per device."""
    key = (n, torch.device(device))
    if key not in _CENTER_U:
        pad = 1.0 / (2 * n)
        eps = float(np.finfo(np.float32).eps)
        u = np.linspace(pad, 1.0 - pad - eps, n, dtype=np.float64).astype(np.float32)
        _CENTER_U[key] = torch.from_numpy(u).to(device)
    return _CENTER_U[key]


def sample_intervals(s: torch.Tensor, w: torch.Tensor, n: int, padding: float = 0.0
                     ) -> torch.Tensor:
    """multinerf's ``sample_intervals`` in serving mode on the domain ``[0,
    1]``: the logits ``log(w + padding)`` where ``ds > 0``, else ``-inf``; ``cw =
    [0, min(1, cumsum(softmax[:-1])), 1]``; the centres ``sorted_interp(u, cw,
    s)`` at ``_center_u(n)`` (knot ``i`` the last with ``cw_i <= u``, linear to
    knot ``i + 1``, nan read as 0, clipped to ``[0, 1]``); edges at the
    midpoints, the first and last the centres' reflections clipped to the
    domain. ``(s [R, K + 1], w [R, K])`` -> ``[R, n + 1]``."""
    logits = torch.where(s[:, 1:] > s[:, :-1], torch.log(w + padding),
                         torch.full_like(w, float("-inf")))
    pw = torch.softmax(logits, dim=-1)
    cw = torch.clamp(torch.cumsum(pw[:, :-1], dim=-1), max=1)
    ends = cw.new_ones(cw.shape[0], 1)
    cw = torch.cat([ends * 0, cw, ends], dim=-1)
    u = _center_u(n, s.device).expand(s.shape[0], n).contiguous()
    i = (torch.searchsorted(cw, u, right=True) - 1).clamp(0, cw.shape[1] - 2)
    c0, c1 = cw.gather(1, i), cw.gather(1, i + 1)
    s0, s1 = s.gather(1, i), s.gather(1, i + 1)
    off = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), nan=0.0), 0, 1)
    c = s0 + off * (s1 - s0)
    mid = (c[:, 1:] + c[:, :-1]) / 2
    first = torch.clamp(2 * c[:, :1] - mid[:, :1], min=0)
    last = torch.clamp(2 * c[:, -1:] - mid[:, -1:], max=1)
    return torch.cat([first, mid, last], dim=-1)


_FIRST_LEVEL = {}


def first_level_360(n: int, n_rays: int, device) -> torch.Tensor:
    """The first level's normalized edges ``[n_rays, n + 1]``: ``n`` intervals
    drawn from one interval ``[0, 1]`` of weight 1 (``sample_intervals``), the
    same for every ray; made once per device on the host (the same bits as
    on the card: IEEE operations alone) and broadcast, so a chunk makes no
    copy from the host (a pageable copy waits for the stream)."""
    key = (n, torch.device(device))
    if key not in _FIRST_LEVEL:
        edges = sample_intervals(torch.tensor([[0.0, 1.0]]), torch.ones(1, 1), n)
        _FIRST_LEVEL[key] = edges.to(device)
    return _FIRST_LEVEL[key].expand(n_rays, n + 1)
