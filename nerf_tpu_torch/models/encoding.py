"""Sinusoidal positional encoding.

Layout is the JAX package's (``nerf_tpu/models/encoding.py``):
``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]`` with bands
``f_i = 2^i`` (times pi when ``include_pi``). Phases are formed in the input's
dtype; call it with float32 coordinates, since at the top band (2^9 pi) a
bf16 coordinate is radians off.
"""

from __future__ import annotations

import numpy as np
import torch


# (num_freqs, include_pi, dtype, device) -> the bands, made once: a copy
# from the host on every call would stall the device and cannot be captured
# in a CUDA graph (the train loop's, make_multi_train_step)
_BANDS = {}


def _bands(num_freqs: int, include_pi: bool, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    key = (num_freqs, include_pi, dtype, device)
    if key not in _BANDS:
        scale = np.pi if include_pi else 1.0
        _BANDS[key] = torch.as_tensor((2.0 ** np.arange(num_freqs)) * scale,
                                      dtype=dtype, device=device)
    return _BANDS[key]


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_pi: bool = True) -> torch.Tensor:
    """Encode ``x [..., D] -> [..., encoded_dim(D, num_freqs)]``."""
    if num_freqs == 0:
        return x
    freqs = _bands(num_freqs, include_pi, x.dtype, x.device)
    xf = x[..., None, :] * freqs[:, None]                 # [..., L, D]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return torch.cat([x, enc], dim=-1)


def encoded_dim(in_dim: int, num_freqs: int) -> int:
    """Width of ``positional_encoding``'s output for ``in_dim`` inputs."""
    return in_dim * (1 + 2 * num_freqs)


# -- Mip-NeRF: conical frustums and the integrated positional encoding ---------
#
# google/mipnerf (internal/mip.py), in float32, each operation in the
# published order (powers written as products: ``x**2`` is ``x * x`` there
# too, and ``x**4`` is ``(x * x) * (x * x)``).

HALF_PI = 0.5 * np.pi         # the published ``0.5 * jnp.pi``, a float32 once added


def conical_frustum_to_gaussian(t0: torch.Tensor, t1: torch.Tensor,
                                radius: torch.Tensor) -> tuple:
    """The mean along the ray and the variances along and across it of the
    cone's frustum between depths ``t0`` and ``t1`` (radius ``radius`` at
    depth 1): ``(t_mean, t_var, r_var)``, the published stable form."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    mu2, hw2 = mu * mu, hw * hw
    hw4 = hw2 * hw2
    den = 3 * mu2 + hw2
    t_mean = mu + (2 * mu * hw2) / den
    t_var = hw2 / 3 - (4 / 15) * ((hw4 * (12 * mu2 - hw2)) / (den * den))
    r_var = (radius * radius) * (mu2 / 4 + (5 / 12) * hw2 - (4 / 15) * hw4 / den)
    return t_mean, t_var, r_var


def lift_gaussian(rays_o: torch.Tensor, rays_d: torch.Tensor, t_mean: torch.Tensor,
                  t_var: torch.Tensor, r_var: torch.Tensor) -> tuple:
    """The frustums' Gaussians in the world: ``(mean [R, S, 3], cov_diag
    [R, S, 3])`` for rays ``[R, 3]`` and ``[R, S]`` moments; ``d`` is not
    normalized."""
    d = rays_d[:, None, :]
    mean = d * t_mean[..., None] + rays_o[:, None, :]
    d2 = d * d
    d_mag_sq = torch.clamp(d2[..., 0] + d2[..., 1] + d2[..., 2], min=1e-10)
    null = 1 - d2 / d_mag_sq[..., None]
    cov = t_var[..., None] * d2 + r_var[..., None] * null
    return mean, cov


def cast_intervals(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: torch.Tensor,
                   edges: torch.Tensor) -> tuple:
    """``(mean, cov_diag)`` ``[R, S, 3]`` of the ``S`` intervals between the
    ``S + 1`` depths ``edges [R, S + 1]`` of each ray; ``radius [R]``."""
    t0, t1 = edges[:, :-1], edges[:, 1:]
    return lift_gaussian(rays_o, rays_d,
                         *conical_frustum_to_gaussian(t0, t1, radius[:, None]))


def integrated_pos_enc(mean: torch.Tensor, cov: torch.Tensor, min_deg: int,
                       max_deg: int) -> torch.Tensor:
    """``[..., 6 (max_deg - min_deg)]``: ``exp(-y_var / 2) * sin(y)`` and
    ``exp(-y_var / 2) * sin(y + pi / 2)`` for ``y = 2^l mean``, ``y_var = 4^l
    cov``, degree-major (``l`` then the coordinate), sines first, no
    identity. ``sin`` at full range reduction: the published ``safe_sin``
    folds phases past ``100 pi`` into ``[0, 100 pi)`` because the TPU's
    ``sin`` loses accuracy there; at full range reduction it need not, and
    the two differ by under 1e-3 where the attenuation is not zero."""
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=mean.dtype,
                          device=mean.device)
    shape = (*mean.shape[:-1], -1)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (cov[..., None, :] * (scales * scales)[:, None]).reshape(shape)
    att = torch.exp(-0.5 * y_var)
    return torch.cat([att * torch.sin(y), att * torch.sin(y + HALF_PI)], dim=-1)


def mip_dir_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """The published ``pos_enc`` of the view directions: ``[x, sin(2^l x),
    sin(2^l x + pi / 2)]``, degree-major, sines first: ``3 (1 + 2 L)``
    features."""
    scales = torch.tensor([2.0 ** i for i in range(num_freqs)], dtype=x.dtype,
                          device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + HALF_PI], dim=-1))], dim=-1)
