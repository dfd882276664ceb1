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


# -- Mip-NeRF 360: full-covariance Gaussians, the contraction, the basis ------
#
# google-research/multinerf (internal/render.py conical_frustum_to_gaussian
# and lift_gaussian with diag=False, internal/coord.py contract and
# track_linearize, internal/geopoly.py generate_basis, internal/coord.py
# lift_and_diagonalize and integrated_pos_enc), in float32, each product and
# sum of three written out in one order: ((x0 + x1) + x2). The kernels
# (csrc/ray_wgmma.cu, csrc/mip360_wgmma.cu) take the same steps.

EPS_F32 = float(np.finfo(np.float32).eps)


def _tesselation_weights(v: int) -> np.ndarray:
    """Barycentric weights of a triangle tessellated by ``v``."""
    w = [(i, j, v - (i + j)) for i in range(v + 1) for j in range(v + 1 - i)]
    return np.array(w, dtype=np.float64) / v


def _sq_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances between the columns of ``a`` and of ``b``."""
    d = (a * a).sum(0)[:, None] + (b * b).sum(0)[None, :] - 2 * a.T @ b
    return np.maximum(0.0, d)


BASIS_SUBDIVISIONS = 2   # 360.gin's basis: geopoly.generate_basis('icosahedron', 2)
N_BASIS = 21             # its directions: half the 10 v^2 + 2 vertices


def generate_basis(eps: float = 1e-4) -> np.ndarray:
    """``[3, N_BASIS]`` float32 unit vectors: the vertices of an icosahedron
    whose faces are tessellated by ``BASIS_SUBDIVISIONS`` and projected to the
    sphere, duplicates merged in the order they are first reached, one of
    each antipodal pair kept (the first), each vector's coordinates reversed:
    multinerf's ``generate_basis('icosahedron', 2)``, transposed."""
    a = (np.sqrt(5) + 1) / 2
    verts = np.array([(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a), (0, a, 1), (0, a, -1),
                      (0, -a, 1), (0, -a, -1), (a, 1, 0), (-a, 1, 0), (a, -1, 0),
                      (-a, -1, 0)]) / np.sqrt(a + 2)
    faces = np.array([(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1), (8, 10, 1),
                      (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3), (7, 10, 3), (7, 6, 10),
                      (7, 11, 6), (11, 0, 6), (0, 1, 6), (6, 1, 10), (9, 0, 11), (9, 11, 2),
                      (9, 2, 5), (7, 2, 11)])
    tri = _tesselation_weights(BASIS_SUBDIVISIONS)
    parts = []
    for face in faces:
        v = tri @ verts[face, :]
        parts.append(v / np.sqrt((v ** 2).sum(1, keepdims=True)))
    v = np.concatenate(parts, 0)
    d = _sq_dist(v.T, v.T)
    first = np.array([np.min(np.argwhere(row <= eps)) for row in d])
    v = v[np.unique(first), :]
    match = _sq_dist(v.T, -v.T) < eps
    v = v[np.any(np.triu(match), axis=-1), :]
    return np.ascontiguousarray(v[:, ::-1].T).astype(np.float32)


_BASIS = {}


def basis(device) -> torch.Tensor:
    """``generate_basis()`` on ``device``, made once per device."""
    key = torch.device(device)
    if key not in _BASIS:
        _BASIS[key] = torch.from_numpy(generate_basis()).to(device)
    return _BASIS[key]


def _dot3(a0, a1, a2, b0, b1, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def frustum_gaussian_360(t0: torch.Tensor, t1: torch.Tensor, radius: torch.Tensor) -> tuple:
    """``(t_mean, t_var, r_var)`` of the cone's frustum between ``t0`` and
    ``t1`` in multinerf's stable form: ``s = t0 + t1``, ``dl = t1 - t0``,
    ``rho = dl^2 / max(eps^2, 3 s^2 + dl^2)``, ``t_mean = s (1/2 + rho)``,
    ``t_var = dl^2 / 12 - rho^2 (12 s^2 - dl^2) / 15``, ``r_var = r^2 (s^2 /
    16 + dl^2 (5/48 - rho / 15))``."""
    s = t0 + t1
    dl = t1 - t0
    s2, d2 = s * s, dl * dl
    rho = d2 / torch.clamp(3 * s2 + d2, min=EPS_F32 * EPS_F32)
    t_mean = s * (0.5 + rho)
    t_var = d2 / 12 - ((rho * rho) * (12 * s2 - d2)) / 15
    r_var = (radius * radius) * (s2 / 16 + d2 * (float(np.float32(5 / 48)) - rho / 15))
    return t_mean, t_var, r_var


def lift_gaussian_full(rays_o: torch.Tensor, rays_d: torch.Tensor, t_mean: torch.Tensor,
                       t_var: torch.Tensor, r_var: torch.Tensor) -> tuple:
    """``(mean [..., 3], cov [..., 3, 3])``: ``mean = d t_mean + o`` and ``cov
    = t_var d d^T + r_var (I - d (d / max(1e-10, |d|^2))^T)`` for rays ``[R,
    3]`` and moments ``[R, S]``."""
    d = rays_d[:, None, :]
    mean = d * t_mean[..., None] + rays_o[:, None, :]
    d2 = d * d
    mag = torch.clamp((d2[..., 0] + d2[..., 1]) + d2[..., 2], min=1e-10)[..., None]
    outer = d[..., :, None] * d[..., None, :]
    null = torch.eye(3, dtype=d.dtype, device=d.device) - d[..., :, None] * (d / mag)[..., None, :]
    cov = t_var[..., None, None] * outer + r_var[..., None, None] * null
    return mean, cov


def contract_jacobian(x: torch.Tensor) -> tuple:
    """Mip-NeRF 360's scene contraction of points ``x [..., 3]`` and its
    Jacobian: with ``m = max(eps, |x|^2)`` and ``q = sqrt(m)``, points with ``m
    <= 1`` stay (``J = I``); the others go to ``((2 q - 1) / m) x``, ``J = ((2 q
    - 1) / m) I + (2 (1 - q) / m^2) x x^T``. ``(contract(x), J [..., 3, 3])``."""
    m = torch.clamp((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2],
                    min=EPS_F32)
    q = torch.sqrt(m)
    inside = m <= 1
    a = torch.where(inside, torch.ones_like(m), (2 * q - 1) / m)
    b = torch.where(inside, torch.zeros_like(m), (2 * (1 - q)) / (m * m))
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    jac = a[..., None, None] * eye + b[..., None, None] * (x[..., :, None] * x[..., None, :])
    return a[..., None] * x, jac


def contract_gaussian(mean: torch.Tensor, cov: torch.Tensor) -> tuple:
    """Gaussians ``(mean [..., 3], cov [..., 3, 3])`` through the contraction
    (``contract_jacobian``): ``(contract(mean), J cov J^T)``."""
    mean_c, jac = contract_jacobian(mean)
    return mean_c, _matmul3(_matmul3(jac, cov), jac.transpose(-1, -2))


def _matmul3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` of ``[..., 3, 3]`` matrices, each entry ``((x_i0 y_0j + x_i1
    y_1j) + x_i2 y_2j)``."""
    return (x[..., :, 0:1] * y[..., 0:1, :] + x[..., :, 1:2] * y[..., 1:2, :]) \
        + x[..., :, 2:3] * y[..., 2:3, :]


def lift_and_diagonalize(mean: torch.Tensor, cov: torch.Tensor, b: torch.Tensor) -> tuple:
    """The Gaussians seen along the basis ``b [3, n]``: ``(mean^T b, diag(b^T
    cov b))``, ``[..., n]`` each."""
    m = _dot3(mean[..., 0:1], mean[..., 1:2], mean[..., 2:3], b[0], b[1], b[2])
    cb = (cov[..., :, 0:1] * b[0] + cov[..., :, 1:2] * b[1]) + cov[..., :, 2:3] * b[2]   # [..., 3, n]
    var = _dot3(b[0], b[1], b[2], cb[..., 0, :], cb[..., 1, :], cb[..., 2, :])
    return m, var


def integrated_pos_enc_360(m: torch.Tensor, var: torch.Tensor, min_deg: int,
                           max_deg: int) -> torch.Tensor:
    """``[..., 2 n (max_deg - min_deg)]``: ``exp(-(4^l var) / 2) sin(2^l m)``
    for degrees ``l``, then the same at ``2^l m + pi / 2``, degree-major
    (``l``, then the basis direction), sines first; ``sin`` at full range
    reduction."""
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=m.dtype,
                          device=m.device)
    shape = (*m.shape[:-1], -1)
    y = (m[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (var[..., None, :] * (scales * scales)[:, None]).reshape(shape)
    att = torch.exp(-0.5 * y_var)
    return torch.cat([att * torch.sin(y), att * torch.sin(y + HALF_PI)], dim=-1)


def encode_intervals_360(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: torch.Tensor,
                         t_edges: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """The Mip-NeRF 360 encoding ``[R, S, F]`` of the ``S`` intervals between
    the ``S + 1`` metric depths ``t_edges [R, S + 1]`` of each ray; ``radius
    [R]``."""
    t0, t1 = t_edges[:, :-1], t_edges[:, 1:]
    mean, cov = lift_gaussian_full(rays_o, rays_d,
                                   *frustum_gaussian_360(t0, t1, radius[:, None]))
    mean, cov = contract_gaussian(mean, cov)
    m, var = lift_and_diagonalize(mean, cov, basis(rays_o.device))
    return integrated_pos_enc_360(m, var, min_deg, max_deg)
