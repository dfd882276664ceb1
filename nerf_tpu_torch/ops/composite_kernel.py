"""Alpha compositing over the ray kernel's interleaved output.

Counterpart of ``fused_volume_render_interleaved`` in
``nerf_tpu/ops/composite_kernel.py`` (the Pallas kernel
``_composite_kernel_interleaved``): from ``raw [N, 4S]`` (per sample
``(sigma, r, g, b)``), depths ``z [N, S]`` and ``rays_d [N, 3]`` it computes
``dists`` (adjacent differences, sentinel last, times ``||d||``),
``alpha = 1 - exp(-relu(sigma) * dist)``, the exclusive transmittance
``exp(cumsum(log(max(1 - alpha, eps))))`` and the weights, then rgb, depth
and accumulated opacity. The white background is added here, in the wrapper.

The transmittance follows the TPU kernel, ``log(max(1 - alpha, eps))``,
not ``volume_render``'s ``cumprod(1 - alpha + eps)``: the two differ by at
most ``eps`` per factor (1e-10), far below float32 resolution at any
transmittance that contributes.

On a CUDA tensor the wrapper launches ``csrc/composite.cu`` and counts the
launch in ``launches``; on a CPU tensor it runs
``fused_volume_render_interleaved_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.utils.rendering import RenderOutputs

# Launches of the CUDA kernel (not of the plain version).
launches = 0


def fused_volume_render_interleaved_plain(
    raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
    sentinel: float = 1e10, eps: float = 1e-10, dz: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the kernel: ``(out [N, 8], w [N, S])`` with
    ``out = (r, g, b, depth, acc, 0, 0, 0)``. With ``dz`` the distances are
    that constant step (uniform depths, as the composited ray kernels take
    them) instead of adjacent depth differences; the sentinel stays last."""
    raw = raw.float()
    sigma, rgb = raw[:, 0::4], torch.stack([raw[:, 1::4], raw[:, 2::4],
                                            raw[:, 3::4]], dim=-1)
    z = z_vals.float()
    steps = z[:, 1:] - z[:, :-1] if dz is None else torch.full_like(z[:, 1:], dz)
    dists = torch.cat([steps, torch.full_like(z[:, :1], sentinel)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d.float(), dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    log_t = torch.log(torch.clamp(1.0 - alpha, min=eps))
    t_excl = torch.exp(torch.cat([torch.zeros_like(log_t[:, :1]),
                                  torch.cumsum(log_t, dim=-1)[:, :-1]], dim=-1))
    w = alpha * t_excl
    zeros = torch.zeros_like(w[:, :3])
    out = torch.cat([(w[..., None] * rgb).sum(1), (w * z).sum(1, keepdim=True),
                     w.sum(1, keepdim=True), zeros], dim=-1)
    return out, w


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _launch(raw, z_vals, rays_d, sentinel, eps):
    global launches
    n, s4 = raw.shape
    s = s4 // 4
    dev = raw.device
    for name, t in (("raw", raw), ("z_vals", z_vals), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    if (not raw.is_contiguous() or z_vals.shape != (n, s) or z_vals.stride(1) != 1
            or rays_d.shape != (n, 3)):
        raise ValueError("raw must be contiguous [N, 4S], z_vals [N, S] with unit "
                         "sample stride and rays_d [N, 3]")
    rays_d = rays_d.contiguous()
    out = torch.empty(n, 8, dtype=torch.float32, device=dev)
    w = torch.empty(n, s, dtype=torch.float32, device=dev)
    if n == 0:
        return out, w
    lib = _ext.load("composite")
    fn = lib.composite
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(_ext.ptr(raw), _ext.ptr(z_vals), z_vals.stride(0), _ext.ptr(rays_d),
             n, s, float(sentinel), float(eps), _ext.ptr(out), _ext.ptr(w),
             _ext.stream_ptr(dev))
    _ext.check(lib, err, "composite launch")
    launches += 1
    return out, w


def fused_volume_render_interleaved(
    raw: torch.Tensor,        # [N, 4S] interleaved (sigma, r, g, b)
    z_vals: torch.Tensor,     # [N, S]
    rays_d: torch.Tensor,     # [N, 3]
    cfg: RenderConfig = RenderConfig(),
) -> RenderOutputs:
    if raw.shape[1] % 4:
        raise ValueError(f"raw must be [N, 4S], got {tuple(raw.shape)}")
    if raw.device.type == "cpu":
        out, w = fused_volume_render_interleaved_plain(
            raw, z_vals, rays_d, cfg.dist_sentinel, cfg.transmittance_eps)
    else:
        out, w = _launch(raw, z_vals, rays_d, cfg.dist_sentinel,
                         cfg.transmittance_eps)
    rgb = out[:, 0:3]
    acc = out[:, 4]
    if cfg.white_background:
        rgb = rgb + (1.0 - acc[:, None])
    return RenderOutputs(rgb, out[:, 3], acc, w)
