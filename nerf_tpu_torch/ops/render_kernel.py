"""Ray-blocked sample generation + NeRF MLP: the fused ray kernel.

Counterpart of ``fused_render_samples`` in ``nerf_tpu/ops/render_kernel.py``
(the Pallas kernel ``_ray_kernel``). For every ray it places ``S`` uniform
depths ``z = near + (far - near) * s / (S - 1)``, forms ``pos = o + d * z``,
encodes it, runs the whole MLP (8 x 256 trunk with the skip, density head,
color branch with the per-ray direction encoding) and writes
``(sigma, r, g, b)`` per sample, sample-major within the ray, so the
``[R * S, 4]`` output is a free ``[R, 4S]`` view for the compositor.

On a CUDA tensor ``fused_render_samples`` launches the CUDA kernel
(``csrc/render_samples.cu``) and counts the launch in ``launches``; on a CPU
tensor it runs ``fused_render_samples_plain``, the same arithmetic in plain
PyTorch. Nothing falls back: a CUDA launch either runs or raises.

Arithmetic shared by both versions, and the tolerances it sets:

- positions and phases in float32, ``sin``/``cos`` at full range reduction;
  the encoding is rounded to the compute dtype only after the phases;
- each matmul takes compute-dtype inputs and accumulates in float32; the
  epilogue adds the float32 bias (and, for the color layer, the per-ray
  direction term) to the float32 accumulator, applies ReLU, then rounds to
  the compute dtype (``apply_nerf``'s order, not the TPU kernel's bf16
  epilogue);
- direction normalization is ``d * rsqrt(|d|^2 + 1e-12)`` (the TPU kernel's
  form; ``apply_nerf`` divides by the norm).

Between the kernel and the plain version in bf16 the differences are the
order of float32 accumulation (tensor-core MMA vs ATen) and, through it, the
occasional other bf16 rounding of an activation.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np
import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.encoding import positional_encoding
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.ops.mlp_kernel import (
    DIR_ROWS,
    HID,
    POS_ROWS,
    PackedWeights,
    pack_params,
    skip_position,
)
from nerf_tpu_torch.utils.device import disable_tf32

# Launches of the CUDA kernel (not of the plain version).
launches = 0


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def fused_render_samples_plain(packed: PackedWeights, rays_o, rays_d,
                               near: float, far: float, n_samples: int,
                               cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch version of the kernel. Returns ``raw [R, 4S]``. The
    compute dtype is that of the packed matrices."""
    disable_tf32()
    dt = packed.w0.dtype
    S = n_samples
    R = rays_o.shape[0]
    dev = rays_o.device
    o = rays_o.float()
    d = rays_d.float()

    def mm(a, w):
        return a.to(dt).float() @ w.float()

    t = torch.arange(S, dtype=torch.float32, device=dev) / (S - 1)
    z = near + (far - near) * t                                      # [S]
    pos = o[:, None, :] + d[:, None, :] * z[None, :, None]           # [R, S, 3]
    enc = _pad_cols(positional_encoding(pos.reshape(-1, 3), cfg.pos_freqs,
                                        cfg.posenc_pi), POS_ROWS).to(dt)

    h = torch.relu(mm(enc, packed.w0) + packed.b0)
    skip_pos = skip_position(cfg)
    for i in range(1, 8):
        y = mm(h, packed.wt[i - 1])
        if i == skip_pos:
            y = y + mm(enc, packed.wskip)
        h = torch.relu(y + packed.bt[i - 1])

    sigma = mm(h, packed.wsig[:, None])[:, 0] + packed.bsig
    if cfg.variant == "reference":
        sigma = torch.relu(sigma)

    if cfg.normalize_dirs:
        d = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
    denc = _pad_cols(positional_encoding(d, cfg.dir_freqs, cfg.posenc_pi),
                     DIR_ROWS)
    cdir = mm(denc, packed.wdir).repeat_interleave(S, dim=0)         # [R*S, 128]

    feat = h
    if cfg.variant == "bmild":
        feat = mm(h, packed.wbn) + packed.bbn                        # no activation
    c = torch.relu(mm(feat, packed.wc0) + packed.bc0 + cdir)
    rgb = torch.sigmoid(mm(c, packed.wc1) + packed.bc1)
    return torch.cat([sigma[:, None], rgb], dim=-1).reshape(R, 4 * S)


_ARGTYPES = (
    [ctypes.c_void_p] * 2                 # rays_o, rays_d
    + [ctypes.c_int] * 2                  # n_rays, n_samples
    + [ctypes.c_float] * 2                # near, far - near
    + [ctypes.c_void_p] * 14              # weights (PackedWeights order)
    + [ctypes.c_int] * 6                  # Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs
    + [ctypes.c_float]                    # band scale (pi or 1)
    + [ctypes.c_void_p] * 2               # out, stream
)


def _launch(packed: PackedWeights, rays_o, rays_d, near, far, S,
            cfg: ModelConfig) -> torch.Tensor:
    global launches
    dev = rays_o.device
    R = rays_o.shape[0]
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.shape != (R, 3) or t.device != dev:
            raise ValueError(f"{name} must be float32 [R, 3] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    bmild = cfg.variant == "bmild"
    if bmild != (packed.wbn is not None):
        raise ValueError(f"packed weights do not match variant {cfg.variant}")
    if packed.wt.shape != (7, HID, HID) or packed.wc1.shape != (HID // 2, 3):
        raise ValueError("packed weights are not in pack_params' layout")
    for name, w in packed._asdict().items():   # wbn/bbn are None unless bmild
        want = torch.float32 if name.startswith("b") else torch.bfloat16
        if w is not None and (w.dtype != want or w.device != dev
                              or not w.is_contiguous()):
            raise ValueError(f"packed weight {name} must be contiguous {want} on "
                             f"{dev} (the CUDA ray kernel computes in bfloat16)")
    rays_o = rays_o.contiguous()
    rays_d = rays_d.contiguous()
    out = torch.empty(R * S, 4, dtype=torch.float32, device=dev)
    if R == 0:
        return out.reshape(R, 4 * S)
    lib = _ext.load("render_samples")
    fn = lib.render_samples
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(_ext.ptr(rays_o), _ext.ptr(rays_d), R, S, float(near),
             float(far - near),
             *[None if w is None else _ext.ptr(w) for w in packed],
             cfg.pos_freqs, cfg.dir_freqs, skip_position(cfg), int(bmild),
             int(cfg.variant == "reference"), int(cfg.normalize_dirs),
             float(np.float32(np.pi)) if cfg.posenc_pi else 1.0,
             _ext.ptr(out), _ext.stream_ptr(dev))
    _ext.check(lib, err, "render_samples launch")
    launches += 1
    return out.reshape(R, 4 * S)


def fused_render_samples(
    params: Union[dict, PackedWeights],
    rays_o: torch.Tensor,     # [R, 3]
    rays_d: torch.Tensor,     # [R, 3]
    near: float,
    far: float,
    n_samples: int,
    cfg: ModelConfig,
    raw: bool = False,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, ...]:
    """Evaluate the network at uniform depths along every ray.

    Returns ``(sigma [R, S], rgb [R, S, 3], z_vals [R, S])``, or with
    ``raw=True`` ``(raw [R, 4S], z_vals)``: the interleaved per-sample
    ``(sigma, r, g, b)`` for ``fused_volume_render_interleaved``. ``params``
    is a params dict (packed here, in ``dtype``) or ``PackedWeights``.
    ``z_vals`` is a broadcast view, ``near + (far - near) * linspace``."""
    S = n_samples
    assert S >= 2, "need at least 2 samples for the linspace"
    packed = params if isinstance(params, PackedWeights) else pack_params(
        params, cfg, dtype)
    if rays_o.device.type == "cpu":
        out = fused_render_samples_plain(packed, rays_o, rays_d, near, far, S, cfg)
    else:
        out = _launch(packed, rays_o, rays_d, near, far, S, cfg)
    R = rays_o.shape[0]
    t = torch.linspace(0.0, 1.0, S, dtype=torch.float32, device=rays_o.device)
    z_vals = (near + (far - near) * t).expand(R, S)
    if raw:
        return out, z_vals
    out = out.reshape(R, S, 4)
    return out[..., 0], out[..., 1:4], z_vals
