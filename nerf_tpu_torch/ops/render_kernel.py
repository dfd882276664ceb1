"""Ray-blocked sample generation + NeRF MLP: the fused ray kernels.

Counterparts of ``nerf_tpu/ops/render_kernel.py``:

- ``fused_render_samples`` (K1, the Pallas kernel ``_ray_kernel``) places
  ``S`` uniform depths ``z = near + (far - near) * s / (S - 1)`` per ray;
- ``fused_render_zvals_raw`` (K3, ``_ray_z_kernel``) reads per-ray depths
  ``z_vals [R, S]`` (the hierarchical fine pass).

Both form ``pos = o + d * z``, encode it, run the whole MLP (8 x 256 trunk
with the skip, density head, color branch with the per-ray direction
encoding) and write ``(sigma, r, g, b)`` per sample, sample-major within the
ray, so the ``[R * S, 4]`` output is a free ``[R, 4S]`` view for the
compositor. Their composited modes (``fused_render_samples_composited``,
``fused_render_zvals_composited``; the TPU kernels' ``composited=True``,
``_composite_flat``) volume-render inside the kernel instead and write
``[R, 8] = (r, g, b, depth, acc, 0, 0, 0)`` and, optionally, the weights
``[R, S]``: the per-sample field never reaches device memory.

On a CUDA tensor each wrapper launches its CUDA kernel
(``csrc/render_samples.cu``) and counts the launch in ``launches[name]``; on
a CPU tensor it runs its ``*_plain`` twin, the same arithmetic in plain
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
from typing import Optional, Tuple, Union

import numpy as np
import torch

from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.models.encoding import positional_encoding
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.ops.composite_kernel import fused_volume_render_interleaved_plain
from nerf_tpu_torch.ops.mlp_kernel import (
    DIR_ROWS,
    HID,
    POS_ROWS,
    PackedWeights,
    pack_params,
    skip_position,
)
from nerf_tpu_torch.utils.device import disable_tf32
from nerf_tpu_torch.utils.rendering import RenderOutputs

# Launches of each CUDA kernel (not of the plain versions).
launches = {"render_samples": 0, "render_zvals": 0,
            "render_samples_composited": 0, "render_zvals_composited": 0}


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _mlp_plain(packed: PackedWeights, pos: torch.Tensor, d: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The kernels' network on positions ``pos [R, S, 3]`` of rays with
    directions ``d [R, 3]``: ``raw [R, 4S]``, per sample ``(sigma, r, g, b)``.
    The compute dtype is that of the packed matrices."""
    disable_tf32()
    dt = packed.w0.dtype
    R, S = pos.shape[:2]

    def mm(a, w):
        return a.to(dt).float() @ w.float()

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


def _uniform_z(near: float, far: float, n_samples: int, device) -> torch.Tensor:
    """The kernels' depth grid ``near + (far - near) * s / (S - 1)`` [S]."""
    t = torch.arange(n_samples, dtype=torch.float32, device=device) / (n_samples - 1)
    return near + (far - near) * t


def fused_render_samples_plain(packed: PackedWeights, rays_o, rays_d,
                               near: float, far: float, n_samples: int,
                               cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch version of the uniform-depth kernel (K1). Returns
    ``raw [R, 4S]``."""
    o, d = rays_o.float(), rays_d.float()
    z = _uniform_z(near, far, n_samples, o.device)                   # [S]
    pos = o[:, None, :] + d[:, None, :] * z[None, :, None]           # [R, S, 3]
    return _mlp_plain(packed, pos, d, cfg)


def fused_render_zvals_plain(packed: PackedWeights, rays_o, rays_d, z_vals,
                             cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch version of the per-ray-depth kernel (K3). Returns
    ``raw [R, 4S]``."""
    o, d, z = rays_o.float(), rays_d.float(), z_vals.float()
    pos = o[:, None, :] + d[:, None, :] * z[..., None]               # [R, S, 3]
    return _mlp_plain(packed, pos, d, cfg)


def fused_render_samples_composited_plain(packed, rays_o, rays_d, near, far,
                                          n_samples, cfg, sentinel=1e10, eps=1e-10):
    """Plain-PyTorch version of K1's composited mode: ``(out [R, 8], w)``,
    the distances the constant step ``(far - near) / (S - 1)``."""
    raw = fused_render_samples_plain(packed, rays_o, rays_d, near, far, n_samples, cfg)
    z = _uniform_z(near, far, n_samples, raw.device).expand(raw.shape[0], n_samples)
    return fused_volume_render_interleaved_plain(raw, z, rays_d, sentinel, eps,
                                                 dz=(far - near) / (n_samples - 1))


def fused_render_zvals_composited_plain(packed, rays_o, rays_d, z_vals, cfg,
                                        sentinel=1e10, eps=1e-10):
    """Plain-PyTorch version of K3's composited mode: ``(out [R, 8], w)``."""
    raw = fused_render_zvals_plain(packed, rays_o, rays_d, z_vals, cfg)
    return fused_volume_render_interleaved_plain(raw, z_vals, rays_d, sentinel, eps)


_ARGTYPES = (
    [ctypes.c_void_p] * 3                 # rays_o, rays_d, z_vals (NULL: uniform)
    + [ctypes.c_longlong]                 # z row stride
    + [ctypes.c_int] * 2                  # n_rays, n_samples
    + [ctypes.c_float] * 2                # near, far - near
    + [ctypes.c_void_p] * 14              # weights (PackedWeights order)
    + [ctypes.c_int] * 6                  # Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs
    + [ctypes.c_float]                    # band scale (pi or 1)
    + [ctypes.c_int]                      # composited
    + [ctypes.c_float] * 3                # uniform step dz, sentinel, eps
    + [ctypes.c_void_p] * 3               # out, w (NULL: none), stream
)


def _launch(packed: PackedWeights, rays_o, rays_d, near, far, S,
            cfg: ModelConfig, z_vals: Optional[torch.Tensor] = None,
            composited: bool = False, with_weights: bool = False,
            sentinel: float = 1e10, eps: float = 1e-10):
    """Launch one of the four kernels of ``csrc/render_samples.cu``: depths
    uniform (``z_vals`` None, K1) or per ray (K3), output raw ``[R, 4S]`` or
    composited ``(out [R, 8], w [R, S] or None)``."""
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
    z_stride = 0
    if z_vals is not None:
        if (z_vals.dtype != torch.float32 or z_vals.device != dev
                or z_vals.shape != (R, S) or z_vals.stride(1) != 1):
            raise ValueError(f"z_vals must be float32 [R, S] = {(R, S)} with unit "
                             f"sample stride on {dev}, got {z_vals.dtype} "
                             f"{tuple(z_vals.shape)} on {z_vals.device}")
        z_stride = z_vals.stride(0)
    elif S < 2:
        raise ValueError("need at least 2 samples for uniform depths")
    rays_o = rays_o.contiguous()
    rays_d = rays_d.contiguous()
    if composited:
        out = torch.empty(R, 8, dtype=torch.float32, device=dev)
        w = torch.empty(R, S, dtype=torch.float32, device=dev) if with_weights else None
    else:
        out = torch.empty(R * S, 4, dtype=torch.float32, device=dev)
        w = None
    result = (out, w) if composited else out.reshape(R, 4 * S)
    if R == 0:
        return result
    lib = _ext.load("render_samples")
    fn = lib.ray_render
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    dz = (far - near) / (S - 1) if z_vals is None else 0.0
    err = fn(_ext.ptr(rays_o), _ext.ptr(rays_d),
             None if z_vals is None else _ext.ptr(z_vals), z_stride, R, S,
             float(near), float(far - near),
             *[None if w_ is None else _ext.ptr(w_) for w_ in packed],
             cfg.pos_freqs, cfg.dir_freqs, skip_position(cfg),
             int(cfg.variant == "bmild"), int(cfg.variant == "reference"),
             int(cfg.normalize_dirs),
             float(np.float32(np.pi)) if cfg.posenc_pi else 1.0,
             int(composited), float(dz), float(sentinel), float(eps),
             _ext.ptr(out), None if w is None else _ext.ptr(w), _ext.stream_ptr(dev))
    name = ("render_samples" if z_vals is None else "render_zvals") + (
        "_composited" if composited else "")
    _ext.check(lib, err, f"{name} launch")
    launches[name] += 1
    return result


def _packed(params, cfg: ModelConfig, dtype) -> PackedWeights:
    return params if isinstance(params, PackedWeights) else pack_params(params, cfg, dtype)


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
    """Evaluate the network at uniform depths along every ray (K1).

    Returns ``(sigma [R, S], rgb [R, S, 3], z_vals [R, S])``, or with
    ``raw=True`` ``(raw [R, 4S], z_vals)``: the interleaved per-sample
    ``(sigma, r, g, b)`` for ``fused_volume_render_interleaved``. ``params``
    is a params dict (packed here, in ``dtype``) or ``PackedWeights``.
    ``z_vals`` is a broadcast view, ``near + (far - near) * linspace``."""
    S = n_samples
    assert S >= 2, "need at least 2 samples for the linspace"
    packed = _packed(params, cfg, dtype)
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


def fused_render_zvals_raw(
    params: Union[dict, PackedWeights],
    rays_o: torch.Tensor,     # [R, 3]
    rays_d: torch.Tensor,     # [R, 3]
    z_vals: torch.Tensor,     # [R, S]
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Evaluate the network at per-ray depths (K3): ``raw [R, 4S]``, the
    interleaved per-sample ``(sigma, r, g, b)`` for
    ``fused_volume_render_interleaved``."""
    packed = _packed(params, cfg, dtype)
    if rays_o.device.type == "cpu":
        return fused_render_zvals_plain(packed, rays_o, rays_d, z_vals, cfg)
    return _launch(packed, rays_o, rays_d, 0.0, 0.0, z_vals.shape[1], cfg,
                   z_vals=z_vals)


def fused_render_samples_composited(
    params: Union[dict, PackedWeights],
    rays_o: torch.Tensor,     # [R, 3]
    rays_d: torch.Tensor,     # [R, 3]
    near: float,
    far: float,
    n_samples: int,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    with_weights: bool = False,
    sentinel: float = 1e10,
    eps: float = 1e-10,
):
    """Uniform-depth render with volume rendering in the same kernel (K1
    composited): the per-sample field never reaches device memory. Returns
    ``(out [R, 8], z_vals)`` or ``(out, weights [R, S], z_vals)``, ``out =
    (r, g, b, depth, acc, 0, 0, 0)``; the white background is the caller's
    (``composited_to_outputs``)."""
    S = n_samples
    if S < 2:
        raise ValueError("need at least 2 samples for uniform depths")
    packed = _packed(params, cfg, dtype)
    if rays_o.device.type == "cpu":
        out, w = fused_render_samples_composited_plain(packed, rays_o, rays_d, near,
                                                       far, S, cfg, sentinel, eps)
    else:
        out, w = _launch(packed, rays_o, rays_d, near, far, S, cfg, composited=True,
                         with_weights=with_weights, sentinel=sentinel, eps=eps)
    z_vals = _uniform_z(near, far, S, rays_o.device).expand(rays_o.shape[0], S)
    return (out, w, z_vals) if with_weights else (out, z_vals)


def fused_render_zvals_composited(
    params: Union[dict, PackedWeights],
    rays_o: torch.Tensor,     # [R, 3]
    rays_d: torch.Tensor,     # [R, 3]
    z_vals: torch.Tensor,     # [R, S]
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    with_weights: bool = False,
    sentinel: float = 1e10,
    eps: float = 1e-10,
):
    """Per-ray-depth render with in-kernel volume rendering (K3
    composited). Returns ``out [R, 8]`` or ``(out, weights [R, S])``."""
    packed = _packed(params, cfg, dtype)
    if rays_o.device.type == "cpu":
        out, w = fused_render_zvals_composited_plain(packed, rays_o, rays_d, z_vals,
                                                     cfg, sentinel, eps)
    else:
        out, w = _launch(packed, rays_o, rays_d, 0.0, 0.0, z_vals.shape[1], cfg,
                         z_vals=z_vals, composited=True, with_weights=with_weights,
                         sentinel=sentinel, eps=eps)
    return (out, w) if with_weights else out


def composited_to_outputs(out8: torch.Tensor, weights: Optional[torch.Tensor],
                          rcfg: RenderConfig) -> RenderOutputs:
    """``[R, 8]`` composited output -> ``RenderOutputs``, with the white
    background blended on the per-ray maps. ``weights`` is ``[R, S]`` or
    None when the caller did not ask for them."""
    rgb = out8[:, 0:3]
    acc = out8[:, 4]
    if rcfg.white_background:
        rgb = rgb + (1.0 - acc[:, None])
    return RenderOutputs(rgb, out8[:, 3], acc, weights)
