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

The raw output has two more forms (the TPU kernels' ``raw_dtype`` and
``planar=True``): interleaved in bfloat16, which the interleaved compositor
reads and computes on in float32, and four ``[R, S]`` float32 planes (sigma,
r, g, b) for the planar compositor ``fused_volume_render``. On the card a
plane is a per-thread indexed store of the same values, so the planes are
bit-identical to the de-interleaved raw output.

Every function takes the weights as a params dict, ``PackedWeights`` or the
quantized representations of ``ops/quant.py`` (the TPU kernels'
``_weights_for``): ``QuantizedPackedWeights`` are dequantized inside the
kernel as it stages each weight chunk, ``Int8PackedWeights`` run the trunk
as s8 x s8 -> s32 tensor-core products. Each weight route is its own build
of each CUDA source.

On a CUDA tensor each wrapper launches its CUDA kernel and counts the launch
in ``launches[name]``; on a CPU tensor it runs its ``*_plain`` twin, the same
arithmetic in plain PyTorch. Nothing falls back: a CUDA launch either runs
or raises. Which kernel (``kernel_library``): every form and mode, on every
weight route, goes to the Hopper kernels of ``csrc/ray_wgmma.cu`` (warpgroup
``wgmma``, weights streamed by a producer warpgroup, persistent blocks; the
weight stream is laid out once per set of weights, and the composited
modes' schedule of whole rays per consumer is written out, by
``ops/ray_wgmma.py``), built for the weights' route. The WMMA builds of
``csrc/render_samples.cu`` they replaced are reached only through
``library=``, to time them beside the Hopper kernels.

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

import torch

from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.ops import _ext, quant, ray_wgmma
from nerf_tpu_torch.ops.composite_kernel import fused_volume_render_interleaved_plain
from nerf_tpu_torch.ops.mlp_kernel import (
    PackedWeights,
    check_packed,
    fused_nerf_apply_plain,
    net_args,
    pack_params,
)
from nerf_tpu_torch.utils.rendering import RenderOutputs

# Launches of each CUDA kernel (not of the plain versions), and of the
# routes through them: a launch adds one to its function's count (K1 or K3,
# raw or composited), to each route it takes (planar or bfloat16 raw output;
# intN weights dequantized in the kernel; int8 compute) and, on the Hopper
# kernels of csrc/ray_wgmma.cu (raw or composited), to wgmma_samples (K1) or
# wgmma_zvals (K3).
launches = {"render_samples": 0, "render_zvals": 0,
            "render_samples_composited": 0, "render_zvals_composited": 0,
            "planar": 0, "raw_bf16": 0, "dequant": 0, "int8": 0,
            "wgmma_samples": 0, "wgmma_zvals": 0}

# the WMMA build of csrc/render_samples.cu for each weight route (0: bf16
# weights), which the Hopper kernels replaced: reached only through library=
_LIBRARY = {0: "render_samples", quant.ROUTE_INT8: "render_samples_q8",
            quant.ROUTE_INT16: "render_samples_q16",
            quant.ROUTE_INT8_COMPUTE: "render_samples_i8"}
_WEIGHTS = {0: "bf16", quant.ROUTE_INT8: "int8", quant.ROUTE_INT16: "int16",
            quant.ROUTE_INT8_COMPUTE: "int8-compute"}
_OUT_F32, _OUT_BF16, _OUT_PLANAR = 0, 1, 2


def kernel_library(route: int, composited: bool) -> str:
    """The library a CUDA launch on a weight route goes to: the route's
    build of ``csrc/ray_wgmma.cu``, for the raw forms (float32, bfloat16,
    planar) and the composited modes alike."""
    return ray_wgmma.LIBRARIES[route]


def _mlp_plain(packed, pos: torch.Tensor, d: torch.Tensor, cfg: ModelConfig,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernels' network on positions ``pos [R, S, 3]`` of rays with
    directions ``d [R, 3]``: ``raw [R, 4S]``, per sample ``(sigma, r, g, b)``
    (``fused_nerf_apply_plain`` with each ray's direction repeated per
    sample). The compute dtype is that of the packed matrices, or ``dtype``
    for quantized weights (``quantized_nerf_apply_plain``)."""
    R, S = pos.shape[:2]
    flat, dirs = pos.reshape(-1, 3), d.repeat_interleave(S, dim=0)
    if quant.is_quantized(packed):
        out = quant.quantized_nerf_apply_plain(packed, flat, dirs, cfg, dtype)
    else:
        out = fused_nerf_apply_plain(packed, flat, dirs, cfg)
    return out.reshape(R, 4 * S)


def planes_of(raw: torch.Tensor):
    """``raw [R, 4S]`` de-interleaved: ``(sigma [R, S], (r, g, b))``,
    contiguous planes."""
    return raw[:, 0::4].contiguous(), tuple(raw[:, c::4].contiguous() for c in (1, 2, 3))


def _uniform_z(near: float, far: float, n_samples: int, device) -> torch.Tensor:
    """The kernels' depth grid ``near + (far - near) * s / (S - 1)`` [S]."""
    t = torch.arange(n_samples, dtype=torch.float32, device=device) / (n_samples - 1)
    return near + (far - near) * t


def fused_render_samples_plain(packed, rays_o, rays_d,
                               near: float, far: float, n_samples: int,
                               cfg: ModelConfig,
                               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain-PyTorch version of the uniform-depth kernel (K1). Returns
    ``raw [R, 4S]`` in float32 (the bfloat16 raw output is this, rounded; the
    planes are ``planes_of`` it). ``packed``: ``PackedWeights`` or quantized
    weights (computed in ``dtype``)."""
    o, d = rays_o.float(), rays_d.float()
    z = _uniform_z(near, far, n_samples, o.device)                   # [S]
    pos = o[:, None, :] + d[:, None, :] * z[None, :, None]           # [R, S, 3]
    return _mlp_plain(packed, pos, d, cfg, dtype)


def fused_render_zvals_plain(packed, rays_o, rays_d, z_vals,
                             cfg: ModelConfig,
                             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain-PyTorch version of the per-ray-depth kernel (K3). Returns
    ``raw [R, 4S]``."""
    o, d, z = rays_o.float(), rays_d.float(), z_vals.float()
    pos = o[:, None, :] + d[:, None, :] * z[..., None]               # [R, S, 3]
    return _mlp_plain(packed, pos, d, cfg, dtype)


def fused_render_samples_composited_plain(packed, rays_o, rays_d, near, far,
                                          n_samples, cfg, sentinel=1e10, eps=1e-10,
                                          dtype=torch.bfloat16):
    """Plain-PyTorch version of K1's composited mode: ``(out [R, 8], w)``,
    the distances the constant step ``(far - near) / (S - 1)``."""
    raw = fused_render_samples_plain(packed, rays_o, rays_d, near, far, n_samples, cfg,
                                     dtype)
    z = _uniform_z(near, far, n_samples, raw.device).expand(raw.shape[0], n_samples)
    return fused_volume_render_interleaved_plain(raw, z, rays_d, sentinel, eps,
                                                 dz=(far - near) / (n_samples - 1))


def fused_render_zvals_composited_plain(packed, rays_o, rays_d, z_vals, cfg,
                                        sentinel=1e10, eps=1e-10, dtype=torch.bfloat16):
    """Plain-PyTorch version of K3's composited mode: ``(out [R, 8], w)``."""
    raw = fused_render_zvals_plain(packed, rays_o, rays_d, z_vals, cfg, dtype)
    return fused_volume_render_interleaved_plain(raw, z_vals, rays_d, sentinel, eps)


_ARGTYPES = (
    [ctypes.c_void_p] * 3                 # rays_o, rays_d, z_vals (NULL: uniform)
    + [ctypes.c_longlong]                 # z row stride
    + [ctypes.c_int] * 2                  # n_rays, n_samples
    + [ctypes.c_float] * 2                # near, far - near
    + [ctypes.c_void_p] * 2               # weights (PackedWeights order), scales
    + [ctypes.c_int] * 6 + [ctypes.c_float]   # net_args
    + [ctypes.c_int] * 2                  # composited, raw output form
    + [ctypes.c_float] * 3                # uniform step dz, sentinel, eps
    + [ctypes.c_void_p] * 3               # out, w (NULL: none), stream
)


def _launch(packed, rays_o, rays_d, near, far, S,
            cfg: ModelConfig, z_vals: Optional[torch.Tensor] = None,
            composited: bool = False, with_weights: bool = False,
            sentinel: float = 1e10, eps: float = 1e-10,
            raw_dtype: torch.dtype = torch.float32, planar: bool = False,
            dtype: torch.dtype = torch.bfloat16, library: Optional[str] = None):
    """Launch a ray kernel, in the library ``kernel_library`` picks: depths
    uniform (``z_vals`` None, K1) or per ray (K3), output raw ``[R, 4S]``
    (float32 or bfloat16), planar ``(sigma [R, S], (r, g, b))`` or
    composited ``(out [R, 8], w [R, S] or None)``. ``library`` names
    another library of the same function on the same weight route; only
    ``chip_smoke.py`` passes it, to time the WMMA build
    (``csrc/render_samples.cu``) beside the Hopper kernel."""
    dev = rays_o.device
    R = rays_o.shape[0]
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.shape != (R, 3) or t.device != dev:
            raise ValueError(f"{name} must be float32 [R, 3] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    route = 0
    if quant.is_quantized(packed):
        quant.check_quantized(packed, cfg, dev, dtype)
        route = quant.route_of(packed)
        weights, scales = quant.weight_pointers(packed)
    else:
        check_packed(packed, cfg, dev)
        weights, scales = _ext.pointer_array(packed), None
    if raw_dtype not in (torch.float32, torch.bfloat16) or (
            raw_dtype != torch.float32 and (composited or planar)):
        raise ValueError(f"raw_dtype {raw_dtype}: the raw output is float32 or bfloat16, "
                         "the planar and composited outputs float32")
    if composited and planar:
        raise ValueError("the composited modes have no planar output")
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
    library = library or kernel_library(route, composited)
    hopper = library in ray_wgmma.LIBRARIES.values()
    lib_route = next((r for r, n in (*ray_wgmma.LIBRARIES.items(), *_LIBRARY.items())
                      if n == library), None)
    if lib_route != route:
        raise ValueError(f"{library} computes on {_WEIGHTS.get(lib_route, 'unknown')} weights, "
                         f"not on {_WEIGHTS[route]} ones")
    rays_o = rays_o.contiguous()
    rays_d = rays_d.contiguous()
    if composited:
        out = torch.empty(R, 8, dtype=torch.float32, device=dev)
        w = torch.empty(R, S, dtype=torch.float32, device=dev) if with_weights else None
        result = (out, w)
    elif planar:
        out = torch.empty(4, R, S, dtype=torch.float32, device=dev)
        w = None
        result = out[0], (out[1], out[2], out[3])
    else:
        out = torch.empty(R * S, 4, dtype=raw_dtype, device=dev)
        w = None
        result = out.reshape(R, 4 * S)
    if R == 0:
        return result
    out_mode = (_OUT_PLANAR if planar else
                _OUT_BF16 if raw_dtype == torch.bfloat16 else _OUT_F32)
    z_arg = None if z_vals is None else _ext.ptr(z_vals)
    w_arg = None if w is None else _ext.ptr(w)
    dz = (far - near) / (S - 1) if z_vals is None else 0.0
    if hopper:
        stream = ray_wgmma.stream_for(packed, cfg)
        lib = ray_wgmma.load(library)
        err = lib.ray_wgmma_render(_ext.ptr(rays_o), _ext.ptr(rays_d), z_arg, z_stride, R, S,
                                   float(near), float(far - near), _ext.ptr(stream), weights,
                                   scales, *net_args(cfg), out_mode, int(composited), float(dz),
                                   float(sentinel), float(eps), _ext.ptr(out), w_arg,
                                   _ext.stream_ptr(dev))
    else:
        lib = _ext.load(library)
        fn = lib.ray_render
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(_ext.ptr(rays_o), _ext.ptr(rays_d), z_arg, z_stride, R, S,
                 float(near), float(far - near),
                 weights, scales, *net_args(cfg),
                 int(composited), out_mode, float(dz), float(sentinel), float(eps),
                 _ext.ptr(out), w_arg, _ext.stream_ptr(dev))
    name = ("render_samples" if z_vals is None else "render_zvals") + (
        "_composited" if composited else "")
    _ext.check(lib, err, f"{name} launch ({library})")
    launches[name] += 1
    if hopper:
        launches["wgmma_samples" if z_vals is None else "wgmma_zvals"] += 1
    if planar:
        launches["planar"] += 1
    if out_mode == _OUT_BF16:
        launches["raw_bf16"] += 1
    if route == quant.ROUTE_INT8_COMPUTE:
        launches["int8"] += 1
    elif route:
        launches["dequant"] += 1
    return result


def _packed(params, cfg: ModelConfig, dtype):
    """The weights as the kernels take them: quantized weights and
    ``PackedWeights`` as they are, a params dict packed in ``dtype``."""
    if isinstance(params, PackedWeights) or quant.is_quantized(params):
        return params
    return pack_params(params, cfg, dtype)


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
    planar: bool = False,
    raw_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """Evaluate the network at uniform depths along every ray (K1).

    Returns ``(sigma [R, S], rgb [R, S, 3], z_vals [R, S])``, or with
    ``raw=True`` ``(raw [R, 4S], z_vals)``: the interleaved per-sample
    ``(sigma, r, g, b)`` for ``fused_volume_render_interleaved``, in
    ``raw_dtype`` (float32 or bfloat16). With ``planar=True`` rgb comes back
    as three ``[R, S]`` planes written by the kernel: ``(sigma, (r, g, b),
    z_vals)``, the planar compositor's input. ``params`` is a params dict
    (packed here, in ``dtype``), ``PackedWeights`` or quantized weights
    (computed in ``dtype``). ``z_vals`` is a broadcast view, ``near + (far -
    near) * linspace``."""
    S = n_samples
    assert S >= 2, "need at least 2 samples for the linspace"
    packed = _packed(params, cfg, dtype)
    if rays_o.device.type == "cpu":
        out = fused_render_samples_plain(packed, rays_o, rays_d, near, far, S, cfg, dtype)
        out = planes_of(out) if planar else out.to(raw_dtype if raw else torch.float32)
    else:
        out = _launch(packed, rays_o, rays_d, near, far, S, cfg, dtype=dtype, planar=planar,
                      raw_dtype=raw_dtype if raw and not planar else torch.float32)
    R = rays_o.shape[0]
    t = torch.linspace(0.0, 1.0, S, dtype=torch.float32, device=rays_o.device)
    z_vals = (near + (far - near) * t).expand(R, S)
    if planar:
        return (*out, z_vals)
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
    raw_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Evaluate the network at per-ray depths (K3): ``raw [R, 4S]``, the
    interleaved per-sample ``(sigma, r, g, b)`` for
    ``fused_volume_render_interleaved``, in ``raw_dtype`` (float32 or
    bfloat16)."""
    packed = _packed(params, cfg, dtype)
    if rays_o.device.type == "cpu":
        return fused_render_zvals_plain(packed, rays_o, rays_d, z_vals, cfg,
                                        dtype).to(raw_dtype)
    return _launch(packed, rays_o, rays_d, 0.0, 0.0, z_vals.shape[1], cfg,
                   z_vals=z_vals, raw_dtype=raw_dtype, dtype=dtype)


def fused_render_zvals_planar(
    params: Union[dict, PackedWeights],
    rays_o: torch.Tensor,     # [R, 3]
    rays_d: torch.Tensor,     # [R, 3]
    z_vals: torch.Tensor,     # [R, S]
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
):
    """K3 with planar output: ``(sigma [R, S], (r, g, b))``, three ``[R, S]``
    planes written by the kernel, the planar compositor's input."""
    packed = _packed(params, cfg, dtype)
    if rays_o.device.type == "cpu":
        return planes_of(fused_render_zvals_plain(packed, rays_o, rays_d, z_vals, cfg, dtype))
    return _launch(packed, rays_o, rays_d, 0.0, 0.0, z_vals.shape[1], cfg,
                   z_vals=z_vals, planar=True, dtype=dtype)


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
                                                       far, S, cfg, sentinel, eps, dtype)
    else:
        out, w = _launch(packed, rays_o, rays_d, near, far, S, cfg, composited=True,
                         with_weights=with_weights, sentinel=sentinel, eps=eps,
                         dtype=dtype)
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
                                                     cfg, sentinel, eps, dtype)
    else:
        out, w = _launch(packed, rays_o, rays_d, 0.0, 0.0, z_vals.shape[1], cfg,
                         z_vals=z_vals, composited=True, with_weights=with_weights,
                         sentinel=sentinel, eps=eps, dtype=dtype)
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
