"""Ray-blocked sample generation + NeRF MLP: the fused ray kernels.

Counterparts of ``nerf_tpu/ops/render_kernel.py``:

- ``fused_render_samples`` (K1, the Pallas kernel ``_ray_kernel``) places
  ``S`` uniform depths ``z = near + (far - near) * s / (S - 1)`` per ray;
- ``fused_render_zvals_raw`` (K3, ``_ray_z_kernel``) reads per-ray depths
  ``z_vals [R, S]`` (the hierarchical fine pass); ``fused_render_zvals`` is
  K3 in its plain output form, ``(sigma [R, S], rgb [R, S, 3])``, and
  differentiable in the weights (the backward is the network's at the
  points ``o + d z``: K5 on the card for the reference variant).

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
``_weights_for``): ``QuantizedPackedWeights`` are dequantized on chip once a
call, into scratch the bf16 kernels then read (``ops/dequant_stream.py``),
``Int8PackedWeights`` run the trunk as s8 x s8 -> s32 tensor-core products
in a build of their own.

On a CUDA tensor each wrapper launches its CUDA kernel and counts the launch
in ``launches[name]``; on a CPU tensor it runs its ``*_plain`` twin, the same
arithmetic in plain PyTorch. Nothing falls back: a CUDA launch either runs
or raises. Under a profiler each call records one span, ``kernel.k1`` or
``kernel.k3`` (``utils/monitor.span``), from that choice until the launch
is enqueued. Which kernel (``kernel_library``): every form and mode, on every
weight route, goes to the Hopper kernels of ``csrc/ray_wgmma.cu`` (warpgroup
``wgmma``, weights streamed by a producer warpgroup, persistent blocks; the
weight stream is laid out once per set of weights, and the composited
modes' schedule of whole rays per consumer is written out, by
``ops/ray_wgmma.py``), in the build of the weights' route: the bf16 build
for bf16 weights and, after the ``dequant_stream`` prologue, for int8 and
int16 ones; the int8-compute build. K3 at one depth per ray runs each ray
as one row of the per-sample kernel of that build (``mlp_wgmma_kernel``),
composited by K2.

The mip variant (Mip-NeRF, ``models/mip.py``) has two ray kernels of its
own on the same body (``csrc/ray_wgmma.cu``, bf16 weights, raw output
only): ``fused_render_mip_raw`` (K1-mip, ``ray_mip_wgmma_kernel``) at
uniform intervals between near and far, ``fused_render_edges_mip_raw``
(K3-mip, ``ray_z_mip_wgmma_kernel``) at per-ray edges ``[R, S + 1]``; a row
is an interval of its ray's cone, encoded by the integrated positional
encoding of its Gaussian. Their plain twins ``fused_render_mip_plain`` and
``fused_render_edges_mip_plain``; spans ``kernel.k1`` and ``kernel.k3``;
launches ``render_mip`` and ``render_edges_mip``.

Mip-NeRF 360 (``models/mip360.py``): ``fused_render_prop_mip360`` runs its
proposal network at per-ray metric edges on the same body
(``ray_z_prop360_wgmma_kernel``; plain twin
``fused_render_prop_mip360_plain``; span ``kernel.prop``; launches
``prop_mip360``): density ``[R, S]`` alone. Its NeRF pass
(``ops/mip360_kernel.nerf_mip360_raw``, span ``kernel.nerf``) counts its
calls under ``nerf_mip360``.

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
from nerf_tpu_torch.models.encoding import (
    N_BASIS,
    cast_intervals,
    encode_intervals_360,
    integrated_pos_enc,
    mip_dir_encoding,
)
from nerf_tpu_torch.models.mip import softplus
from nerf_tpu_torch.models.nerf import apply_nerf
from nerf_tpu_torch.ops import _ext, composite_kernel, mlp_kernel, quant, ray_wgmma, train_kernel
from nerf_tpu_torch.ops.composite_kernel import fused_volume_render_interleaved_plain
from nerf_tpu_torch.ops.mip360_kernel import ENC_K, PropWeights, prop_fits
from nerf_tpu_torch.ops.mlp_kernel import (
    DIR_ROWS,
    MIP_ROWS,
    PackedWeights,
    check_packed,
    fused_nerf_apply_plain,
    net_args,
    pack_params,
    skip_position,
)
from nerf_tpu_torch.utils.device import disable_tf32
from nerf_tpu_torch.utils.monitor import span
from nerf_tpu_torch.utils.rendering import RenderOutputs, uniform_edges
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

# Launches of each CUDA kernel (not of the plain versions), and of the
# routes through them: a launch adds one to its function's count (K1 or K3,
# raw or composited), and to each route it takes (planar or bfloat16 raw
# output; intN weights dequantized on chip; int8 compute). A launch recorded
# into a CUDA graph is not one (_ext.ran).
launches = {"render_samples": 0, "render_zvals": 0,
            "render_samples_composited": 0, "render_zvals_composited": 0,
            "planar": 0, "raw_bf16": 0, "dequant": 0, "int8": 0,
            "render_mip": 0, "render_edges_mip": 0, "prop_mip360": 0, "nerf_mip360": 0}

_OUT_F32, _OUT_BF16, _OUT_PLANAR = 0, 1, 2


def kernel_library(route: int, composited: bool) -> str:
    """The library a CUDA launch on a weight route goes to: the route's
    build of ``csrc/ray_wgmma.cu`` (the bf16 build on the dequantize
    routes, after ``dequant_stream``), for the raw forms (float32, bfloat16,
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


def _launch(packed, rays_o, rays_d, near, far, S,
            cfg: ModelConfig, z_vals: Optional[torch.Tensor] = None,
            composited: bool = False, with_weights: bool = False,
            sentinel: float = 1e10, eps: float = 1e-10,
            raw_dtype: torch.dtype = torch.float32, planar: bool = False,
            dtype: torch.dtype = torch.bfloat16):
    """Launch a ray kernel, in the library ``kernel_library`` picks: depths
    uniform (``z_vals`` None, K1) or per ray (K3), output raw ``[R, 4S]``
    (float32 or bfloat16), planar ``(sigma [R, S], (r, g, b))`` or
    composited ``(out [R, 8], w [R, S] or None)``."""
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
    else:
        check_packed(packed, cfg, dev)
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
    if z_vals is not None and S == 1:
        return _one_depth(packed, rays_o, rays_d, z_vals, cfg, composited, with_weights,
                          sentinel, eps, raw_dtype, planar, dtype)
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
    library = kernel_library(route, composited)
    stream, weights, scales, scratch = ray_wgmma.launch_operands(
        packed, cfg, ray_wgmma.stream_for(packed, cfg), False)
    lib = ray_wgmma.load(library)
    err = lib.ray_wgmma_render(_ext.ptr(rays_o), _ext.ptr(rays_d), z_arg, z_stride, R, S,
                               float(near), float(far - near), _ext.ptr(stream), weights,
                               scales, *net_args(cfg), out_mode, int(composited), float(dz),
                               float(sentinel), float(eps), _ext.ptr(out), w_arg,
                               _ext.stream_ptr(dev))
    del scratch
    name = ("render_samples" if z_vals is None else "render_zvals") + (
        "_composited" if composited else "")
    _ext.check(lib, err, f"{name} launch ({library})")
    ran = _ext.ran()
    launches[name] += ran
    if planar:
        launches["planar"] += ran
    if out_mode == _OUT_BF16:
        launches["raw_bf16"] += ran
    if route == quant.ROUTE_INT8_COMPUTE:
        launches["int8"] += ran
    elif route:
        launches["dequant"] += ran
    return result


def _one_depth(packed, rays_o, rays_d, z_vals, cfg, composited, with_weights, sentinel, eps,
               raw_dtype, planar, dtype):
    """K3 at one depth per ray, in every form: each ray is one row of the
    per-sample kernel of the weights' route (``mlp_wgmma_kernel``, K4 / K7 /
    K8, counted by ``mlp_kernel`` or ``quant``), composited by K2. The ray
    kernels size their direction region for ``63 / S + 2`` rays a consumer,
    which at S = 1 leaves the int16 and int8-compute builds too few ring
    stages; the per-sample kernel reads a direction per row anyway."""
    pos = rays_o + rays_d * z_vals                    # the plain version's o + d * z
    if quant.is_quantized(packed):
        raw = quant._launch(packed, pos, rays_d, cfg, dtype)
    else:
        raw = mlp_kernel._launch(packed, pos, rays_d, cfg)
    if composited:
        return composite_kernel._launch(raw, z_vals, rays_d, sentinel, eps, with_weights)
    return planes_of(raw) if planar else raw.to(raw_dtype)


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
    with span("kernel.k1"):
        if rays_o.device.type == "cpu":
            out = fused_render_samples_plain(packed, rays_o, rays_d, near, far, S, cfg, dtype)
            out = planes_of(out) if planar else out.to(raw_dtype if raw else torch.float32)
        else:
            out = _launch(packed, rays_o, rays_d, near, far, S, cfg, dtype=dtype,
                          planar=planar,
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
    with span("kernel.k3"):
        if rays_o.device.type == "cpu":
            return fused_render_zvals_plain(packed, rays_o, rays_d, z_vals, cfg,
                                            dtype).to(raw_dtype)
        return _launch(packed, rays_o, rays_d, 0.0, 0.0, z_vals.shape[1], cfg,
                       z_vals=z_vals, raw_dtype=raw_dtype, dtype=dtype)


def _zvals_split(packed, rays_o, rays_d, z_vals, cfg: ModelConfig, dtype):
    """K3 (its plain version on CPU tensors) as ``(sigma [R, S], rgb [R, S,
    3])``, views of the raw ``[R, 4S]`` output."""
    R, S = z_vals.shape
    out = fused_render_zvals_raw(packed, rays_o, rays_d, z_vals, cfg, dtype).reshape(R, S, 4)
    return out[..., 0], out[..., 1:4]


class _ZvalsApply(torch.autograd.Function):
    """Forward: K3. Backward: the network's at the points ``o + d z``,
    recomputed from the saved rays and depths (the JAX package's
    ``_zvals_bwd``): for the reference variant K5 on the card and its plain
    version on the CPU (``train_kernel.packed_grads`` on the forward's
    packed weights), for bmild, which K5 does not compute, autograd of
    ``apply_nerf`` in the compute dtype (the JAX backward itself). The rays
    and depths are data: their cotangents are zeros. ``spec = (cfg, dtype,
    paths)``; the parameter leaves come flat, in ``tree_leaves``' order."""

    @staticmethod
    def forward(ctx, rays_o, rays_d, z_vals, spec, *leaves):
        cfg, dtype, paths = spec
        ctx.spec = spec
        ctx.save_for_backward(rays_o, rays_d, z_vals, *leaves)
        ctx.packed = pack_params(tree_from_leaves(paths, leaves), cfg, dtype)
        return _zvals_split(ctx.packed, rays_o, rays_d, z_vals, cfg, dtype)

    @staticmethod
    def backward(ctx, d_sigma, d_rgb):
        cfg, dtype, paths = ctx.spec
        rays_o, rays_d, z_vals, *leaves = ctx.saved_tensors
        o, d, z = rays_o.float(), rays_d.float(), z_vals.float()
        pos = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        dirs = d.repeat_interleave(z.shape[1], dim=0)
        if cfg.variant == "reference":
            g = train_kernel.packed_grads(ctx.packed, pos, dirs,
                                          d_sigma.reshape(-1).float().contiguous(),
                                          d_rgb.reshape(-1, 3).float().contiguous(), cfg)
            by_path = dict(tree_leaves(train_kernel.unpack_grads(g, cfg)))
            grads = [by_path[p] for p in paths]
        else:
            with torch.enable_grad():
                leaves = [leaf.detach().requires_grad_() for leaf in leaves]
                out = apply_nerf(tree_from_leaves(paths, leaves), pos, dirs, cfg,
                                 compute_dtype=dtype)
                grads = torch.autograd.grad(out, leaves, (d_sigma.reshape(-1),
                                                          d_rgb.reshape(-1, 3)),
                                            allow_unused=True)
        zeros = [torch.zeros_like(t) if need else None
                 for t, need in zip((rays_o, rays_d, z_vals), ctx.needs_input_grad)]
        return (*zeros, None, *grads)


def fused_render_zvals(
    params: Union[dict, PackedWeights],
    rays_o: torch.Tensor,     # [R, 3]
    rays_d: torch.Tensor,     # [R, 3]
    z_vals: torch.Tensor,     # [R, S]
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the network at per-ray depths (K3): ``(sigma [R, S], rgb [R,
    S, 3])``, views of one ``[R, 4S]`` buffer. A params dict is packed here,
    in ``dtype``, and is differentiable: gradients reach the params, and the
    cotangents of ``rays_o``, ``rays_d`` and ``z_vals`` are zeros, as in the
    JAX package (importance depths are data). ``PackedWeights`` and the
    quantized weights of ``ops/quant.py`` are forward-only: the JAX
    backward differentiates ``apply_nerf`` in a params dict, which they are
    not."""
    if isinstance(params, PackedWeights) or quant.is_quantized(params):
        return _zvals_split(params, rays_o, rays_d, z_vals, cfg, dtype)
    paths, leaves = zip(*tree_leaves(params))
    return _ZvalsApply.apply(rays_o, rays_d, z_vals, (cfg, dtype, paths), *leaves)


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
    with span("kernel.k3"):
        if rays_o.device.type == "cpu":
            return planes_of(fused_render_zvals_plain(packed, rays_o, rays_d, z_vals, cfg,
                                                      dtype))
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
    with span("kernel.k1"):
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
    with span("kernel.k3"):
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


# -- the mip variant's ray kernels (K1-mip, K3-mip) ---------------------------

def _mip_plain(packed: PackedWeights, rays_o, rays_d, radius: float, edges: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """The mip kernels' arithmetic on the intervals ``edges [R, S + 1]``:
    ``raw [R, 4S]``, per interval ``(density, r, g, b)``. The frustum's
    Gaussian and its IPE in float32 (``models/encoding.py``), rounded to the
    compute dtype of the packed matrices only as a product's operand; the
    trunk, the skip product, the bottleneck and the color layer as
    ``fused_nerf_apply_plain`` computes them; the mip heads on the float32
    sums; view directions ``d * rsqrt(|d|^2 + 1e-12)``."""
    disable_tf32()
    o, d = rays_o.float(), rays_d.float()
    R, S = edges.shape[0], edges.shape[1] - 1
    dt = packed.w0.dtype

    def mm(a, w):
        return a.to(dt).float() @ w.float()

    r = torch.full((R,), radius, dtype=torch.float32, device=o.device)
    mean, cov = cast_intervals(o, d, r, edges.float())
    enc = integrated_pos_enc(mean, cov, cfg.ipe_min_deg, cfg.ipe_max_deg).reshape(R * S, -1)
    enc = torch.nn.functional.pad(enc, (0, MIP_ROWS - enc.shape[1])).to(dt)
    h = torch.relu(mm(enc, packed.w0) + packed.b0).to(dt)
    skip_pos = skip_position(cfg)
    for i in range(1, 8):
        y = mm(h, packed.wt[i - 1])
        if i == skip_pos:
            y = y + mm(enc, packed.wskip)
        h = torch.relu(y + packed.bt[i - 1]).to(dt)
    sigma = softplus(mm(h, packed.wsig[:, None])[:, 0] + packed.bsig + cfg.density_bias)
    dn = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
    denc = torch.nn.functional.pad(mip_dir_encoding(dn, cfg.dir_freqs),
                                   (0, DIR_ROWS - cfg.dir_dim)).to(dt)
    feat = mm(h, packed.wbn) + packed.bbn
    c_pre = mm(feat, packed.wc0) + mm(denc, packed.wdir).repeat_interleave(S, dim=0) + packed.bc0
    c = torch.relu(c_pre).to(dt)
    rgb = torch.sigmoid(mm(c, packed.wc1) + packed.bc1)
    rgb = rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding
    return torch.cat([sigma[:, None], rgb], dim=-1).reshape(R, 4 * S)


def fused_render_mip_plain(packed: PackedWeights, rays_o, rays_d, radius: float, near: float,
                           far: float, n_intervals: int, cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch version of K1-mip (``ray_mip_wgmma_kernel``): the
    network at ``n_intervals`` uniform intervals between ``near`` and
    ``far`` (``utils/rendering.uniform_edges``), ``raw [R, 4S]`` float32."""
    edges = uniform_edges(near, far, n_intervals + 1, rays_o.device)
    return _mip_plain(packed, rays_o, rays_d, radius,
                      edges.expand(rays_o.shape[0], n_intervals + 1), cfg)


def fused_render_edges_mip_plain(packed: PackedWeights, rays_o, rays_d, radius: float,
                                 edges: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch version of K3-mip (``ray_z_mip_wgmma_kernel``): the
    network at per-ray intervals ``edges [R, S + 1]``, ``raw [R, 4S]``."""
    return _mip_plain(packed, rays_o, rays_d, radius, edges, cfg)


def _launch_mip(packed, rays_o, rays_d, radius, near, far, S, cfg: ModelConfig,
                edges: Optional[torch.Tensor] = None, raw_dtype: torch.dtype = torch.float32):
    """Launch K1-mip (``edges`` None: ``S`` uniform intervals) or K3-mip
    (``edges [R, S + 1]``, unit stride along the ray) on bf16
    ``PackedWeights``: ``raw [R, 4S]`` in ``raw_dtype``."""
    dev = rays_o.device
    R = rays_o.shape[0]
    if cfg.variant != "mip" or (cfg.ipe_min_deg, cfg.ipe_max_deg) != (0, 16):
        raise ValueError("the mip kernels compute the mip variant at IPE degrees 0..15")
    if not isinstance(packed, PackedWeights):
        raise ValueError("the mip kernels take bf16 PackedWeights (no quantized route)")
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.shape != (R, 3) or t.device != dev:
            raise ValueError(f"{name} must be float32 [R, 3] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    check_packed(packed, cfg, dev)
    if raw_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"raw_dtype {raw_dtype}: the raw output is float32 or bfloat16")
    stride = 0
    if edges is not None:
        if (edges.dtype != torch.float32 or edges.device != dev
                or edges.shape != (R, S + 1) or edges.stride(1) != 1):
            raise ValueError(f"edges must be float32 [R, S + 1] = {(R, S + 1)} with unit "
                             f"stride along the ray on {dev}, got {edges.dtype} "
                             f"{tuple(edges.shape)} on {edges.device}")
        stride = edges.stride(0)
    if S < 1:
        raise ValueError("need at least one interval a ray")
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    out = torch.empty(R * S, 4, dtype=raw_dtype, device=dev)
    if R == 0:
        return out.reshape(R, 4 * S)
    lib = ray_wgmma.load()
    stream = ray_wgmma.stream_for(packed, cfg)
    err = lib.ray_mip_wgmma_render(
        _ext.ptr(rays_o), _ext.ptr(rays_d), None if edges is None else _ext.ptr(edges), stride,
        R, S, float(near), float(far), float(radius), _ext.ptr(stream),
        _ext.pointer_array(packed), *net_args(cfg), float(cfg.density_bias),
        float(1 + 2 * cfg.rgb_padding), float(cfg.rgb_padding),
        _OUT_BF16 if raw_dtype == torch.bfloat16 else _OUT_F32, _ext.ptr(out),
        _ext.stream_ptr(dev))
    name = "render_mip" if edges is None else "render_edges_mip"
    _ext.check(lib, err, f"{name} launch ({ray_wgmma.LIBRARY})")
    ran = _ext.ran()
    launches[name] += ran
    if raw_dtype == torch.bfloat16:
        launches["raw_bf16"] += ran
    return out.reshape(R, 4 * S)


def fused_render_mip_raw(params, rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float,
                         near: float, far: float, n_intervals: int, cfg: ModelConfig,
                         dtype: torch.dtype = torch.bfloat16,
                         raw_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The mip network at ``n_intervals`` uniform intervals between ``near``
    and ``far`` of every ray's cone (K1-mip, ``ray_mip_wgmma_kernel``),
    base radius ``radius``: ``raw [R, 4S]``, per interval ``(density, r, g,
    b)``, in ``raw_dtype``. ``params``: a params dict (packed here, in
    ``dtype``) or ``PackedWeights``."""
    packed = _packed(params, cfg, dtype)
    with span("kernel.k1"):
        if rays_o.device.type == "cpu":
            return fused_render_mip_plain(packed, rays_o, rays_d, radius, near, far,
                                          n_intervals, cfg).to(raw_dtype)
        return _launch_mip(packed, rays_o, rays_d, radius, near, far, n_intervals, cfg,
                           raw_dtype=raw_dtype)


def fused_render_edges_mip_raw(params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                               radius: float, edges: torch.Tensor, cfg: ModelConfig,
                               dtype: torch.dtype = torch.bfloat16,
                               raw_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The mip network at per-ray intervals ``edges [R, S + 1]`` (K3-mip,
    ``ray_z_mip_wgmma_kernel``): ``raw [R, 4S]`` in ``raw_dtype``."""
    packed = _packed(params, cfg, dtype)
    with span("kernel.k3"):
        if rays_o.device.type == "cpu":
            return fused_render_edges_mip_plain(packed, rays_o, rays_d, radius, edges,
                                                cfg).to(raw_dtype)
        return _launch_mip(packed, rays_o, rays_d, radius, 0.0, 0.0, edges.shape[1] - 1, cfg,
                           edges=edges, raw_dtype=raw_dtype)


# -- Mip-NeRF 360's proposal network (the ray kernels' body) ----------------------

def fused_render_prop_mip360_plain(packed: PropWeights, rays_o, rays_d, radius: float,
                                   edges: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Plain-PyTorch version of ``ray_z_prop360_wgmma_kernel``: the proposal
    network at the intervals between the metric ``edges [R, S + 1]``,
    ``density [R, S]`` float32. The encoding in float32, each product on
    bf16 operands summed in float32, the bias added before the rounding;
    density ``softplus(h . wsig + bsig + density_bias)``."""
    disable_tf32()
    o, d = rays_o.float(), rays_d.float()
    R, S = edges.shape[0], edges.shape[1] - 1
    bf = torch.bfloat16

    def mm(a, w):
        return a.to(bf).float() @ w.float()

    r = torch.full((R,), radius, dtype=torch.float32, device=o.device)
    enc = encode_intervals_360(o, d, r, edges.float(), cfg.ipe_min_deg,
                               cfg.ipe_max_deg).reshape(R * S, -1)
    enc = torch.nn.functional.pad(enc, (0, ENC_K - enc.shape[1]))
    h = torch.relu(mm(enc, packed.w0) + packed.b0).to(bf)
    for i in range(packed.wt.shape[0]):
        h = torch.relu(mm(h, packed.wt[i]) + packed.bt[i]).to(bf)
    density = softplus((mm(h, packed.wsig[:, None])[:, 0] + packed.bsig) + cfg.density_bias)
    return density.reshape(R, S)


_PROP_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                  + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                  + [ctypes.c_float] + [ctypes.c_void_p] * 2)


def _launch_prop(packed: PropWeights, rays_o, rays_d, radius: float, edges, cfg: ModelConfig
                 ) -> torch.Tensor:
    dev = rays_o.device
    R, S = edges.shape[0], edges.shape[1] - 1
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.shape != (R, 3) or t.device != dev:
            raise ValueError(f"{name} must be float32 [R, 3] on {dev}")
    if edges.dtype != torch.float32 or edges.device != dev or edges.stride(1) != 1 or S < 1:
        raise ValueError("edges must be float32 [R, S + 1] with unit stride along the ray")
    if not prop_fits(cfg) or packed.stream.numel() == 0:
        raise ValueError("the proposal entry computes the mip360 variant's 4 x 256 network on "
                         "at most 512 encoding features from degree 0")
    if packed.stream.device != dev:
        raise ValueError(f"the proposal weights must be on {dev}")
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    out = torch.empty(R, S, dtype=torch.float32, device=dev)
    if R == 0:
        return out
    lib = ray_wgmma.load()
    fn = lib.ray_prop360_wgmma_render
    fn.argtypes = _PROP_ARGTYPES
    fn.restype = ctypes.c_int
    weights = [packed.w0, packed.b0, packed.wt, packed.bt, packed.wskip, packed.wsig,
               packed.bsig, packed.wbn, packed.bbn, packed.wc0, packed.basis, packed.wdir,
               packed.wc1, packed.bc1]
    err = fn(_ext.ptr(rays_o), _ext.ptr(rays_d), _ext.ptr(edges), edges.stride(0), R, S,
             float(radius), _ext.ptr(packed.stream), _ext.pointer_array(weights),
             cfg.ipe_max_deg - cfg.ipe_min_deg, N_BASIS, float(cfg.density_bias), _ext.ptr(out),
             _ext.stream_ptr(dev))
    _ext.check(lib, err, f"ray_prop360_wgmma_render launch ({ray_wgmma.LIBRARY})")
    launches["prop_mip360"] += _ext.ran()
    return out


def fused_render_prop_mip360(packed: PropWeights, rays_o: torch.Tensor, rays_d: torch.Tensor,
                             radius: float, edges: torch.Tensor, cfg: ModelConfig
                             ) -> torch.Tensor:
    """Mip-NeRF 360's proposal network at the intervals between the metric
    ``edges [R, S + 1]`` of every ray's cone, base radius ``radius``
    (``ray_z_prop360_wgmma_kernel``): ``density [R, S]`` float32."""
    with span("kernel.prop"):
        if rays_o.device.type == "cpu":
            return fused_render_prop_mip360_plain(packed, rays_o, rays_d, radius, edges, cfg)
        return _launch_prop(packed, rays_o, rays_d, radius, edges, cfg)
