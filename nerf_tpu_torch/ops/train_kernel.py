"""Fused NeRF MLP backward (K5) and the training evaluator built on it.

Counterpart of ``nerf_tpu/ops/train_kernel.py``:

- ``packed_grads`` (the Pallas kernel ``_bwd_kernel``, ``_packed_grads``):
  from positions, directions ``[N, 3]`` and the cotangents ``dsigma [N]``,
  ``drgb [N, 3]`` it recomputes the forward and returns the gradient of
  every weight and bias in ``pack_params``' layout. Reference variant only,
  as the TPU kernel. On CUDA tensors it launches ``csrc/mlp_backward.cu``
  and counts the launch in ``launches``; on CPU tensors it runs
  ``packed_grads_plain``, the same arithmetic in plain PyTorch. Nothing
  falls back: a CUDA launch either runs or raises.
- ``unpack_grads`` maps those to the params tree: the skip layer's hidden
  and encoding rows are joined again, as are the color layer's trunk and
  direction rows, and the zero-padded encoding rows (63 -> 64, 27 -> 32)
  are dropped. The port's layout has no row permutation to invert.
- ``fused_train_apply`` is the drop-in for ``apply_nerf`` in the train
  step: forward K4 (``ops/mlp_kernel.py``), backward K5. Positions and
  directions get no gradient: they are data in NeRF training.

Roundings, shared by the kernel and the plain version (the TPU kernel's):
every cotangent that enters a product (``dz1``, ``dc_pre``, ``dsigma_pre``,
``dpre_i``) is rounded to the compute dtype first, bias gradients sum those
rounded values in float32, and ReLU masks read the rounded activations. The
forward recompute is K4's arithmetic (float32 bias before the rounding). In
float32 compute the plain version is exact backpropagation.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import NeRFParams
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.ops.mlp_kernel import (
    DIR_ROWS,
    HID,
    POS_ROWS,
    PackedWeights,
    apply_forward,
    check_packed,
    flat_inputs,
    fused_nerf_apply_plain,
    net_args,
    pack_params,
    skip_position,
)
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

# Launches of the CUDA kernel (not of the plain version).
launches = 0

TILE = 128   # rows per tile of the kernel
# Packed-layout gradients, in the order the C entry point takes them.
GRAD_SHAPES = {
    "d_w0": (POS_ROWS, HID), "d_b0": (HID,), "d_wt": (7, HID, HID), "d_bt": (7, HID),
    "d_wskip": (POS_ROWS, HID), "d_wsig": (HID,), "d_bsig": (1,),
    "d_wc0": (HID, HID // 2), "d_bc0": (HID // 2,), "d_wdir": (DIR_ROWS, HID // 2),
    "d_wc1": (HID // 2, 3), "d_bc1": (3,),
}


def _require_reference(cfg: ModelConfig) -> None:
    if cfg.variant != "reference":
        raise ValueError("the backward kernel is written for the reference variant "
                         "(the one training uses); use fused_nerf_apply for bmild")


def packed_grads_plain(packed: PackedWeights, positions, directions, dsigma, drgb,
                       cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Plain-PyTorch version of the kernel: packed-layout gradients, keyed as
    ``GRAD_SHAPES``, float32."""
    _require_reference(cfg)
    dt = packed.w0.dtype
    keep: dict = {}
    fused_nerf_apply_plain(packed, positions, directions, cfg, keep)
    enc, denc, hs, c, rgb = (keep[k] for k in ("enc", "denc", "hs", "c", "rgb"))

    def rnd(x):                    # a cotangent as it enters a product
        return x.to(dt).float()

    def wgrad(x, dy):              # x [N, in], dy [N, out] -> [in, out]
        return x.float().t() @ dy

    def dgrad(dy, w):              # dy [N, out], w [in, out] -> [N, in]
        return dy @ w.float().t()

    g = {}
    dz1 = rnd(drgb.float() * rgb * (1.0 - rgb))                         # sigmoid'
    g["d_wc1"] = wgrad(c, dz1)
    g["d_bc1"] = dz1.sum(0)
    dc_pre = rnd(torch.where(c.float() > 0, dgrad(dz1, packed.wc1), 0.0))
    g["d_wdir"] = wgrad(denc, dc_pre)
    dsig_pre = rnd(torch.where(keep["sigma_raw"] > 0, dsigma.float(), 0.0))
    g["d_wc0"] = wgrad(hs[7], dc_pre)
    g["d_bc0"] = dc_pre.sum(0)
    g["d_wsig"] = wgrad(hs[7], dsig_pre[:, None])[:, 0]
    g["d_bsig"] = dsig_pre.sum(0, keepdim=True)
    dh = dgrad(dc_pre, packed.wc0) + dsig_pre[:, None] * packed.wsig.float()[None, :]

    skip_pos = skip_position(cfg)
    d_wt, d_bt = [None] * 7, [None] * 7
    for i in range(7, 0, -1):
        dpre = rnd(torch.where(hs[i].float() > 0, dh, 0.0))
        d_wt[i - 1] = wgrad(hs[i - 1], dpre)
        d_bt[i - 1] = dpre.sum(0)
        if i == skip_pos:
            g["d_wskip"] = wgrad(enc, dpre)
        dh = dgrad(dpre, packed.wt[i - 1])
    dpre0 = rnd(torch.where(hs[0].float() > 0, dh, 0.0))
    g["d_w0"] = wgrad(enc, dpre0)
    g["d_b0"] = dpre0.sum(0)
    g["d_wt"], g["d_bt"] = torch.stack(d_wt), torch.stack(d_bt)
    return {k: g[k] for k in GRAD_SHAPES}


_ARGTYPES = (
    [ctypes.c_void_p] * 4                 # positions, directions, dsigma, drgb
    + [ctypes.c_longlong]                 # N
    + [ctypes.c_void_p]                   # weights (PackedWeights order)
    + [ctypes.c_int] * 6 + [ctypes.c_float]   # net_args
    + [ctypes.c_void_p] * 2               # activation scratch, gradient arrays
    + [ctypes.c_int]                      # blocks
    + [ctypes.c_void_p]                   # stream
)


def _launch(packed: PackedWeights, positions, directions, dsigma, drgb,
            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Launch ``csrc/mlp_backward.cu``: a persistent grid of at most one
    block per SM, each with its own float32 copy of every gradient and a
    scratch for the activations of one tile; the copies are summed here."""
    global launches
    _require_reference(cfg)
    dev = positions.device
    n = positions.shape[0]
    for name, t, shape in (("positions", positions, (n, 3)), ("directions", directions, (n, 3)),
                           ("dsigma", dsigma, (n,)), ("drgb", drgb, (n, 3))):
        if t.dtype != torch.float32 or t.shape != shape or t.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    check_packed(packed, cfg, dev)
    if n == 0:
        return {k: torch.zeros(s, dtype=torch.float32, device=dev)
                for k, s in GRAD_SHAPES.items()}
    positions, directions = positions.contiguous(), directions.contiguous()
    dsigma, drgb = dsigma.contiguous(), drgb.contiguous()
    blocks = min(-(-n // TILE), torch.cuda.get_device_properties(dev).multi_processor_count)
    grads = [torch.zeros(blocks, *s, dtype=torch.float32, device=dev)
             for s in GRAD_SHAPES.values()]
    lib = _ext.load("mlp_backward")
    lib.mlp_backward_scratch_elems.restype = ctypes.c_longlong
    scratch = torch.empty(blocks, lib.mlp_backward_scratch_elems(), dtype=torch.bfloat16,
                          device=dev)
    fn = lib.mlp_backward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(_ext.ptr(positions), _ext.ptr(directions), _ext.ptr(dsigma), _ext.ptr(drgb), n,
             _ext.pointer_array(packed), *net_args(cfg), _ext.ptr(scratch),
             _ext.pointer_array(grads), blocks, _ext.stream_ptr(dev))
    _ext.check(lib, err, "mlp_backward launch")
    launches += 1
    return {k: g.sum(0) for k, g in zip(GRAD_SHAPES, grads)}


def packed_grads(packed: PackedWeights, positions, directions, dsigma, drgb,
                 cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Packed-layout gradients from flat float32 inputs: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if positions.device.type == "cpu":
        return packed_grads_plain(packed, positions, directions, dsigma, drgb, cfg)
    return _launch(packed, positions, directions, dsigma, drgb, cfg)


def unpack_grads(g: Dict[str, torch.Tensor], cfg: ModelConfig) -> NeRFParams:
    """Packed-layout gradients -> params-tree gradients (reference variant)."""
    _require_reference(cfg)
    skip_pos = skip_position(cfg)
    trunk = [{"w": g["d_w0"][:cfg.pos_dim], "b": g["d_b0"]}]
    for i in range(1, 8):
        w = g["d_wt"][i - 1]
        if i == skip_pos:                          # [h, enc] rows
            w = torch.cat([w, g["d_wskip"][:cfg.pos_dim]])
        trunk.append({"w": w, "b": g["d_bt"][i - 1]})
    return {
        "trunk": trunk,
        "density": {"w": g["d_wsig"][:, None], "b": g["d_bsig"]},
        "color0": {"w": torch.cat([g["d_wc0"], g["d_wdir"][:cfg.dir_dim]]), "b": g["d_bc0"]},
        "color1": {"w": g["d_wc1"], "b": g["d_bc1"]},
    }


class _TrainApply(torch.autograd.Function):
    """Forward K4, backward K5; the parameter leaves come flat, in
    ``tree_leaves``' order, and their gradients go back in the same order."""

    forward = staticmethod(apply_forward)

    @staticmethod
    def backward(ctx, d_sigma, d_rgb):
        cfg, dtype, paths = ctx.spec
        pos, dirs, *leaves = ctx.saved_tensors
        packed = pack_params(tree_from_leaves(paths, leaves), cfg, dtype)
        g = packed_grads(packed, pos, dirs, d_sigma.float().contiguous(),
                         d_rgb.float().contiguous(), cfg)
        by_path = dict(tree_leaves(unpack_grads(g, cfg)))
        return (None, None, None, *(by_path[p] for p in paths))


def fused_train_apply(params: NeRFParams, positions: torch.Tensor, directions: torch.Tensor,
                      cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_nerf`` drop-in whose forward and backward are kernels:
    ``(sigma [...], rgb [..., 3])`` from ``positions``/``directions
    [..., 3]``."""
    _require_reference(cfg)
    lead = positions.shape[:-1]
    pos, dirs = flat_inputs(positions, directions)
    paths, leaves = zip(*tree_leaves(params))
    sigma, rgb = _TrainApply.apply(pos, dirs, (cfg, dtype, paths), *leaves)
    return sigma.reshape(lead), rgb.reshape(*lead, 3)


def make_train_apply_fn(dtype: torch.dtype = torch.bfloat16):
    """Adapter matching ``render_rays``' ``apply_fn`` signature; the compute
    dtype is the kernels', not the caller's."""

    def apply_fn(params, positions, directions, cfg, compute_dtype=None):
        return fused_train_apply(params, positions, directions, cfg, dtype)

    return apply_fn
