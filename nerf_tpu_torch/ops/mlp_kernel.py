"""The per-sample fused NeRF MLP (K4) and the kernels' weight layout.

Counterpart of ``nerf_tpu/ops/mlp_kernel.py``:

- ``fused_nerf_apply`` (the Pallas kernel ``_nerf_kernel``) is a drop-in for
  ``apply_nerf``: positions and directions ``[..., 3]`` in, ``(sigma [...],
  rgb [..., 3])`` out, both variants. On a CUDA tensor it launches the
  per-sample Hopper kernel of ``csrc/ray_wgmma.cu`` (``mlp_wgmma_forward``:
  warpgroup ``wgmma``, a producer warpgroup streaming the weights, persistent
  blocks; its weight stream from ``ops/ray_wgmma.py``) and counts the launch
  in ``launches``; on a CPU tensor it runs ``fused_nerf_apply_plain``, the
  same arithmetic in plain PyTorch. Nothing falls back: a CUDA launch either
  runs or raises. Under a profiler each ``mlp_forward`` call records one
  span ``kernel.k4`` (``utils/monitor.span``), from that choice until the
  launch is enqueued. Its gradient, as in the JAX
  package, is a recompute through ``apply_nerf`` under autograd; gradients
  reach the params only.
- ``pack_params`` lays the weights out for every kernel that evaluates the
  network (this one, the ray kernels of ``ops/render_kernel.py`` and the
  backward kernel of ``ops/train_kernel.py``), in a layout chosen for the
  CUDA kernels rather than the TPU's:

  - encodings keep the reference column order (``[x, sin f0x, cos f0x, ...]``)
    and are padded with zero weight rows to a multiple of the 16-wide tensor
    core step: 63 -> 64 position rows, 27 -> 32 direction rows. No
    permutation and no half-angle ladder: the kernels evaluate
    ``sinf``/``cosf`` of each phase directly.
  - the skip layer is split into its hidden rows (``wt``) and encoding rows
    (``wskip``), accumulated into one product, for either variant's concat
    order.
  - the density column is its own vector (``wsig``); the color branch is
    ``wc0`` (rows for the trunk output, or for the bmild bottleneck) plus
    ``wdir`` (rows for the direction encoding).
  - matrices are stored in the compute dtype (bf16 for the kernels), biases
    in float32: the kernels' epilogue adds a float32 bias to the float32
    accumulator before rounding to bf16 (as ``apply_nerf`` does).

The kernels specialise the full model (8 x 256 trunk, 128-wide color layer),
as the TPU kernels do.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.encoding import positional_encoding
from nerf_tpu_torch.models.nerf import apply_nerf
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.utils.device import disable_tf32
from nerf_tpu_torch.utils.monitor import span
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

# Launches of the CUDA kernel (not of the plain version). A launch recorded
# into a CUDA graph is not one (_ext.ran).
launches = 0

HID = 256
POS_ROWS = 64   # padded position-encoding width (3 + 6 * 10 = 63)
MIP_ROWS = 128  # padded IPE width of the mip variant (6 * 16 = 96)
DIR_ROWS = 32   # padded direction-encoding width (3 + 6 * 4 = 27)


class PackedWeights(NamedTuple):
    w0: torch.Tensor              # [POS_ROWS, 256] trunk layer 0 (mip: [MIP_ROWS, 256])
    b0: torch.Tensor              # [256] f32
    wt: torch.Tensor              # [7, 256, 256] trunk layers 1..7 (hidden rows)
    bt: torch.Tensor              # [7, 256] f32
    wskip: torch.Tensor           # [POS_ROWS, 256] encoding rows of the skip layer (mip: MIP_ROWS)
    wsig: torch.Tensor            # [256] density column
    bsig: torch.Tensor            # [1] f32
    wbn: Optional[torch.Tensor]   # bmild, mip: [256, 256] bottleneck
    bbn: Optional[torch.Tensor]   # bmild, mip: [256] f32
    wc0: torch.Tensor             # [256, 128] color layer, hidden/bottleneck rows
    bc0: torch.Tensor             # [128] f32
    wdir: torch.Tensor            # [DIR_ROWS, 128] color layer, direction rows
    wc1: torch.Tensor             # [128, 3]
    bc1: torch.Tensor             # [3] f32


def skip_position(cfg: ModelConfig) -> int:
    """Trunk layer whose input carries the encoding: the reference variant
    concatenates before ``skip_layer``, bmild after it."""
    if cfg.variant == "reference":
        return cfg.skip_layer
    if cfg.variant in ("bmild", "mip"):
        return cfg.skip_layer + 1
    raise ValueError(f"unknown variant {cfg.variant}")


def has_bottleneck(cfg: ModelConfig) -> bool:
    """bmild and mip put a linear bottleneck between the trunk and the color
    layer."""
    return cfg.variant in ("bmild", "mip")


def pos_rows(cfg: ModelConfig) -> int:
    """Rows of ``w0`` and ``wskip``: the encoding padded for the kernels."""
    return MIP_ROWS if cfg.variant == "mip" else POS_ROWS


def skip_h_first(cfg: ModelConfig) -> bool:
    """Whether the skip layer's input is ``[h, enc]`` (else ``[enc, h]``), as
    the variant fixes it."""
    return cfg.variant in ("reference", "mip")


def pack_params(params, cfg: ModelConfig, dtype=torch.bfloat16) -> PackedWeights:
    """Re-layout a params dict (JAX layout, ``[in, out]``) for the kernel."""
    if not (cfg.hidden_dim == HID and cfg.n_layers == 8
            and cfg.color_hidden_dim == 128):
        raise ValueError("the fused kernel specializes the reference architecture "
                         "(256x8 trunk, 128 color); use apply_nerf for other sizes")
    if cfg.pos_dim > pos_rows(cfg) or cfg.dir_dim > DIR_ROWS:
        raise ValueError(f"encodings wider than {pos_rows(cfg)}/{DIR_ROWS} columns")
    pos_dim = cfg.pos_dim
    skip_pos = skip_position(cfg)
    trunk = params["trunk"]
    f32 = torch.float32

    def mat(w, rows=None):
        w = w.to(f32)
        if rows is not None and w.shape[0] < rows:
            w = torch.cat([w, w.new_zeros(rows - w.shape[0], w.shape[1])])
        return w.to(dtype).contiguous()

    def vec(b):
        return b.to(f32).contiguous()

    wsk = trunk[skip_pos]["w"]
    if skip_h_first(cfg):                          # [h, enc] rows
        wsk_h, wsk_e = wsk[:HID], wsk[HID:]
    else:                                          # [enc, h] rows
        wsk_e, wsk_h = wsk[:pos_dim], wsk[pos_dim:]
    wt = [wsk_h if i == skip_pos else trunk[i]["w"] for i in range(1, 8)]

    wc0 = params["color0"]["w"]                    # [256 + dir_dim, 128]
    bmild = has_bottleneck(cfg)
    rows = pos_rows(cfg)
    return PackedWeights(
        w0=mat(trunk[0]["w"], rows),
        b0=vec(trunk[0]["b"]),
        wt=torch.stack([mat(w) for w in wt]),
        bt=torch.stack([vec(trunk[i]["b"]) for i in range(1, 8)]),
        wskip=mat(wsk_e, rows),
        wsig=mat(params["density"]["w"])[:, 0].contiguous(),
        bsig=vec(params["density"]["b"]),
        wbn=mat(params["bottleneck"]["w"]) if bmild else None,
        bbn=vec(params["bottleneck"]["b"]) if bmild else None,
        wc0=mat(wc0[:HID]),
        bc0=vec(params["color0"]["b"]),
        wdir=mat(wc0[HID:], DIR_ROWS),
        wc1=mat(params["color1"]["w"]),
        bc1=vec(params["color1"]["b"]),
    )


def check_packed(packed: PackedWeights, cfg: ModelConfig, dev: torch.device) -> None:
    """Raise unless ``packed`` is what the CUDA kernels take: ``pack_params``'
    layout for ``cfg``'s variant, bfloat16 matrices and float32 biases,
    contiguous, on ``dev``."""
    if has_bottleneck(cfg) != (packed.wbn is not None) or (
            packed.w0.shape[0] != pos_rows(cfg)):
        raise ValueError(f"packed weights do not match variant {cfg.variant}")
    if packed.wt.shape != (7, HID, HID) or packed.wc1.shape != (HID // 2, 3):
        raise ValueError("packed weights are not in pack_params' layout")
    for name, w in packed._asdict().items():   # wbn/bbn are None unless bmild
        want = torch.float32 if name.startswith("b") else torch.bfloat16
        if w is not None and (w.dtype != want or w.device != dev
                              or not w.is_contiguous()):
            raise ValueError(f"packed weight {name} must be contiguous {want} on "
                             f"{dev} (the CUDA kernels compute in bfloat16)")


def net_args(cfg: ModelConfig) -> tuple:
    """The architecture arguments every C entry point takes after the
    weights: Lp, Ld, skip_pos, bmild, relu_sigma, normalize_dirs, band scale."""
    return (0 if cfg.variant == "mip" else cfg.pos_freqs, cfg.dir_freqs, skip_position(cfg),
            int(has_bottleneck(cfg)), int(cfg.variant == "reference"),
            int(cfg.normalize_dirs),
            float(np.float32(np.pi)) if cfg.posenc_pi else 1.0)


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def fused_nerf_apply_plain(packed: PackedWeights, positions: torch.Tensor,
                           directions: torch.Tensor, cfg: ModelConfig,
                           keep: Optional[dict] = None,
                           trunk_mm: Optional[Callable] = None) -> torch.Tensor:
    """Plain-PyTorch version of the kernel: positions, directions ``[N, 3]``
    -> ``[N, 4]`` per sample ``(sigma, r, g, b)``. The compute dtype is that
    of the packed matrices: each product takes inputs rounded to it and
    accumulates in float32; the float32 bias is added before the next
    rounding; direction normalization is ``d * rsqrt(|d|^2 + 1e-12)``.
    ``keep`` (a dict) receives the intermediates the backward needs.
    ``trunk_mm(a, name, i)`` replaces the trunk's products (``name`` one of
    ``w0``, ``wt`` with layer ``i``, ``wskip``): the int8-compute route of
    ``ops/quant.py``."""
    disable_tf32()
    dt = packed.w0.dtype

    def mm(a, w):
        return a.to(dt).float() @ w.float()

    if trunk_mm is None:
        def trunk_mm(a, name, i=None):
            w = getattr(packed, name)
            return mm(a, w if i is None else w[i])

    enc = _pad_cols(positional_encoding(positions.float(), cfg.pos_freqs, cfg.posenc_pi),
                    POS_ROWS).to(dt)
    hs = [torch.relu(trunk_mm(enc, "w0") + packed.b0).to(dt)]
    skip_pos = skip_position(cfg)
    for i in range(1, 8):
        y = trunk_mm(hs[-1], "wt", i - 1)
        if i == skip_pos:
            y = y + trunk_mm(enc, "wskip")
        hs.append(torch.relu(y + packed.bt[i - 1]).to(dt))
    h = hs[-1]

    sigma_raw = mm(h, packed.wsig[:, None])[:, 0] + packed.bsig
    sigma = torch.relu(sigma_raw) if cfg.variant == "reference" else sigma_raw

    d = directions.float()
    if cfg.normalize_dirs:
        d = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
    denc = _pad_cols(positional_encoding(d, cfg.dir_freqs, cfg.posenc_pi), DIR_ROWS).to(dt)

    feat = h
    if cfg.variant == "bmild":
        feat = mm(h, packed.wbn) + packed.bbn                        # no activation
    c_pre = mm(feat, packed.wc0) + mm(denc, packed.wdir) + packed.bc0
    c = torch.relu(c_pre).to(dt)
    rgb = torch.sigmoid(mm(c, packed.wc1) + packed.bc1)
    if keep is not None:
        keep.update(enc=enc, denc=denc, hs=hs, sigma_raw=sigma_raw, c_pre=c_pre, c=c, rgb=rgb)
    return torch.cat([sigma[:, None], rgb], dim=-1)


def _launch(packed: PackedWeights, positions: torch.Tensor, directions: torch.Tensor,
            cfg: ModelConfig, stream: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K4 on float32 ``[N, 3]`` CUDA tensors: ``[N, 4]``. The Hopper
    kernel reads ``stream`` (the weights' per-sample stream, or one that
    begins with it), by default ``ray_wgmma.sample_stream_for(packed)``."""
    global launches
    from nerf_tpu_torch.ops import ray_wgmma      # it imports this module

    dev = positions.device
    n = positions.shape[0]
    for name, t in (("positions", positions), ("directions", directions)):
        if t.dtype != torch.float32 or t.shape != (n, 3) or t.device != dev:
            raise ValueError(f"{name} must be float32 [N, 3] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    check_packed(packed, cfg, dev)
    positions, directions = positions.contiguous(), directions.contiguous()
    out = torch.empty(n, 4, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    stream = ray_wgmma.sample_stream_for(packed, cfg) if stream is None else stream
    ray_wgmma.forward_samples(ray_wgmma.LIBRARY, packed, positions, directions, cfg, stream, out)
    launches += _ext.ran()
    return out


def mlp_forward(packed: PackedWeights, positions: torch.Tensor, directions: torch.Tensor,
                cfg: ModelConfig, stream: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[N, 4]`` from flat float32 ``[N, 3]`` inputs: the kernel on CUDA
    tensors (reading ``stream``, as ``_launch`` does), the plain version on
    CPU tensors."""
    with span("kernel.k4"):
        if positions.device.type == "cpu":
            return fused_nerf_apply_plain(packed, positions, directions, cfg)
        return _launch(packed, positions, directions, cfg, stream)


def flat_inputs(positions: torch.Tensor, directions: Optional[torch.Tensor]):
    """``([N, 3] positions, [N, 3] directions)`` in float32 from ``[..., 3]``
    positions and broadcastable (or no) directions."""
    pos = positions.reshape(-1, 3).float()
    if directions is None:
        return pos, torch.zeros_like(pos)
    return pos, directions.expand(positions.shape).reshape(-1, 3).float()


class _FusedApply(torch.autograd.Function):
    """Forward: the kernel. Backward: recompute through ``apply_nerf`` under
    autograd (gradients to the params only). ``spec = (cfg, dtype, paths)``;
    the parameter leaves come flat, in ``tree_leaves``' order."""

    @staticmethod
    def forward(ctx, pos, dirs, spec, *leaves):
        cfg, dtype, paths = spec
        ctx.spec = spec
        ctx.save_for_backward(pos, dirs, *leaves)
        packed = pack_params(tree_from_leaves(paths, leaves), cfg, dtype)
        out = mlp_forward(packed, pos, dirs, cfg)
        return out[:, 0], out[:, 1:4]

    @staticmethod
    def backward(ctx, d_sigma, d_rgb):
        cfg, dtype, paths = ctx.spec
        pos, dirs, *leaves = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [leaf.detach().requires_grad_() for leaf in leaves]
            out = apply_nerf(tree_from_leaves(paths, leaves), pos, dirs, cfg,
                             compute_dtype=dtype)
            grads = torch.autograd.grad(out, leaves, (d_sigma, d_rgb), allow_unused=True)
        return (None, None, None, *grads)


def fused_nerf_apply(
    params: Union[dict, PackedWeights],
    positions: torch.Tensor,                 # [..., 3]
    directions: Optional[torch.Tensor],      # broadcastable to positions, or None
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused replacement for ``apply_nerf``: ``(sigma [...], rgb [..., 3])``,
    views of one ``[N, 4]`` buffer. ``params`` is a params dict (packed
    here, in ``dtype``; differentiable) or ``PackedWeights`` (inference)."""
    lead = positions.shape[:-1]
    pos, dirs = flat_inputs(positions, directions)
    if isinstance(params, PackedWeights):
        out = mlp_forward(params, pos, dirs, cfg)
        sigma, rgb = out[:, 0], out[:, 1:4]
    else:
        paths, leaves = zip(*tree_leaves(params))
        sigma, rgb = _FusedApply.apply(pos, dirs, (cfg, dtype, paths), *leaves)
    return sigma.reshape(lead), rgb.reshape(*lead, 3)


def make_cuda_apply_fn(dtype: torch.dtype = torch.bfloat16):
    """Adapter matching ``render_rays``' ``apply_fn`` signature; the compute
    dtype is the kernel's, not the caller's."""

    def apply_fn(params, positions, directions, cfg, compute_dtype=None):
        return fused_nerf_apply(params, positions, directions, cfg, dtype)

    return apply_fn
