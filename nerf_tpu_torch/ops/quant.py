"""Compressed NeRF: magnitude pruning + intN weight quantization, the
dequantize-in-kernel MLP (K7) and the int8-compute route (K8).

Counterpart of ``nerf_tpu/ops/quant.py``:

- host side: ``prune_params`` (per-tensor quantile threshold), ``_quantize``
  (symmetric per-output-channel int8/int16), ``quantize_packed``,
  ``quantize_packed_int8`` and ``quantize_model`` with its stats report.
  The quantized tensors are bit-equal to the JAX package's per logical row
  and column; ``quantized_from_numpy`` carries a JAX
  ``QuantizedPackedWeights`` across (its rows are permuted and padded for
  the TPU kernel's encoding layout, the port's keep the reference order).
- ``quantized_nerf_apply`` (the Pallas kernel ``_quant_kernel``): the
  per-sample network on intN weights, same contract as
  ``fused_nerf_apply``. On a CUDA tensor it launches the per-sample kernel
  of ``csrc/ray_wgmma.cu`` in the build of the weights' route
  (``ray_wgmma.LIBRARIES``): on int8 and int16 weights the bf16 build, on
  the bf16 stream that ``dequant_stream`` writes from the intN one once a
  call, into scratch that goes with the call (``ops/dequant_stream.py``);
  on the int8-compute route its own build. On a CPU tensor it runs
  ``quantized_nerf_apply_plain``. Inference only.
  Under a profiler each call records one span ``kernel.k7``
  (``utils/monitor.span``), from that choice until the launch is enqueued.
- the int8-compute route (the ``_int8_mm`` hook of ``_nerf_math``), taken
  for ``Int8PackedWeights`` by this kernel and by the ray kernels of
  ``ops/render_kernel.py``: layer 0, trunk layers 1..7 and the skip product
  run as s8 x s8 -> s32 on the tensor cores. The encoding quantizes at a
  fixed scale (``clip(round(enc * (enc_scale * 127)), +-127)``, the xyz rows
  of ``w0``/``wskip`` carry ``pos_bound``), the activations per row against
  their absmax; the heads, the bottleneck, the colour layers and the
  direction branch stay on the dequantize route.

The weight layout is ``pack_params``' (``ops/mlp_kernel.py``): each matrix
as ``_q`` (int8 or int16) and ``_s`` (float32 scale per output channel),
biases in float32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import NeRFParams
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.ops.mlp_kernel import (
    DIR_ROWS,
    HID,
    POS_ROWS,
    PackedWeights,
    flat_inputs,
    fused_nerf_apply_plain,
    pack_params,
)
from nerf_tpu_torch.utils.monitor import span
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

# Launches of the CUDA kernel (not of the plain version): every launch of
# K7, and those of them on the int8-compute route (K8). A launch recorded
# into a CUDA graph is not one (_ext.ran).
launches = {"mlp_quant": 0, "mlp_quant_int8": 0}

MATRICES = ("w0", "wt", "wskip", "wsig", "wbn", "wc0", "wdir", "wc1")


class QuantizedPackedWeights(NamedTuple):
    """``PackedWeights`` with each matrix as (int values, float32 scale per
    output channel). ``wbn_*``/``bbn`` are None unless bmild."""

    w0_q: torch.Tensor                # intN [POS_ROWS, 256]
    w0_s: torch.Tensor                # f32 [1, 256]
    b0: torch.Tensor
    wt_q: torch.Tensor                # intN [7, 256, 256]
    wt_s: torch.Tensor                # f32 [7, 1, 256]
    bt: torch.Tensor
    wskip_q: torch.Tensor
    wskip_s: torch.Tensor
    wsig_q: torch.Tensor              # intN [256]
    wsig_s: torch.Tensor              # f32 [1]
    bsig: torch.Tensor
    wbn_q: Optional[torch.Tensor]
    wbn_s: Optional[torch.Tensor]
    bbn: Optional[torch.Tensor]
    wc0_q: torch.Tensor
    wc0_s: torch.Tensor
    bc0: torch.Tensor
    wdir_q: torch.Tensor
    wdir_s: torch.Tensor
    wc1_q: torch.Tensor
    wc1_s: torch.Tensor
    bc1: torch.Tensor


class Int8PackedWeights(NamedTuple):
    """``QuantizedPackedWeights`` (int8) plus the activation-side contract of
    int8 compute: ``enc_scale`` (1 / pos_bound on the xyz columns, 1
    elsewhere) maps the encoding into [-1, 1], and the xyz rows of
    ``w0_q``/``wskip_q`` were multiplied by ``pos_bound`` before they were
    quantized, so the product is unchanged."""

    w0_q: torch.Tensor
    w0_s: torch.Tensor
    b0: torch.Tensor
    wt_q: torch.Tensor
    wt_s: torch.Tensor
    bt: torch.Tensor
    wskip_q: torch.Tensor
    wskip_s: torch.Tensor
    wsig_q: torch.Tensor
    wsig_s: torch.Tensor
    bsig: torch.Tensor
    wbn_q: Optional[torch.Tensor]
    wbn_s: Optional[torch.Tensor]
    bbn: Optional[torch.Tensor]
    wc0_q: torch.Tensor
    wc0_s: torch.Tensor
    bc0: torch.Tensor
    wdir_q: torch.Tensor
    wdir_s: torch.Tensor
    wc1_q: torch.Tensor
    wc1_s: torch.Tensor
    bc1: torch.Tensor
    enc_scale: torch.Tensor           # f32 [POS_ROWS]


Quantized = Union[QuantizedPackedWeights, Int8PackedWeights]


def is_quantized(params) -> bool:
    return isinstance(params, (QuantizedPackedWeights, Int8PackedWeights))


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------


def _quantile(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Linear-interpolated quantile of a float32 tensor, in the JAX package's
    operation order (index ``fraction * (n - 1)`` in float32, ``low * (1 - t)
    + high * t``), so the threshold is the same number."""
    a = torch.sort(x.reshape(-1)).values
    last = np.float32(a.numel() - 1)
    pos = np.float32(fraction) * last
    low, high = np.floor(pos), np.ceil(pos)
    high_weight = pos - low
    low_weight = np.float32(1.0) - high_weight
    lo = a[int(min(max(low, 0.0), last))]
    hi = a[int(min(max(high, 0.0), last))]
    return lo * float(low_weight) + hi * float(high_weight)


def prune_params(params: NeRFParams, prune_fraction: float) -> NeRFParams:
    """Zero the smallest-|w| fraction of every weight matrix (per-tensor
    quantile threshold, ``|w| <= threshold``). Biases untouched."""
    if prune_fraction <= 0.0:
        return params
    paths, leaves = zip(*tree_leaves(params))

    def prune_leaf(path, leaf):
        if "w" not in path:
            return leaf
        mag = leaf.abs()
        return torch.where(mag <= _quantile(mag.float(), prune_fraction),
                           torch.zeros_like(leaf), leaf)

    return tree_from_leaves(paths, [prune_leaf(p, l) for p, l in zip(paths, leaves)])


def _quantize(w: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantization of ``[in, out]`` (or ``[k,
    in, out]``) float32 weights: ``(q intN, scale f32 [.., 1, out])``."""
    qmax = float(2 ** (bits - 1) - 1)
    dtype = torch.int8 if bits <= 8 else torch.int16
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / qmax
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(dtype)
    return q.contiguous(), scale.float().contiguous()


def quantize_packed(packed: PackedWeights, bits: int = 8) -> QuantizedPackedWeights:
    """Quantize float32 ``PackedWeights`` matrix by matrix."""
    fields: Dict[str, Any] = {}
    for name, w in packed._asdict().items():
        if name not in MATRICES:
            fields[name] = w
        elif w is None:
            fields[f"{name}_q"] = fields[f"{name}_s"] = None
        elif name == "wsig":                          # one column, kept as a vector
            q, s = _quantize(w.float()[:, None], bits)
            fields["wsig_q"], fields["wsig_s"] = q[:, 0].contiguous(), s.reshape(1)
        else:
            fields[f"{name}_q"], fields[f"{name}_s"] = _quantize(w.float(), bits)
    return QuantizedPackedWeights(**fields)


def quantize_packed_int8(packed: PackedWeights, pos_bound: float = 12.0) -> Int8PackedWeights:
    """Pack for int8 compute: ``quantize_packed(bits=8)`` with ``pos_bound``
    folded into the xyz rows of ``w0``/``wskip``. ``pos_bound`` must bound
    |sample position| along any rendered ray; coordinates beyond it saturate
    at the int8 clip."""
    q = quantize_packed(packed, bits=8)
    rows = packed.w0.shape[0]
    scale_rows = packed.w0.new_ones(rows, 1, dtype=torch.float32)
    scale_rows[:3] = pos_bound
    w0_q, w0_s = _quantize(packed.w0.float() * scale_rows, 8)
    wskip_q, wskip_s = _quantize(packed.wskip.float() * scale_rows, 8)
    enc_scale = packed.w0.new_ones(rows, dtype=torch.float32)
    enc_scale[:3] = 1.0 / pos_bound
    return Int8PackedWeights(
        *q._replace(w0_q=w0_q, w0_s=w0_s, wskip_q=wskip_q, wskip_s=wskip_s),
        enc_scale=enc_scale)


def quantize_model(
    params: Dict[str, NeRFParams],
    cfg: ModelConfig,
    bits: int = 8,
    prune_fraction: float = 0.1,
    act_bits: Optional[int] = None,
    pos_bound: float = 12.0,
) -> Tuple[Dict[str, Quantized], Dict[str, Any]]:
    """Quantize ``{'coarse', 'fine'}`` params: ``(quantized, stats)``, on the
    params' device. ``act_bits=8`` gives the int8-compute representation
    (``Int8PackedWeights``; needs ``bits=8``). The pruned params are packed
    in float32 before they are quantized. The stats: original and compressed
    megabytes (the latter counts this package's tensors), their ratio, and
    the sparsity of the pruned params."""
    if act_bits is not None and (act_bits != 8 or bits != 8):
        raise ValueError("int8 compute requires bits=8, act_bits=8")
    out: Dict[str, Quantized] = {}
    stats: Dict[str, Any] = {"bits": bits, "prune_fraction": prune_fraction,
                             "act_bits": act_bits, "networks": {}}
    for name, p in params.items():
        pruned = prune_params(p, prune_fraction)
        packed = pack_params(pruned, cfg, dtype=torch.float32)
        q = (quantize_packed_int8(packed, pos_bound) if act_bits == 8
             else quantize_packed(packed, bits))
        out[name] = q
        orig_bytes = sum(leaf.numel() * 4 for _, leaf in tree_leaves(p))
        comp_bytes = sum(t.numel() * t.element_size() for t in q if t is not None)
        leaves = [leaf for _, leaf in tree_leaves(pruned)]
        nz = sum(int((leaf != 0).sum()) for leaf in leaves)
        total = sum(leaf.numel() for leaf in leaves)
        stats["networks"][name] = {
            "original_mb": orig_bytes / 1e6,
            "compressed_mb": comp_bytes / 1e6,
            "compression_ratio": orig_bytes / comp_bytes,
            "sparsity": 1.0 - nz / total,
        }
    return out, stats


def _enc_perm(L: int) -> np.ndarray:
    """Column of the reference-layout encoding ``[x, sin f0 x, cos f0 x,
    ...]`` that each column of the TPU kernel's layout holds (-1: a helper
    column with no reference counterpart): ``[x(3), sin'(3(L+1), coordinate
    major, frequencies 2^(k-1)), cos'(3(L+1), frequencies 2^k)]``."""
    idx = list(range(3))
    for j in range(3):
        idx.append(-1)
        idx.extend(3 + 6 * i + j for i in range(L))
    for j in range(3):
        idx.extend(6 + 6 * i + j for i in range(L))
        idx.append(-1)
    return np.asarray(idx)


def quantized_from_numpy(jq: Dict[str, Optional[np.ndarray]], cfg: ModelConfig,
                         device="cuda") -> Quantized:
    """The JAX package's ``QuantizedPackedWeights`` / ``Int8PackedWeights``
    (``._asdict()`` with numpy leaves) in this package's layout: encoding
    rows back in the reference order (padded to 64 / 32 zero rows), the
    concatenated heads ``whead = [density | color0 or bottleneck]`` split by
    columns."""
    def rows(a, L, width):
        perm = _enc_perm(L)
        out = np.zeros((width,) + a.shape[1:], a.dtype)
        for k, r in enumerate(perm):
            if r >= 0:
                out[r] = a[k]
        return out

    t = lambda a: torch.tensor(np.array(a), device=device)
    Lp, Ld = cfg.pos_freqs, cfg.dir_freqs
    whq, whs, bh = jq["whead_q"], jq["whead_s"], jq["bhead"]
    bmild = cfg.variant == "bmild"
    fields = dict(
        w0_q=t(rows(jq["w0_q"], Lp, POS_ROWS)), w0_s=t(jq["w0_s"]), b0=t(jq["b0"][0]),
        wt_q=t(jq["wt_q"]), wt_s=t(jq["wt_s"]), bt=t(jq["bt"][:, 0]),
        wskip_q=t(rows(jq["wskip_q"], Lp, POS_ROWS)), wskip_s=t(jq["wskip_s"]),
        wsig_q=t(whq[:, 0]), wsig_s=t(whs[0, :1]), bsig=t(bh[0, :1]),
        wbn_q=t(whq[:, 1:]) if bmild else None, wbn_s=t(whs[:, 1:]) if bmild else None,
        bbn=t(bh[0, 1:]) if bmild else None,
        wc0_q=t(jq["wc0_q"] if bmild else whq[:, 1:]),
        wc0_s=t(jq["wc0_s"] if bmild else whs[:, 1:]),
        bc0=t(jq["bc0"][0] if bmild else bh[0, 1:]),
        wdir_q=t(rows(jq["wdir_q"], Ld, DIR_ROWS)), wdir_s=t(jq["wdir_s"]),
        wc1_q=t(jq["wc1_q"]), wc1_s=t(jq["wc1_s"]), bc1=t(jq["bc1"][0]),
    )
    if "enc_scale" in jq:
        scale = np.ones(POS_ROWS, np.float32)
        scale[:3] = jq["enc_scale"][0, :3]
        return Int8PackedWeights(**fields, enc_scale=t(scale))
    return QuantizedPackedWeights(**fields)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def dequantize(q: Quantized, dtype: torch.dtype) -> PackedWeights:
    """``dtype(f32(q) * s)`` of every matrix, as the kernels form it on chip.
    Used by the plain versions only."""
    def dq(name):
        wq, ws = getattr(q, f"{name}_q"), getattr(q, f"{name}_s")
        return None if wq is None else (wq.float() * ws).to(dtype)

    return PackedWeights(**{name: dq(name) if name in MATRICES else getattr(q, name)
                            for name in PackedWeights._fields})


def int8_mm(a: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
            pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the s8 x s8 -> s32 product, in the JAX package's
    operation order. ``pre`` (the encoding products): activations at the
    fixed scale ``clip(round(a * (pre * 127)), +-127)``, result ``acc * (s *
    (1 / 127))``. Otherwise per row ``ax = max|a|``, ``round(a * (127 /
    max(ax, 1e-20)))``, result ``(acc * ax) * (s * (1 / 127))``. The integer
    sums stay below 2^24 (127 * 127 * 256), so a float32 product is exact."""
    a = a.float()
    inv = ws * (1.0 / 127.0)
    if pre is not None:
        aq = torch.clamp(torch.round(a * (pre * 127.0)), -127.0, 127.0)
        return (aq @ wq.float()) * inv
    ax = a.abs().amax(dim=-1, keepdim=True)
    aq = torch.round(a * (127.0 / torch.clamp(ax, min=1e-20)))
    return ((aq @ wq.float()) * ax) * inv


def quantized_nerf_apply_plain(q: Quantized, positions: torch.Tensor,
                               directions: torch.Tensor, cfg: ModelConfig,
                               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain-PyTorch version of the kernel: flat positions and directions
    ``[N, 3]`` -> ``[N, 4]``. The plain MLP on ``dequantize(q, dtype)``; for
    ``Int8PackedWeights`` the trunk products (layer 0, layers 1..7, the skip
    rows) go through ``int8_mm``."""
    trunk_mm: Optional[Callable] = None
    if isinstance(q, Int8PackedWeights):
        def trunk_mm(a, name, i=None):
            wq, ws = getattr(q, f"{name}_q"), getattr(q, f"{name}_s")
            if name == "wt":
                return int8_mm(a, wq[i], ws[i])
            return int8_mm(a, wq, ws, pre=q.enc_scale)
    return fused_nerf_apply_plain(dequantize(q, dtype), positions, directions, cfg,
                                  trunk_mm=trunk_mm)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

ROUTE_INT8, ROUTE_INT16, ROUTE_INT8_COMPUTE = 1, 2, 3


def route_of(q: Quantized) -> int:
    """The kernels' weight route: 1 int8 dequantized on chip, 2 int16
    dequantized on chip, 3 int8 compute."""
    if isinstance(q, Int8PackedWeights):
        return ROUTE_INT8_COMPUTE
    return ROUTE_INT8 if q.w0_q.dtype == torch.int8 else ROUTE_INT16


def check_quantized(q: Quantized, cfg: ModelConfig, dev: torch.device,
                    dtype: torch.dtype) -> None:
    """Raise unless ``q`` is what the CUDA kernels take: this module's layout
    for ``cfg``'s variant, one integer type throughout, float32 scales and
    biases, contiguous and 16-byte aligned (the kernels read 16 bytes at a
    time), on ``dev``, for bfloat16 compute."""
    if dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernels compute in bfloat16, not {dtype}")
    if (cfg.variant == "bmild") != (q.wbn_q is not None):
        raise ValueError(f"quantized weights do not match variant {cfg.variant}")
    if q.wt_q.shape != (7, HID, HID) or q.w0_q.shape != (POS_ROWS, HID):
        raise ValueError("quantized weights are not in pack_params' layout")
    want_q = q.w0_q.dtype
    if want_q not in (torch.int8, torch.int16) or (
            isinstance(q, Int8PackedWeights) and want_q != torch.int8):
        raise ValueError(f"quantized matrices must be int8 or int16, got {want_q}")
    for name, w in q._asdict().items():
        want = want_q if name.endswith("_q") else torch.float32
        if w is not None and (w.dtype != want or w.device != dev or not w.is_contiguous()
                              or w.data_ptr() % 16):
            raise ValueError(f"quantized weight {name} must be contiguous {want} on {dev}, "
                             "16-byte aligned")


def weight_pointers(q: Quantized):
    """The two pointer arrays the C entry points take: the matrices and
    biases in ``PackedWeights`` order, and the eight scales plus
    ``enc_scale`` (NULL unless int8 compute)."""
    mats = [getattr(q, f"{n}_q" if n in MATRICES else n) for n in PackedWeights._fields]
    scales = [getattr(q, f"{n}_s") for n in MATRICES] + [getattr(q, "enc_scale", None)]
    return _ext.pointer_array(mats), _ext.pointer_array(scales)


def _launch(q: Quantized, positions: torch.Tensor, directions: torch.Tensor,
            cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch K7 on float32 ``[N, 3]`` CUDA tensors: ``[N, 4]``, in the
    build of ``csrc/ray_wgmma.cu`` for the weights' route, on their cached
    per-sample stream (on int8 and int16 weights, on what ``dequant_stream``
    makes of it)."""
    from nerf_tpu_torch.ops import ray_wgmma      # it imports this module

    route = route_of(q)
    dev = positions.device
    n = positions.shape[0]
    for name, t in (("positions", positions), ("directions", directions)):
        if t.dtype != torch.float32 or t.shape != (n, 3) or t.device != dev:
            raise ValueError(f"{name} must be float32 [N, 3] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    check_quantized(q, cfg, dev, dtype)
    positions, directions = positions.contiguous(), directions.contiguous()
    out = torch.empty(n, 4, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ray_wgmma.forward_samples(ray_wgmma.LIBRARIES[route], q, positions, directions, cfg,
                              ray_wgmma.sample_stream_for(q, cfg), out)
    ran = _ext.ran()
    launches["mlp_quant"] += ran
    if route == ROUTE_INT8_COMPUTE:
        launches["mlp_quant_int8"] += ran
    return out


def quantized_nerf_apply(
    q: Quantized,
    positions: torch.Tensor,                 # [..., 3]
    directions: Optional[torch.Tensor],      # broadcastable to positions, or None
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigma [...], rgb [..., 3])`` from intN-quantized weights; same
    contract as ``fused_nerf_apply``. The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    lead = positions.shape[:-1]
    pos, dirs = flat_inputs(positions, directions)
    with span("kernel.k7"):
        if pos.device.type == "cpu":
            out = quantized_nerf_apply_plain(q, pos, dirs, cfg, dtype)
        else:
            out = _launch(q, pos, dirs, cfg, dtype)
    return out[:, 0].reshape(lead), out[:, 1:4].reshape(*lead, 3)


def make_quantized_apply_fn(dtype: torch.dtype = torch.bfloat16):
    """Adapter matching ``render_rays``' ``apply_fn`` signature; the
    'params' it receives are quantized weights."""

    def apply_fn(q, positions, directions, cfg, compute_dtype=None):
        return quantized_nerf_apply(q, positions, directions, cfg, dtype)

    return apply_fn
