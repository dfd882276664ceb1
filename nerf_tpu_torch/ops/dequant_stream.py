"""The dequantize prologue of the Hopper MLP kernels on int8 and int16
weights (``csrc/dequant_stream.cu``).

``QuantizedPackedWeights`` (routes 1 and 2) stay int8 or int16 in device
memory, beside their intN weight stream (``ray_wgmma.stream_for``,
``sample_stream_for``). Each call of K1 and K3 (every output form and the
composited modes) and of K7 on them first launches ``dequant_stream_kernel``
into scratch the call allocates, once:

- the stream that ``ray_wgmma.pack_stream`` (or ``pack_sample_stream``)
  makes of ``quant.dequantize(q, torch.bfloat16)``, byte for byte. A
  dequantize chunk of the intN stream is the bf16 chunk's image element for
  element, then one scale per image row, so the kernel maps each 8 (int8) or
  16 (int16) bytes of the image to the 16 bytes of bf16 at the same place,
  ``bf16(f32(q) * s[row])``, with no re-swizzle;
- the resident parameters the bf16 build reads beside the stream, ``wsig``,
  ``wc1`` and ``wdir`` (``weight_at``'s rounding, the same), into one bf16
  buffer. The biases are float32 in the quantized weights and are read as
  they are.

Then the bf16 build of ``csrc/ray_wgmma.cu`` runs on that scratch
(``ray_wgmma.launch_operands``): the quantized builds converted the whole
network once per 128-row tile, in the producer warpgroup. The scratch goes
with the call, which the caching allocator reuses: no bf16 copy of a
quantized network outlives the kernel call that made it, and nothing is
cached beside the quantized weights but their intN stream.

``dequant_stream_plain`` is the same function in plain PyTorch; the wrapper
``dequant_stream`` runs it for a CPU stream and launches the kernel for a
CUDA one. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.ops import _ext, quant
from nerf_tpu_torch.ops.mlp_kernel import DIR_ROWS, HID, PackedWeights

LIBRARY = "dequant_stream"
CH = HID // 2
# the resident parameters in the order the kernel writes them: name, shape
RESIDENT = (("wsig", (HID,)), ("wc1", (CH, 3)), ("wdir", (DIR_ROWS, CH)))
RESIDENT_VALUES = sum(math.prod(shape) for _, shape in RESIDENT)

# Launches of the CUDA kernel (not of the plain version); one a call of K1,
# K3 or K7 on int8 or int16 weights. A launch recorded into a CUDA graph is
# not one (_ext.ran).
launches = 0

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]   # in, bits, chunks
             + [ctypes.c_void_p] * 4)                    # resident inputs, out, res, stream


class Dequantized(NamedTuple):
    """One call's scratch: the bf16 stream and the resident parameters."""

    stream: torch.Tensor       # bf16, 1-D
    resident: torch.Tensor     # bf16 [RESIDENT_VALUES]: wsig, wc1, wdir

    def parts(self) -> Dict[str, torch.Tensor]:
        """The resident parameters as views, in ``PackedWeights``' shapes."""
        out, at = {}, 0
        for name, shape in RESIDENT:
            n = math.prod(shape)
            out[name] = self.resident[at:at + n].view(shape)
            at += n
        return out


def _schedule(cfg: ModelConfig, q, per_sample: bool):
    from nerf_tpu_torch.ops import ray_wgmma      # it imports this module

    route = quant.route_of(q)
    return (ray_wgmma.sample_chunk_schedule if per_sample else ray_wgmma.chunk_schedule)(
        cfg, route)


def _counts(sched) -> Tuple[int, int]:
    """Chunks of 256 and of 128 columns; the 256-wide ones come first."""
    widths = [c.n for c in sched]
    n_big = widths.count(HID)
    if widths != [HID] * n_big + [CH] * (len(widths) - n_big):
        raise ValueError(f"a dequantize stream holds 256-column chunks, then 128-column ones, "
                         f"not {widths}")
    return n_big, len(widths) - n_big


def _check(q, stream: torch.Tensor, sched) -> None:
    if not isinstance(q, quant.QuantizedPackedWeights):
        raise ValueError(f"dequant_stream takes int8 or int16 QuantizedPackedWeights, not "
                         f"{type(q).__name__}")
    need = sum(c.nbytes for c in sched)
    if (stream.dtype != torch.uint8 or stream.dim() != 1 or not stream.is_contiguous()
            or stream.numel() < need or stream.device != q.w0_q.device):
        raise ValueError(f"the intN stream must be a contiguous 1-D uint8 tensor of at least "
                         f"{need} bytes on {q.w0_q.device}")


def resident_plain(q: quant.QuantizedPackedWeights) -> torch.Tensor:
    """The resident parameters, bf16 ``[RESIDENT_VALUES]``: ``bf16(f32(q) *
    s[col])`` of ``wsig``, ``wc1`` and ``wdir``, flat, in that order."""
    return torch.cat([(getattr(q, f"{n}_q").float() * getattr(q, f"{n}_s")).to(torch.bfloat16)
                      .reshape(-1) for n, _ in RESIDENT])


def dequant_stream_plain(q: quant.QuantizedPackedWeights, stream: torch.Tensor,
                         cfg: ModelConfig, per_sample: bool = False) -> Dequantized:
    """Plain-PyTorch version of the kernel: the intN ``stream`` of ``q`` (the
    ray kernels', or with ``per_sample`` the per-sample kernel's) as the bf16
    stream, chunk by chunk ``bf16(f32(q) * s[row])`` of its image, and the
    resident parameters."""
    sched = _schedule(cfg, q, per_sample)
    _check(q, stream, sched)
    qtype = q.w0_q.dtype
    parts: List[torch.Tensor] = []
    at = 0
    for c in sched:
        size = c.k * c.n * qtype.itemsize
        img = stream[at:at + size].view(qtype).reshape(c.n, c.k)     # an image row: a column
        scale = stream[at + size:at + size + 4 * c.n].view(torch.float32)
        parts.append((img.float() * scale[:, None]).to(torch.bfloat16).reshape(-1))
        at += c.nbytes
    return Dequantized(torch.cat(parts), resident_plain(q))


def load() -> ctypes.CDLL:
    """The bound library, its signature set once."""
    lib = _ext.load(LIBRARY)
    if lib.dequant_stream.argtypes is None:
        lib.dequant_stream.argtypes = _ARGTYPES
        lib.dequant_stream.restype = ctypes.c_int
    return lib


def _launch(q: quant.QuantizedPackedWeights, stream: torch.Tensor, cfg: ModelConfig,
            per_sample: bool = False) -> Dequantized:
    """Launch the kernel on the quantized weights' intN ``stream`` (the
    caller has checked the weights, ``quant.check_quantized``): its bf16
    stream and resident parameters, in new tensors on the stream's device."""
    global launches
    sched = _schedule(cfg, q, per_sample)
    _check(q, stream, sched)
    if stream.data_ptr() % 16:
        raise ValueError("the intN stream must be 16-byte aligned")
    n_big, n_small = _counts(sched)
    dev = stream.device
    values = sum(c.k * c.n for c in sched)
    out = Dequantized(torch.empty(values, dtype=torch.bfloat16, device=dev),
                      torch.empty(RESIDENT_VALUES, dtype=torch.bfloat16, device=dev))
    resident = _ext.pointer_array([getattr(q, f"{n}_{x}") for n, _ in RESIDENT for x in "qs"])
    lib = load()
    err = lib.dequant_stream(_ext.ptr(stream), q.w0_q.dtype.itemsize * 8, n_big, n_small,
                             resident, _ext.ptr(out.stream), _ext.ptr(out.resident),
                             _ext.stream_ptr(dev))
    _ext.check(lib, err, "dequant_stream launch")
    launches += _ext.ran()
    return out


def dequant_stream(q: quant.QuantizedPackedWeights, stream: torch.Tensor, cfg: ModelConfig,
                   per_sample: bool = False) -> Dequantized:
    """The bf16 stream and resident parameters of ``q`` from its intN
    ``stream``: the kernel for a CUDA stream, the plain version for a CPU
    one."""
    if stream.device.type == "cpu":
        return dequant_stream_plain(q, stream, cfg, per_sample)
    return _launch(q, stream, cfg, per_sample)


def launch_weights(q: quant.QuantizedPackedWeights, d: Dequantized) -> PackedWeights:
    """The weights a launch of the bf16 build reads beside the stream, in
    ``PackedWeights``' fields: the resident ``wsig``, ``wc1`` and ``wdir`` of
    ``d``, the biases of ``q``. The streamed matrices (``w0``, ``wt``,
    ``wskip``, ``wbn``, ``wc0``) are read from the stream alone; their fields
    hold it (the entry points test that ``wbn`` is given for bmild)."""
    r, s = d.parts(), d.stream
    return PackedWeights(w0=s, b0=q.b0, wt=s, bt=q.bt, wskip=s, wsig=r["wsig"], bsig=q.bsig,
                         wbn=None if q.wbn_q is None else s, bbn=q.bbn, wc0=s, bc0=q.bc0,
                         wdir=r["wdir"], wc1=r["wc1"], bc1=q.bc1)
