"""Weight packing for the fused ray kernel (``ops/render_kernel.py``).

Counterpart of ``pack_params`` in ``nerf_tpu/ops/mlp_kernel.py``, in a layout
chosen for the CUDA kernel rather than the TPU's:

- encodings keep the reference column order (``[x, sin f0x, cos f0x, ...]``)
  and are padded with zero weight rows to a multiple of the 16-wide tensor
  core step: 63 -> 64 position rows, 27 -> 32 direction rows. No permutation
  and no half-angle ladder: the kernel evaluates ``sinf``/``cosf`` of each
  phase directly.
- the skip layer is split into its hidden rows (``wt``) and encoding rows
  (``wskip``), accumulated into one product, for either variant's concat
  order.
- the density column is its own vector (``wsig``); the color branch is
  ``wc0`` (rows for the trunk output, or for the bmild bottleneck) plus
  ``wdir`` (rows for the direction encoding, evaluated once per ray).
- matrices are stored in the compute dtype (bf16 for the kernel), biases in
  float32: the kernel's epilogue adds a float32 bias to the float32
  accumulator before rounding to bf16 (as ``apply_nerf`` does).

The kernel specialises the full model (8 x 256 trunk, 128-wide color layer),
as the TPU kernel does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nerf_tpu_torch.config import ModelConfig

HID = 256
POS_ROWS = 64   # padded position-encoding width (3 + 6 * 10 = 63)
DIR_ROWS = 32   # padded direction-encoding width (3 + 6 * 4 = 27)


class PackedWeights(NamedTuple):
    w0: torch.Tensor              # [POS_ROWS, 256] trunk layer 0
    b0: torch.Tensor              # [256] f32
    wt: torch.Tensor              # [7, 256, 256] trunk layers 1..7 (hidden rows)
    bt: torch.Tensor              # [7, 256] f32
    wskip: torch.Tensor           # [POS_ROWS, 256] encoding rows of the skip layer
    wsig: torch.Tensor            # [256] density column
    bsig: torch.Tensor            # [1] f32
    wbn: Optional[torch.Tensor]   # bmild: [256, 256] bottleneck
    bbn: Optional[torch.Tensor]   # bmild: [256] f32
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
    if cfg.variant == "bmild":
        return cfg.skip_layer + 1
    raise ValueError(f"unknown variant {cfg.variant}")


def pack_params(params, cfg: ModelConfig, dtype=torch.bfloat16) -> PackedWeights:
    """Re-layout a params dict (JAX layout, ``[in, out]``) for the kernel."""
    if not (cfg.hidden_dim == HID and cfg.n_layers == 8
            and cfg.color_hidden_dim == 128):
        raise ValueError("the fused kernel specializes the reference architecture "
                         "(256x8 trunk, 128 color); use apply_nerf for other sizes")
    if cfg.pos_dim > POS_ROWS or cfg.dir_dim > DIR_ROWS:
        raise ValueError(f"encodings wider than {POS_ROWS}/{DIR_ROWS} columns")
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
    if cfg.variant == "reference":                 # [h, enc] rows
        wsk_h, wsk_e = wsk[:HID], wsk[HID:]
    else:                                          # [enc, h] rows
        wsk_e, wsk_h = wsk[:pos_dim], wsk[pos_dim:]
    wt = [wsk_h if i == skip_pos else trunk[i]["w"] for i in range(1, 8)]

    wc0 = params["color0"]["w"]                    # [256 + dir_dim, 128]
    bmild = cfg.variant == "bmild"
    return PackedWeights(
        w0=mat(trunk[0]["w"], POS_ROWS),
        b0=vec(trunk[0]["b"]),
        wt=torch.stack([mat(w) for w in wt]),
        bt=torch.stack([vec(trunk[i]["b"]) for i in range(1, 8)]),
        wskip=mat(wsk_e, POS_ROWS),
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
