"""Fused NeRF MLP backward (K5) and the training evaluator built on it.

Counterpart of ``nerf_tpu/ops/train_kernel.py``:

- ``packed_grads`` (the Pallas kernel ``_bwd_kernel``, ``_packed_grads``):
  from positions, directions ``[N, 3]`` and the cotangents ``dsigma [N]``,
  ``drgb [N, 3]`` it recomputes the forward and returns the gradient of
  every weight and bias in ``pack_params``' layout. Reference variant only,
  as the TPU kernel. On CUDA tensors it launches the two kernels of
  ``csrc/mlp_backward_wgmma.cu`` (``_launch``); on CPU tensors it runs
  ``packed_grads_plain``, the same arithmetic in plain PyTorch. Nothing
  falls back: a CUDA launch either runs or raises.
- The kernels, per pass of at most ``PASS_ROWS`` rows: the row pass K5a
  (``bwd_rows_wgmma``; plain version ``bwd_rows_plain``) recomputes the
  forward, walks back to every cotangent and stores, bf16, the quantities the
  weight gradients contract over (``SCRATCH``) to a scratch, each 64-sample
  block as the feature-major image K5b's descriptors read (``scratch_image``).
  The scratch reaches global memory by asynchronous bulk copies, not by the
  consumers' stores: a consumer writes each quantity into a slot in shared
  memory, in the image's bytes, one A fragment between each two products of
  the next layer, and a storer thread sends each piece of at most
  ``STAGE_FEATS`` rows (``store_schedule``) by ``cp.async.bulk``, its lines
  the first to leave L2, so that the scratch does not push the weight stream
  out;
  the weight-gradient pass K5b (``wgrad_wgmma``; plain version
  ``wgrad_split_plain``) computes ``X^T @ dY`` over the sample axis for every
  job of ``wgrad_jobs``, each block over a fixed range of sample blocks
  (``split_bounds``), writing float32 partials into its own slot. The slots
  are summed here in one fixed-order reduction: no atomics, nothing
  zero-filled, two runs agree bit for bit. ``packed_grads_composed`` is the
  plain version of that whole pipeline.
- ``unpack_grads`` maps those to the params tree: the skip layer's hidden
  and encoding rows are joined again, as are the color layer's trunk and
  direction rows, and the zero-padded encoding rows (63 -> 64, 27 -> 32)
  are dropped. The port's layout has no row permutation to invert.
- ``fused_train_apply`` is the drop-in for ``apply_nerf`` in the train
  step: forward K4 (``ops/mlp_kernel.py``), backward K5. The forward packs
  the weights once and gathers K5's weight stream once (``bwd_stream``); K4
  reads its prefix (the per-sample kernel's stream) and the backward reuses
  both, so a network costs one packing and one gather a step. Positions and
  directions get no gradient: they are data in NeRF training.

Roundings, shared by the kernels and the plain versions (the TPU kernel's):
every cotangent that enters a product (``dz1``, ``dc_pre``, ``dsigma_pre``,
``dpre_i``) is rounded to the compute dtype first, bias gradients sum those
rounded values in float32, and ReLU masks read the rounded activations. The
forward recompute is K4's arithmetic (float32 bias before the rounding). In
float32 compute the plain version is exact backpropagation.
"""

from __future__ import annotations

import ctypes
import math
from itertools import accumulate
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import NeRFParams
from nerf_tpu_torch.ops import _ext, ray_wgmma
from nerf_tpu_torch.ops.mlp_kernel import (
    DIR_ROWS,
    HID,
    POS_ROWS,
    PackedWeights,
    check_packed,
    flat_inputs,
    fused_nerf_apply_plain,
    mlp_forward,
    net_args,
    pack_params,
    skip_position,
)
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

LIBRARY = "mlp_backward_wgmma"     # K5a + K5b
# Launches of the CUDA kernels (not of the plain versions): the row pass and
# the weight-gradient pass; a launch recorded into a CUDA graph is not one
# (_ext.ran)
launches = {"bwd_rows": 0, "wgrad": 0}

PASS_ROWS = 65536   # rows of one pass of K5a + K5b: the scratch holds one pass
BLOCK = 64          # samples per 128-byte image row of the scratch (a sample block)
SPLITS = 6          # sample-block ranges of K5b per pass (22 jobs x 6 = 132 blocks)
CH = HID // 2
# Packed-layout gradients, in the order of the flat partials
GRAD_SHAPES = {
    "d_w0": (POS_ROWS, HID), "d_b0": (HID,), "d_wt": (7, HID, HID), "d_bt": (7, HID),
    "d_wskip": (POS_ROWS, HID), "d_wsig": (HID,), "d_bsig": (1,),
    "d_wc0": (HID, CH), "d_bc0": (CH,), "d_wdir": (DIR_ROWS, CH),
    "d_wc1": (CH, 3), "d_bc1": (3,),
}
GRAD_OFFSETS = dict(zip(GRAD_SHAPES, accumulate((math.prod(s) for s in GRAD_SHAPES.values()),
                                                 initial=0)))
GRAD_FLOATS = sum(math.prod(s) for s in GRAD_SHAPES.values())   # floats of one slot of partials
# The scratch of one row (K5a writes it, K5b reads it): (quantity, features),
# in image order. denc is padded to 64 features, dy8 = [dz1 (3), dsigma_pre,
# 0 x 4]; h_i are the trunk's activations, dpre_i the cotangents of their
# pre-activations.
SCRATCH = (("enc", POS_ROWS), ("denc", 64), *((f"h{i}", HID) for i in range(8)),
           *((f"dpre{i}", HID) for i in range(8)), ("dc_pre", CH), ("c", CH), ("dy8", 8))
SCRATCH_ROW = dict(zip((name for name, _ in SCRATCH),
                       accumulate((width for _, width in SCRATCH), initial=0)))
SCRATCH_FEATURES = sum(width for _, width in SCRATCH)   # 4488: 8,976 bytes a row
# K5a's stores of the scratch (csrc/mlp_backward_wgmma.cu, Staging,
# rows_storer): each quantity goes out a piece of at most STAGE_FEATS image
# rows (128 bytes each) at a time, written into one of STAGE_DEPTH slots a
# consumer in shared memory and sent by one bulk copy, in the order a
# consumer computes the quantities
STAGE_FEATS = 128
STAGE_DEPTH = 2
STAGE_PIECE = STAGE_FEATS * 128
STORE_ORDER = ("enc", "denc", *(f"h{i}" for i in range(8)), "c", "dy8", "dc_pre",
               *(f"dpre{i}" for i in range(7, -1, -1)))
# K5a's shared memory on the H100 (232,448 bytes a block): 1,024 for the
# alignment, ROWS_FIXED_BYTES (encodings, resident parameters, ReLU mask
# bits, barriers), both consumers' staging, then as many 32 KB ring stages
# as fit, at most 6
ROWS_SMEM_MAX = 232448
ROWS_FIXED_BYTES = 77824
RING_STAGE_BYTES = 32768
ROW_STAGES = min(6, (ROWS_SMEM_MAX - 1024 - ROWS_FIXED_BYTES - 2 * STAGE_DEPTH * STAGE_PIECE)
                 // RING_STAGE_BYTES)
ROWS_SMEM_BYTES = (1024 + ROWS_FIXED_BYTES + 2 * STAGE_DEPTH * STAGE_PIECE
                   + ROW_STAGES * RING_STAGE_BYTES)


def store_schedule() -> List[Tuple[str, int, int]]:
    """K5a's bulk copies of one sample block's image, in the order a consumer
    issues them: ``(quantity, first image row, image rows)``; a copy's bytes
    are its rows times 128, at byte ``128 * first row`` of the block."""
    width = dict(SCRATCH)
    return [(name, SCRATCH_ROW[name] + f, min(STAGE_FEATS, width[name]))
            for name in STORE_ORDER for f in range(0, width[name], STAGE_FEATS)]


def _require_reference(cfg: ModelConfig) -> None:
    if cfg.variant != "reference":
        raise ValueError("the backward kernel is written for the reference variant "
                         "(the one training uses); use fused_nerf_apply for bmild")


def packed_grads_plain(packed: PackedWeights, positions, directions, dsigma, drgb,
                       cfg: ModelConfig, keep: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Plain-PyTorch version of the kernels: packed-layout gradients, keyed as
    ``GRAD_SHAPES``, float32. ``keep`` (a dict) receives what
    ``fused_nerf_apply_plain`` keeps of the forward (``enc``, ``denc``,
    ``hs``, ``c``, ...) and the rounded cotangents as float32 (``dz1``,
    ``dc_pre``, ``dsig_pre``, ``dpre`` [8])."""
    _require_reference(cfg)
    dt = packed.w0.dtype
    fwd: dict = {}
    fused_nerf_apply_plain(packed, positions, directions, cfg, fwd)
    enc, denc, hs, c, rgb = (fwd[k] for k in ("enc", "denc", "hs", "c", "rgb"))

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
    dsig_pre = rnd(torch.where(fwd["sigma_raw"] > 0, dsigma.float(), 0.0))
    g["d_wc0"] = wgrad(hs[7], dc_pre)
    g["d_bc0"] = dc_pre.sum(0)
    g["d_wsig"] = wgrad(hs[7], dsig_pre[:, None])[:, 0]
    g["d_bsig"] = dsig_pre.sum(0, keepdim=True)
    dh = dgrad(dc_pre, packed.wc0) + dsig_pre[:, None] * packed.wsig.float()[None, :]

    skip_pos = skip_position(cfg)
    d_wt, d_bt, dpres = [None] * 7, [None] * 7, [None] * 8
    for i in range(7, 0, -1):
        dpre = rnd(torch.where(hs[i].float() > 0, dh, 0.0))
        dpres[i] = dpre
        d_wt[i - 1] = wgrad(hs[i - 1], dpre)
        d_bt[i - 1] = dpre.sum(0)
        if i == skip_pos:
            g["d_wskip"] = wgrad(enc, dpre)
        dh = dgrad(dpre, packed.wt[i - 1])
    dpre0 = rnd(torch.where(hs[0].float() > 0, dh, 0.0))
    dpres[0] = dpre0
    g["d_w0"] = wgrad(enc, dpre0)
    g["d_b0"] = dpre0.sum(0)
    g["d_wt"], g["d_bt"] = torch.stack(d_wt), torch.stack(d_bt)
    if keep is not None:
        keep.update(fwd, dz1=dz1, dc_pre=dc_pre, dsig_pre=dsig_pre, dpre=dpres)
    return {k: g[k] for k in GRAD_SHAPES}


# -- the kernels' plain versions ------------------------------------------------

def bwd_rows_plain(packed: PackedWeights, positions, directions, dsigma, drgb,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """What K5a writes, as ``{quantity: [N, features]}`` of ``SCRATCH`` in
    the compute dtype: the forward's encodings and activations and the
    rounded cotangents of the walk back, as ``packed_grads_plain`` keeps
    them."""
    dt = packed.w0.dtype
    keep: dict = {}
    packed_grads_plain(packed, positions, directions, dsigma, drgb, cfg, keep)
    zeros = torch.zeros(positions.shape[0], 64 - keep["denc"].shape[1], dtype=dt,
                        device=positions.device)
    rows = {"enc": keep["enc"], "denc": torch.cat([keep["denc"], zeros], 1),
            "dc_pre": keep["dc_pre"].to(dt), "c": keep["c"],
            "dy8": torch.cat([keep["dz1"].to(dt), keep["dsig_pre"].to(dt)[:, None],
                              zeros[:, :4]], 1)}
    rows.update({f"h{i}": keep["hs"][i] for i in range(8)})
    rows.update({f"dpre{i}": keep["dpre"][i].to(dt) for i in range(8)})
    return rows


def scratch_rows(rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``[N, SCRATCH_FEATURES]``: the quantities side by side, in image order."""
    return torch.cat([rows[name] for name, _ in SCRATCH], 1)


def _sample_positions() -> torch.Tensor:
    """Image position of each sample of a block: ``16 (s // 16) + 2 (s % 8) +
    (s // 8) % 2``, so that a consumer thread's two rows (``s0``, ``s0 + 8``)
    are neighbours (``csrc/mlp_backward_wgmma.cu`` sample_pos). K5b sums over
    every sample, so the order changes no product."""
    s = torch.arange(BLOCK)
    return s // 16 * 16 + s % 8 * 2 + s // 8 % 2


SAMPLE_POS = _sample_positions()


def scratch_image(feats: torch.Tensor) -> torch.Tensor:
    """The scratch as K5a lays it out, flat, from ``[N, SCRATCH_FEATURES]``:
    per sample block of 64 rows (zeros past N), ``SCRATCH_FEATURES`` image
    rows of 128 bytes, feature ``f``'s 64 samples (sample ``s`` at position
    ``SAMPLE_POS[s]``) in 16-byte pieces of 8, piece ``p`` at position ``p ^
    (f % 8)``: the image of a [64 samples, features] slab that the K-major
    descriptors read (``ray_wgmma._swizzled``)."""
    n = feats.shape[0]
    pad = feats.new_zeros(-n % BLOCK, feats.shape[1])
    blocks = torch.cat([feats, pad]).reshape(-1, BLOCK, feats.shape[1])
    order = torch.argsort(SAMPLE_POS).to(feats.device)
    return torch.cat([ray_wgmma._swizzled(b[order]) for b in blocks])


def image_rows(image: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``scratch_image``: the first ``n`` rows."""
    per = SCRATCH_FEATURES * BLOCK
    pos = SAMPLE_POS.to(image.device)
    return torch.cat([ray_wgmma._unswizzled(image[b * per:(b + 1) * per], SCRATCH_FEATURES,
                                            BLOCK)[pos]
                      for b in range(-(-n // BLOCK))])[:n]


def n_splits(rows: int) -> int:
    """K5b's sample-block ranges for a pass of ``rows`` rows."""
    return min(SPLITS, -(-rows // BLOCK))


def split_bounds(rows: int) -> List[Tuple[int, int]]:
    """The row range of each split of a pass: split ``s`` of ``S`` takes the
    sample blocks ``[s B // S, (s + 1) B // S)`` of the pass's ``B``."""
    blocks, splits = -(-rows // BLOCK), n_splits(rows)
    return [(BLOCK * (s * blocks // splits), min(rows, BLOCK * ((s + 1) * blocks // splits)))
            for s in range(splits)]


def pass_bounds(n: int, pass_rows: int = PASS_ROWS) -> List[Tuple[int, int]]:
    return [(p0, min(n, p0 + pass_rows)) for p0 in range(0, n, pass_rows)]


def wgrad_jobs(cfg: ModelConfig) -> List[tuple]:
    """K5b's jobs: ``(N, dY's first scratch row, consumer 0, consumer 1)``, a
    consumer ``(X's first scratch row, out, ld, valid, col0, ncols, bias)``
    or None. A consumer's tile is ``X[:, 64 rows]^T @ dY`` [64, N]: its row
    ``r < valid``, column ``col0 <= col < col0 + ncols`` goes to float ``out
    + r * ld + col - col0`` of a slot of partials (``GRAD_OFFSETS``), and
    with ``bias`` (else -1) the column sums of dY to ``bias + col - col0``.
    The two consumers of a job share dY; every float of a slot is written by
    exactly one job."""
    _require_reference(cfg)
    skip_pos = skip_position(cfg)
    o, r = GRAD_OFFSETS, SCRATCH_ROW
    groups = []    # (N, dY row, [consumers])
    groups.append((HID, r["dpre0"], [(r["enc"], o["d_w0"], HID, 64, 0, HID, o["d_b0"])]))
    for i in range(1, 8):
        tiles = [(r[f"h{i - 1}"] + 64 * m, o["d_wt"] + (i - 1) * HID * HID + 64 * m * HID, HID,
                  64, 0, HID, o["d_bt"] + (i - 1) * HID if m == 0 else -1) for m in range(4)]
        if i == skip_pos:
            tiles.append((r["enc"], o["d_wskip"], HID, 64, 0, HID, -1))
        groups.append((HID, r[f"dpre{i}"], tiles))
    groups.append((CH, r["dc_pre"],
                   [(r["h7"] + 64 * m, o["d_wc0"] + 64 * m * CH, CH, 64, 0, CH,
                     o["d_bc0"] if m == 0 else -1) for m in range(4)]
                   + [(r["denc"], o["d_wdir"], CH, DIR_ROWS, 0, CH, -1)]))
    groups.append((8, r["dy8"],
                   [(r["c"] + 64 * m, o["d_wc1"] + 64 * m * 3, 3, 64, 0, 3,
                     o["d_bc1"] if m == 0 else -1) for m in range(2)]
                   + [(r["h7"] + 64 * m, o["d_wsig"] + 64 * m, 1, 64, 3, 1,
                       o["d_bsig"] if m == 0 else -1) for m in range(4)]))
    jobs = []
    for n, b_row, tiles in groups:
        for k in range(0, len(tiles), 2):
            pair = tiles[k:k + 2]
            jobs.append((n, b_row, pair[0], pair[1] if len(pair) == 2 else None))
    return jobs


def jobs_tensor(cfg: ModelConfig) -> torch.Tensor:
    """``wgrad_jobs`` as the kernel reads them: int32 ``[jobs, 18]``."""
    rows = []
    for n, b_row, c0, c1 in wgrad_jobs(cfg):
        row = [n, b_row]
        for c in (c0, c1):
            row += list(c) + [0] if c is not None else [-1] * 8
        rows.append(row)
    return torch.tensor(rows, dtype=torch.int32)


def wgrad_split_plain(feats: torch.Tensor, bounds: Sequence[Tuple[int, int]],
                      cfg: ModelConfig) -> torch.Tensor:
    """K5b's partials, float32 ``[splits, GRAD_FLOATS]``, from the scratch
    rows ``[N, SCRATCH_FEATURES]`` (``scratch_rows``) and a row range per
    split: every job's tiles as the kernel computes them. Floats no job
    writes stay NaN (as ``torch.empty`` leaves the kernel's)."""
    out = torch.full((len(bounds), GRAD_FLOATS), float("nan"), device=feats.device)
    for s, (r0, r1) in enumerate(bounds):
        x = feats[r0:r1].float()
        for n, b_row, *cons in wgrad_jobs(cfg):
            dy = x[:, b_row:b_row + n]
            for c in cons:
                if c is None:
                    continue
                a_row, off, ld, valid, col0, ncols, bias = c
                tile = x[:, a_row:a_row + 64].t() @ dy
                dst = out[s, off:off + (valid - 1) * ld + ncols].as_strided((valid, ncols), (ld, 1))
                dst.copy_(tile[:valid, col0:col0 + ncols])
                if bias >= 0:
                    out[s, bias:bias + ncols] = dy.sum(0)[col0:col0 + ncols]
    return out


def grads_from_flat(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``GRAD_SHAPES``' views of one slot of partials."""
    return {k: flat[GRAD_OFFSETS[k]:GRAD_OFFSETS[k] + math.prod(s)].view(s)
            for k, s in GRAD_SHAPES.items()}


def packed_grads_composed(packed: PackedWeights, positions, directions, dsigma, drgb,
                          cfg: ModelConfig, pass_rows: int = PASS_ROWS) -> Dict[str, torch.Tensor]:
    """The kernels' pipeline in plain PyTorch: per pass, ``bwd_rows_plain``
    then ``wgrad_split_plain`` over ``split_bounds``; the slots of all passes
    summed in order."""
    parts = []
    for p0, p1 in pass_bounds(positions.shape[0], pass_rows):
        rows = bwd_rows_plain(packed, positions[p0:p1], directions[p0:p1], dsigma[p0:p1],
                              drgb[p0:p1], cfg)
        parts.append(wgrad_split_plain(scratch_rows(rows), split_bounds(p1 - p0), cfg))
    return grads_from_flat(torch.cat(parts).sum(0))


# -- the CUDA kernels -------------------------------------------------------------

_ROWS_ARGTYPES = (
    [ctypes.c_void_p] * 4                 # positions, directions, dsigma, drgb (the pass's)
    + [ctypes.c_longlong]                 # rows
    + [ctypes.c_void_p] * 2               # weight stream, weights (PackedWeights order)
    + [ctypes.c_int] * 6 + [ctypes.c_float]   # net_args
    + [ctypes.c_void_p] * 2               # scratch, stream
)
_WGRAD_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong]  # scratch, rows
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]   # jobs, n_jobs, splits
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]   # partials, first slot, floats a slot
    + [ctypes.c_void_p]                   # stream
)
_SIGNATURES = {"bwd_rows_wgmma": (_ROWS_ARGTYPES, ctypes.c_int),
               "wgrad_wgmma": (_WGRAD_ARGTYPES, ctypes.c_int),
               "bwd_scratch_features": ([], ctypes.c_int),
               "bwd_stream_chunks": ([], ctypes.c_int),
               "bwd_rows_smem_bytes": ([], ctypes.c_longlong),
               "bwd_rows_stages": ([], ctypes.c_int),
               "bwd_rows_staging": ([ctypes.c_int], ctypes.c_int),
               "wgrad_smem_bytes": ([], ctypes.c_longlong),
               "wgrad_job_ints": ([], ctypes.c_int)}
_JOBS: Dict[tuple, torch.Tensor] = {}


def load() -> ctypes.CDLL:
    """The bound build of K5 (``LIBRARY``), its signatures set once."""
    lib = _ext.load(LIBRARY)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def _check_inputs(packed, positions, directions, dsigma, drgb, cfg) -> None:
    _require_reference(cfg)
    dev = positions.device
    n = positions.shape[0]
    for name, t, shape in (("positions", positions, (n, 3)), ("directions", directions, (n, 3)),
                           ("dsigma", dsigma, (n,)), ("drgb", drgb, (n, 3))):
        if t.dtype != torch.float32 or t.shape != shape or t.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    check_packed(packed, cfg, dev)


def scratch_elems(rows: int) -> int:
    """bf16 elements of K5a's scratch for a pass of ``rows`` rows: two sample
    blocks per 128-row tile."""
    return 2 * -(-rows // (2 * BLOCK)) * BLOCK * SCRATCH_FEATURES


def launch_rows(packed: PackedWeights, positions, directions, dsigma, drgb, cfg: ModelConfig,
                scratch: torch.Tensor, stream: Optional[torch.Tensor] = None) -> None:
    """K5a on one pass (at most ``PASS_ROWS`` contiguous float32 rows on the
    card) into ``scratch`` (``scratch_elems`` bf16 at least)."""
    rows = positions.shape[0]
    if not 0 < rows <= PASS_ROWS or scratch.numel() < scratch_elems(rows):
        raise ValueError(f"a pass of {rows} rows needs 1..{PASS_ROWS} rows and "
                         f"{scratch_elems(rows)} scratch elements")
    lib = load()
    stream = ray_wgmma.bwd_stream(packed, cfg) if stream is None else stream
    err = lib.bwd_rows_wgmma(_ext.ptr(positions), _ext.ptr(directions), _ext.ptr(dsigma),
                             _ext.ptr(drgb), rows, _ext.ptr(stream), _ext.pointer_array(packed),
                             *net_args(cfg), _ext.ptr(scratch), _ext.stream_ptr(positions.device))
    _ext.check(lib, err, "bwd_rows_wgmma launch")
    launches["bwd_rows"] += _ext.ran()


def _jobs(cfg: ModelConfig, dev: torch.device) -> torch.Tensor:
    key = (dev, skip_position(cfg))
    if key not in _JOBS:
        _JOBS[key] = jobs_tensor(cfg).to(dev)
    return _JOBS[key]


def launch_wgrad(scratch: torch.Tensor, rows: int, cfg: ModelConfig, partials: torch.Tensor,
                 slot: int) -> int:
    """K5b on the scratch of a pass of ``rows`` rows, into slots ``slot ..
    slot + n_splits(rows) - 1`` of ``partials`` [slots, GRAD_FLOATS]; returns
    the next free slot."""
    splits = n_splits(rows)
    if partials.shape[1:] != (GRAD_FLOATS,) or not 0 <= slot <= partials.shape[0] - splits:
        raise ValueError(f"partials {tuple(partials.shape)} have no slots {slot}..+{splits}")
    lib = load()
    jobs = _jobs(cfg, scratch.device)
    err = lib.wgrad_wgmma(_ext.ptr(scratch), rows, _ext.ptr(jobs), jobs.shape[0], splits,
                          _ext.ptr(partials), slot, GRAD_FLOATS, _ext.stream_ptr(scratch.device))
    _ext.check(lib, err, "wgrad_wgmma launch")
    launches["wgrad"] += _ext.ran()
    return slot + splits


def _launch(packed: PackedWeights, positions, directions, dsigma, drgb,
            cfg: ModelConfig, stream: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Launch K5: per pass of at most ``PASS_ROWS`` rows, the row pass K5a
    into one scratch and the weight-gradient pass K5b into the pass's slots
    of partials; the slots are summed here. ``stream``: ``bwd_stream`` of
    ``packed`` if the caller has it (made here otherwise)."""
    _check_inputs(packed, positions, directions, dsigma, drgb, cfg)
    dev = positions.device
    n = positions.shape[0]
    if n == 0:
        return {k: torch.zeros(s, dtype=torch.float32, device=dev)
                for k, s in GRAD_SHAPES.items()}
    positions, directions = positions.contiguous(), directions.contiguous()
    dsigma, drgb = dsigma.contiguous(), drgb.contiguous()
    stream = ray_wgmma.bwd_stream(packed, cfg) if stream is None else stream
    passes = pass_bounds(n, PASS_ROWS)
    scratch = torch.empty(scratch_elems(passes[0][1]), dtype=torch.bfloat16, device=dev)
    partials = torch.empty(sum(n_splits(p1 - p0) for p0, p1 in passes), GRAD_FLOATS,
                           dtype=torch.float32, device=dev)
    slot = 0
    for p0, p1 in passes:
        launch_rows(packed, positions[p0:p1], directions[p0:p1], dsigma[p0:p1], drgb[p0:p1],
                    cfg, scratch, stream)
        slot = launch_wgrad(scratch, p1 - p0, cfg, partials, slot)
    return grads_from_flat(partials.sum(0))


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
    ``tree_leaves``' order, and their gradients go back in the same order.
    ``spec = (cfg, dtype, paths)``. The forward's packed weights and, on the
    card, K5's weight stream (whose prefix K4 reads) are kept for the
    backward."""

    @staticmethod
    def forward(ctx, pos, dirs, spec, *leaves):
        cfg, dtype, paths = spec
        ctx.spec = spec
        ctx.save_for_backward(pos, dirs)
        packed = pack_params(tree_from_leaves(paths, leaves), cfg, dtype)
        stream = None if pos.device.type == "cpu" else ray_wgmma.bwd_stream(packed, cfg)
        ctx.packed, ctx.stream = packed, stream
        out = mlp_forward(packed, pos, dirs, cfg, stream)
        return out[:, 0], out[:, 1:4]

    @staticmethod
    def backward(ctx, d_sigma, d_rgb):
        cfg, _, paths = ctx.spec
        pos, dirs = ctx.saved_tensors
        ds, dr = d_sigma.float().contiguous(), d_rgb.float().contiguous()
        if ctx.stream is None:          # CPU tensors: the plain version
            g = packed_grads(ctx.packed, pos, dirs, ds, dr, cfg)
        else:                           # the card: K5 on the forward's stream
            g = _launch(ctx.packed, pos, dirs, ds, dr, cfg, ctx.stream)
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
