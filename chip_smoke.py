#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nerf_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--k5-reference DIGESTS.json]

Builds the CUDA kernels from ``nerf_tpu_torch/csrc`` (into ``build/``) and
holds each kernel against its plain PyTorch version at the main paths'
shapes: K1 uniform ray kernel, K2 compositor, K3 per-ray-depth ray kernel
(K1 and K3 with raw output and in their composited modes (B9), on every
weight route: the Hopper kernels of ``csrc/ray_wgmma.cu``, the bf16 build
for bf16, int8 and int16 weights and one for int8 compute), the
dequantize prologue ``dequant_stream`` (``csrc/dequant_stream.cu``: the intN
stream and resident parameters to bf16 once a call, bit for bit against its
plain version on int8 and int16 weights, ``dequant_check``), K4 per-sample
MLP forward (the per-sample Hopper kernel of
``csrc/ray_wgmma.cu``), K5 MLP backward (the Hopper row pass and
weight-gradient pass of ``csrc/mlp_backward_wgmma.cu``, each against its
plain version, the pair against float32 and bf16 autograd, run twice for
bit equality, and timed; the digests of the row pass's scratch
image and of the partials at 131,072, 393,216 and 65,537 rows,
``tools/k5_digest.py``, equal to those in ``--k5-reference``, a file
another commit's ``k5_digest`` wrote, when one is given), K6 planar compositor, K7 per-sample MLP
on int8 and int16 weights (the same Hopper kernel, on the prologue's bf16
stream), the ray kernels on quantized
weights (dequantized once a call), the int8-compute route (K8)
in K7, K1 and K3, the bf16 and planar raw outputs of K1 and K3 (B10), and
K3 at one depth per ray on every route (``c1_check``: the per-sample kernel
of the route's build, then K2, with and without its weights). K2
(``composite_rays_kernel`` of ``csrc/composite.cu``) is held against its
plain version at S = 1, 16, 32, 45, 64, 128, 192, 200 and 300 (the chunked
body) on float32 and bfloat16 raws, broadcast and per-ray depths and 1,
1,001 and 16,384 rays (``k2_check``; without weights bit-equal to with
them), its schedule against ``ops/composite_kernel.py``'s (``k2_build``),
and timed at every case at 16,384 rays beside an empty kernel, the launch
floor (``kernel_times`` float32, ``kernel_times_quant`` bfloat16). Then it
drives each path of the port, with every launch count set to 0 just before
and read just after, and fails unless every kernel of the path ran its
expected number of times:

- ``frame``: the benchmark render, 64 uniform samples (K1 -> K2);
- ``hier_frame``: the hierarchical render, 64 coarse + 128 importance
  samples (K1 -> K2 -> sample_pdf -> sort -> K3 at 192 depths -> K2);
- ``fused_frames``: both modes with ``fuse_composite=True`` (composited K1,
  composited K3, no K2);
- ``uniform_hier_frame``: the hierarchical render with
  ``use_importance=False`` (``render_rays`` on K4 + K6);
- ``compressed_frames`` / ``int8_frames``: ``CompressedEngine`` and
  ``Int8ComputeEngine`` in both modes (the ray kernels on int8 weights,
  dequantized once a call or multiplied as s8 x s8 -> s32), both modes
  again with ``fuse_composite=True`` (the composited K1/K3 on that route),
  in the uniform hierarchical mode (K7 + K6), and
  ``CompressedEngine(bits=16)``;
- ``mode_frames``: ``CudaEngine(raw_dtype="bfloat16")`` and
  ``CudaEngine(planar=True)`` in the hierarchical mode;
- ``render_zvals``: ``render_kernel.fused_render_zvals`` (K3 in its plain
  output form, differentiable in the weights) forward and backward at
  4,096 rays x 192 depths from a coarse pass + ``sample_pdf``: K3 forward,
  K5 backward for the reference network (autograd of ``apply_nerf`` for
  bmild, which K5 does not compute), int8 weights forward only, one depth
  per ray (K4 forward, K5 backward); held against K3's and K5's plain
  versions and float32 autograd, the rays' and depths' cotangents zero,
  fenced with ``monitor.sync``; one forward + backward timed beside bf16
  autograd of ``apply_nerf`` at the same points;
- ``accel_frames``: ``AccelEngine`` in the benchmark mode at 16, 32 and 64
  samples per ray (the occupancy grid, baked through K4 in the first frame's
  warm frame, places the depths by one launch a chunk of the depths kernel
  ``occupancy_z_kernel``: depths -> K3 -> K2; ``accel_bake`` and
  ``accel_depths`` hold the bake and the depths kernel, in every weight
  mode, stride and drawn form, against their plain versions, and time the
  kernel), its fused frame at 64 (composited K3), and the uniform
  benchmark frame at each count; both scored against float32 truth at 256
  uniform samples (the accel frame no more than 0.5 dB under the uniform,
  the JAX package's gate), and the accel frame against its plain versions
  on the CPU on a copy of the card's grid (>= 40 dB);
- ``train_steps``: ``NeRFTrainer`` on the procedural sphere scene at the
  default ``TrainConfig`` (2,048 rays, 64 + 128, bf16, jitter), full-width
  model from seed ``TRAIN_SEED``: 2 launches of K4 and 8 of each K5 kernel
  per step (passes of 65,536 samples), no render kernel; the loss must
  fall, and the first step's loss must match
  the same step through bf16 autograd of ``apply_nerf``; its ``train_epoch``
  is a CUDA graph of 8 steps, and the ``apply_nerf`` trainer's two epochs
  are one too (no kernel launched);
- ``train_resume``: a checkpoint saved and restored into a fresh trainer,
  then one more step in both: parameters bit-equal;
- ``train_graphed``: the train loop as CUDA graphs (``make_multi_train_step``
  through ``NeRFTrainer._multi_step_fn``): two eager runs of 20 steps and two
  calls of a 10-step graph from the same seed, all bit-equal (params, Adam
  moments, counts, generator state, the 20 losses); then 200 steps as 20
  fenced replays (ms per step, peak MB, the loss must fall), the 20
  replays again, each under the profiler (2 K4, 8 K5a and 8 K5b a step by
  kernel name: a replay advances no launch counter) and ``train_epoch`` (one chunk
  of 8 a pass: the first eager, counted, then captured; the second a
  replay, traced; 16 K4, 64 K5a, 64 K5b each);
- ``train_streaming``: ``NeRFTrainer.train_streaming`` on the port's C++ ray
  producer (``nerf_tpu_torch/runtime``), 200 steps at the default
  ``TrainConfig``: ms per step, time blocked in ``next_batch``, the loss
  must fall, two runs from one seed bit-equal, and ``assemble_tiles`` on a
  frame equal to the numpy scatter;
- ``train_default_seed``: the same steps from ``TrainConfig``'s default seed,
  as a record (nothing is required of its loss): the share of samples on
  which each network's ReLU'd density is positive before and after, and each
  network's loss. About half of all seeds start a network with a density of
  0 everywhere, in this package and in the JAX package alike (the density
  head's initial weights against 256 non-negative inputs);
- ``suite``: ``UnifiedBenchmarkSuite`` with all five engines on the trained
  weights, 200x150 and 800x600 at 32 and 64 samples, 2 orbit views: 40 rows,
  all successful, finite, view 0 not degenerate; the exact launches of K1
  (its dequantize and int8-compute routes among them), K2, K3 and K4 (the
  accel bake) over the sweep, and none of the others; the CSV, the JSON and
  the 40 PNGs, decoded here with ``zlib`` and equal to the frames; a
  ``profile_trace`` of one frame; ``quality_report`` against the plain
  ``torch`` engine (cuda and compressed >= 40 dB, int8 >= 30 dB in every
  informative cell, every SSIM <= 1) and ``gt_quality_report`` against it
  at 256 samples (accel no more than 0.5 dB under cuda at 16, 32, 64);
- ``bench_cuda``: ``python3 bench_cuda.py`` in a child process: exit code 0,
  one JSON line on stdout with its four keys and a positive value, its
  stderr's bmild frame, and its ratio to the ``frame`` phase's rays/s.
- the command line (``nerf_tpu_torch/cli``), called in this process through
  ``cli.main`` with ``--device cuda``; ``cli_pipeline`` and
  ``cli_streaming`` train on the procedural scene (the command line's
  stand-in for a missing Blender directory): ``cli_pipeline``
  (``pipeline``: 2 epochs at full width, then
  the benchmark of cuda, compressed, int8 and accel at 800x600@64, 2 views:
  the exact launches of the train loop's eager first chunk and of the
  suite's rule, the epochs' loss must fall, every row successful, each
  engine's ms/frame beside the ``suite`` phase's); ``cli_render``
  (``render --engine cuda`` at 800x600@64 in both modes with ``--trace``,
  and once untraced: ``rgb.png`` / ``depth.png`` equal the uint8 images of
  an in-process frame, the trace names the Hopper ray kernels);
  ``cli_export`` (the pipeline's checkpoint as a ``.pth``: params and a
  200x150 frame in both modes bit-equal to the ``.npz``'s);
  ``cli_compare`` (every engine at 128x128@32: the grid's tiles equal each
  engine's frame, no black image); ``cli_streaming`` (``train
  --streaming_steps 200``: 2 K4, 8 K5a, 8 K5b a step, the loss must fall);
  ``cli_smoke`` (``python3 -m nerf_tpu_torch.cli smoke`` in a child
  process: exit code 0); ``cli_decode`` (first a ``probe`` line: Pillow,
  matplotlib, pandas, psutil, the libpng and zlib headers, ``ldconfig``'s
  libpng and libz, g++; then the port's PNG decoder, ``runtime/png.cpp``,
  built here with g++ and linking nothing, on 10 RGBA PNGs at 200x200 and
  100 at 800x800 that this script writes with ``zlib``, a random alpha, row
  i under filter i % 5, the first of each set Adam7: bit-equal to the numpy
  composite ``rgb a + (1 - a)``, images/s and MB/s on one thread and on all,
  beside the CPU count: host work, no kernel); ``cli_blender`` (the
  procedural views, 40 train and 8 val at 400x400, written as a Blender
  directory of RGBA PNGs with a transparent background, then ``train
  --data_dir D --image_size 400 --epochs 2``: the native decoder reads
  both splits with Pillow unimportable, the loaded images equal the numpy
  composite, the train loop's eager first chunk launches K4 20, K5a 80, K5b
  80 and nothing else, the epochs' loss falls, ``final_model.npz`` is
  written).
- ``convergence``: ``tools/convergence_run.run(steps=2000)``, the recipe
  of the convergence run (procedural scene, 400x400, 40 views, 2,048 rays,
  64 + 128 with importance sampling, seed ``TRAIN_SEED``): val PSNR >= 20
  dB at step 2,000, the last tenth of the epochs' mean loss <= 0.5 x the
  first tenth's, its four validations bit-equal to the first four of the
  committed 24,000-step run (``results/convergence_torch``), its files with
  their keys (the params' keys those of
  ``results/convergence/final_params.npz``), and the exact launches: K5a
  and K5b 80 each (the eager first chunk), K4 20 + 80 for each view its
  four validations and its final render draw (chunks of 4,096 rays, coarse
  and fine), nothing else.
- multi-GPU on ``torch.distributed`` (``nerf_tpu_torch/parallel``,
  ``bench/scaling.py``) on this one card, at the training phases' config
  (seed ``TRAIN_SEED``, 2,048 rays, 64 + 128, bf16, jitter): ``nccl_probe``
  (two child ranks on the one device over NCCL, one all-reduce: what NCCL
  says is recorded; the two-process phases use NCCL if it took them, gloo
  on CUDA tensors if not); ``dist_world1`` (a process group of one over
  NCCL: ``make_sharded_train_step``'s 20 steps bit-equal to eager
  ``make_train_step``'s, K4 2 and K5 8 + 8 a step, ms per step beside it,
  the all-reduce's device time from a trace); ``dist_dp2`` (two child
  ranks, data 2 x model 1: the same loss on both each step, step 1 within
  rtol 1e-5 of one process's loss and its params within rtol 1e-4 / atol
  1e-6, each rank's K4 / K5 launches those of a step of 1,024 rays);
  ``dist_tp2`` (data 1 x model 2: each rank holds half the columns of the
  trunk's ``w``, ``mu`` and ``nu``; 5 steps bit-equal to one process's);
  ``scale`` (``python -m nerf_tpu_torch.cli scale`` at its defaults, then
  ``scaling_report`` over the card named 2 and 4 times, one shard each:
  K4's launches, frames stitched from 2 and 4 shards within 1e-5 of the
  one-shard frame, no scaling number); ``cli_dist`` (``train
  --num_processes 2`` on the card where the probe found that NCCL takes two
  ranks on one device; otherwise the line says why it did not run). Each
  child runs ``python3 chip_smoke.py --dist-child ...`` under a timeout.

The frames use trained weights from ``results/convergence/final_params.npz``
at 800x600 and are compared with the float32 plain PyTorch engine
(>= 40 dB; the int8-compute engine >= 30 dB). Each phase prints one JSON line. The last three lines are the
per-kernel summary, the card's name and power limit as ``nvidia-smi``
reports them, and ``{"ok": true, "device": ...}``. Any failed check exits
non-zero before that last line. Needs a CUDA device and ``nvcc`` (sm_90a);
it has no CPU path.
"""

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import types
import zlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, "results", "convergence", "final_params.npz")
W, H, SPP, CHUNK = 800, 600, 64, 16384
CAMERA_ANGLE_X = 0.6911112070083618
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12       # H100 SXM dense int8 tensor-core rate
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 rate
K1_TOL = 2e-2                 # rgb abs; sigma relative to max|sigma|
K2_TOL = 1e-5                 # rgb/acc abs; depth relative to max|depth|
B9_TOL = 1e-5                 # composited vs plain on the kernel's own raw: rgb/acc/w abs
K2_KERNEL = "composite_rays_kernel"   # K2 (csrc/composite.cu)
K2_RAYS = (1, 1001, 16384)    # k2_check's ray counts
K2_BODIES = 2 * (6 + 6 + 3 + 6 + 1)   # K2's instantiations: raw type x (run 1 at six
                              # segment widths, runs 2-7 at 32, EVEN runs 2, 4, 6, runs of 4
                              # at 4, 8, 16 lanes EVEN or not, chunked run 7)
K2_CHUNKED_S = 300            # k2_check's sample count past one chunk (224): 224 + 3 x 32
K2_DESIGN = ("a lane a contiguous run of ceil(S / P) samples (at most 7; past S = 224 chunks "
             "with the transmittance carried), every load of the run (16 bytes: one fp32 "
             "sample, two bf16) issued before any arithmetic, the run scanned serially in "
             "registers, one segmented shuffle scan of the run totals, the five sums a "
             "reduce-scatter; P = S / 4 for a power-of-two S >= 16 (runs of 4), else the "
             "smallest power of two >= S, at most 32, so a warp takes 32 / P rays; the "
             "weights only where asked, stored as contiguous rows; persistent blocks "
             "(occupancy x SMs) walking groups of rays")
PSNR_MIN = 40.0
PSNR_FLOOR = {"benchmark": 57.4, "hierarchical": 61.3}   # the bf16 CudaEngine against the
                              # float32 engine: 0.5 dB under the 57.9 / 61.8 dB of the
                              # kernels the floor was first set on
WGMMA = {"render_samples": "ray_wgmma_kernel", "render_zvals": "ray_z_wgmma_kernel"}
# the composited modes (B9) on the Hopper body
WGMMA_COMPOSITED = {"render_samples_composited": "ray_composite_wgmma_kernel",
                    "render_zvals_composited": "ray_z_composite_wgmma_kernel"}
B9_DESIGN = ("the raw kernels' Hopper body; each consumer warpgroup a lane of whole rays (2 x "
             "grid contiguous ranges of near-equal count) walked 64 rows a step in order; after "
             "the heads the quads put (sigma, r, g, b) into a 64 x 4 slot of the consumer, whose "
             "warps run the segmented exclusive log-transmittance scan by shuffles, one warp a "
             "ray segment, carrying each lane's state from step to step")
K4_KERNEL = "mlp_wgmma_kernel"   # K4 and K7: the per-sample kernel of csrc/ray_wgmma.cu
DEQUANT_KERNEL = "dequant_stream_kernel"   # the dequantize routes' prologue (csrc/dequant_stream.cu)
OCC_KERNEL = "occupancy_z_kernel"   # the accel engine's depths (csrc/occupancy.cu)
K4_DESIGN = ("the ray kernels' body (warpgroup wgmma m64n256k16 / m64n128k16, activations in "
             "registers, a producer warp streaming the weights by cp.async.bulk into an "
             "mbarrier ring, persistent blocks) with per-row positions and directions; the "
             "direction term two m64n128k16 SS products of a per-row bf16 encoding tile with "
             "wdir, which the stream carries after wc0")
K5_KERNELS = ("bwd_rows_wgmma_kernel", "wgrad_wgmma_kernel")   # K5a, K5b
TRAIN_COUNTERS = {K4_KERNEL: "mlp_forward", K5_KERNELS[0]: "bwd_rows", K5_KERNELS[1]: "wgrad"}
PSNR_MIN_INT8 = 30.0          # the int8-compute engine against the float32 engine (the JAX
                              # package's own bar for it: 20 dB)
QUANT_TOL = 3e-2              # the quantized routes vs their plain versions: rgb abs, sigma
                              # relative to max|sigma|. K1_TOL's reason (bf16 roundings summed
                              # in another order, growing with the sample count), on pruned and
                              # quantized weights, where one flipped rounding weighs more
K8_TOL = 6e-2                 # the int8-compute route vs its plain version. Its integer sums
                              # are exact, but the activations quantize per row against the
                              # row's absmax: where one bf16 activation rounds the other way
                              # (the encoding's ulps, the heads' summation order) a row's scale
                              # moves and all its 256 roundings are drawn again, so the two
                              # differ there by the route's own quantization noise (the frames'
                              # ~39 dB against float32), not by bf16's. The mean error stays
                              # small: most rows agree exactly
POS_BOUND = 12.0              # the engines' default bound on |sample position| for int8 compute
N_FINE = 128                  # the hierarchical fine pass: 64 coarse + 128 drawn depths
S3 = SPP + N_FINE             # depths per ray of the fine pass
TRAIN_RAYS = 2048             # TrainConfig.n_rays
N_COARSE_TRAIN = TRAIN_RAYS * SPP     # 131,072 samples: a train step's coarse pass
N_FINE_TRAIN = TRAIN_RAYS * S3        # 393,216 samples: its fine pass
K5_PASSES = 2 + 6              # K5a + K5b passes of 65,536 rows a step: coarse, fine
K5_PLAIN_TOL = 2e-2           # K5 vs its plain version, per leaf ||a - b|| / ||b||
K5B_PLAIN_TOL = 3e-4          # K5b's partials vs wgrad_split_plain on K5a's own scratch, per
                              # slot and leaf: both sum the same bf16 values in float32
                              # (observed on the H100: <= 3.1e-5); a split of a full pass
                              # sums ~170 sample blocks, so one dropped block moves a slot
                              # by ~1/170
K5_MIN_TOL = 0.02             # worst leaf vs float32 autograd: max(2 x bf16 autograd's, this)
TRAIN_STEPS = 200             # 25 passes over 8 views
TRAIN_SEED = 3                # both networks' densities are alive at this seed's start
LOSS_DROP = 0.75              # mean loss of the last 10 steps <= this x the first 10's
GRAPH_STEPS = 10              # steps in one CUDA graph of the train loop (train_epoch's chunk)
GRAPH_REPLAYS = 20            # timed replays of it: 200 steps
RETRACES = 2                  # more traces of a replay whose trace lost kernel records
                              # (observed on the H100: 0.61, from 0.391 to 0.240)
LOSS_TOL = 2e-2               # a loss through the kernels vs through bf16 autograd, relative
ACCEL_SPP = (16, 32, 64)      # the accel frames' samples per ray
TRUTH_SPP = 256               # the float32 truth the accel and uniform frames are scored against
ACCEL_DB_MARGIN = 0.5         # accel PSNR >= uniform PSNR - this at each spp (the JAX
                              # package's gate, tests/test_occupancy.py)
BAKE_CHUNK = 1 << 18          # points per K4 launch of the grid bake (ops/occupancy.py)
BAKE_F32_TOL = 0.1            # the bf16 bake vs float32 apply_nerf, relative to max sigma: bf16
                              # activations through 8 layers (the CPU bake at G = 64 differs by
                              # 3.6% of max sigma)
BAKE_FLIPS = 0.01             # binary cells that flip at the threshold, share of occupied ones
                              # (the CPU bake at G = 64: 46 of 37,166)
Z_TOL = 1e-3                  # depths, card vs CPU: sample_pdf's sums in another order
SUITE_RES = ((200, 150), (800, 600))   # the suite's sweep: 5 engines x 2 x 2 x 2 views = 40 rows
SUITE_SPP = (32, 64)
SUITE_VIEWS = 2
# launches over the suite's sweep, by counter (every other counter 0; the
# torch engine launches nothing). A kernel engine renders 66 chunks of
# 16,384 rays a sample count: one warm frame per (mode, spp, chunk), and the
# chunk is 16,384 at both sizes, so only 200 x 150 warms (2 chunks), then 2
# views x 2 chunks at 200 x 150 and 2 views x 30 at 800 x 600; 132 over
# both counts. K1 on cuda, compressed (dequantize route, each call after
# dequant_stream) and int8 (int8 compute); K3 on accel; K2 after each of the
# four; K4 the accel bake, once (128^3 points, 262,144 a launch)
SUITE_LAUNCHES = {"render_samples": 396, "dequant": 132, "dequant_stream": 132, "int8": 132,
                  "render_zvals": 132, "composite": 528, "mlp_forward": 8, "occupancy": 132}
SUITE_DB = {"cuda": 40.0, "compressed": 40.0, "int8": 30.0}   # quality_report, every
                              # informative cell against the torch engine (PERF.md section 2)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """(name, microseconds) of every GPU kernel and copy in a profile."""
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()[:60]
            yield name, e.time_range.elapsed_us()


def call_ms(fn, reps):
    """Stream time per call between two CUDA events around ``reps``
    back-to-back calls: the device time, or the host's cost to launch where
    that is longer."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*tensors):
    """Bytes of each tensor's storage, read once (a broadcast view counts
    the one row it holds)."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        total += span * t.element_size()
    return total


def k1_flops(cfg, n_rays, S):
    h, ch = 256, 128
    per_sample = (cfg.pos_dim * h + 7 * h * h + cfg.pos_dim * h   # trunk + skip
                  + h + h * ch + ch * 3)                          # sigma, color
    if cfg.variant == "bmild":
        per_sample += h * h                                       # bottleneck
    return 2 * (per_sample * n_rays * S + cfg.dir_dim * ch * n_rays)


def trunk_flops(cfg, n_samples):
    """Operations of the products the int8-compute route runs as s8 x s8:
    layer 0, the trunk layers and the skip rows."""
    return 2 * n_samples * (2 * cfg.pos_dim * 256 + 7 * 256 * 256)


def bound_ms(bf16_flops, f32_flops, nbytes_, int8_ops=0):
    """(ms, what binds): max(bytes / HBM rate, bf16 MMA operations /
    tensor-core rate + int8 MMA operations / int8 tensor-core rate + float32
    operations / float32 rate)."""
    t_ops = (bf16_flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
             + f32_flops / PEAK_F32_FLOPS)
    t_bytes = nbytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def composite_ptxas(log):
    """ptxas's report of csrc/composite.cu by kernel: registers, stack and
    spill bytes; K2's bodies named by their run, segment, raw type, EVEN and
    CHUNKED."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
            m = re.search(r"(composite_rays_kernel)ILi(\d+)ELi(\d+)E(f|13__nv_bfloat16)Lb([01])E"
                          r"Lb([01])E", name)
            if m:
                entry = (f"{m[1]}<{m[2]}, {m[3]}, {'float' if m[4] == 'f' else 'bf16'}, "
                         f"{m[5] == '1'}, {m[6] == '1'}>")
            else:
                m = re.search(r"(composite_planar_kernel|empty_kernel)", name)
                entry = m[1] if m else name
        elif entry and "spill" in ln:
            nums = [int(t) for t in ln.replace(",", " ").split() if t.isdigit()]
            out[entry] = dict(stack_bytes=nums[0], spill_store_bytes=nums[1],
                              spill_load_bytes=nums[2])
        elif entry and "Used" in ln and "registers" in ln and entry in out:
            out[entry]["registers"] = int(ln.split("Used")[1].split()[0])
            entry = None
    return out


def camera_rays(pose, focal, dev, n, seed):
    from nerf_tpu_torch.utils.cameras import generate_rays

    ro, rd = generate_rays(pose, W, H, focal, dev)
    idx = torch.randperm(W * H, generator=torch.Generator().manual_seed(seed))[:n]
    return ro.reshape(-1, 3)[idx.to(dev)].contiguous(), rd.reshape(-1, 3)[idx.to(dev)].contiguous()


def with_padding(ro, rd, n_pad):
    """Append rays of zero origin and unit direction, as a frame's last
    chunk is padded."""
    dev = ro.device
    return (torch.cat([ro, torch.zeros(n_pad, 3, device=dev)]),
            torch.cat([rd, torch.ones(n_pad, 3, device=dev)]))


def hier_depths(render_kernel, composite_kernel, sample_pdf, packed, ro, rd, mcfg, rcfg):
    """The fine pass's depths [R, 192] from a coarse pass of the kernels
    (K1 + K2 at 64 uniform depths) and ``sample_pdf``, as CudaEngine makes
    them."""
    raw_c, z_c = render_kernel.fused_render_samples(packed, ro, rd, rcfg.near, rcfg.far, SPP,
                                                    mcfg, raw=True)
    out_c = composite_kernel.fused_volume_render_interleaved(raw_c, z_c, rd, rcfg)
    z_new = sample_pdf(z_c, out_c.weights, N_FINE, deterministic=True)
    return torch.sort(torch.cat([z_c, z_new], -1), -1).values


def rgb_sigma_err(raw_k, raw_p):
    """(max abs rgb error, max sigma error relative to max|sigma|)."""
    rgb_err = (raw_k.reshape(-1, 4)[:, 1:] - raw_p.reshape(-1, 4)[:, 1:]).abs().max().item()
    sk, sp = raw_k[:, 0::4], raw_p[:, 0::4]
    sig_scale = sp.abs().max().item()
    return rgb_err, (sk - sp).abs().max().item() / max(sig_scale, 1e-6), sig_scale


def agreement(raw_k, raw_p):
    """Mean abs rgb error and the share of all values (sigma, r, g, b) that
    are bit-equal: the kernels sum in another order than the plain version,
    so they agree to bf16's rounding, not bit for bit."""
    k, p = raw_k.reshape(-1, 4).float(), raw_p.reshape(-1, 4).float()
    return dict(rgb_mean_abs_err=(k[:, 1:] - p[:, 1:]).abs().mean().item(),
                share_bit_equal=(k == p).float().mean().item())


def composited_err(out_k, w_k, out_p, w_p):
    """(rgb/acc max abs, depth max rel, w max abs) between two composited
    outputs."""
    e_rgb_acc = (out_k[:, [0, 1, 2, 4]] - out_p[:, [0, 1, 2, 4]]).abs().max().item()
    e_depth = ((out_k[:, 3] - out_p[:, 3]).abs().max() / out_p[:, 3].abs().max()).item()
    e_w = (w_k - w_p).abs().max().item() if w_k is not None else 0.0
    return e_rgb_acc, e_depth, e_w


def profile_frame(render):
    """Device microseconds and launches by kernel name over one call of
    ``render`` (torch.profiler), and the call's result."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = render()
    us, n = {}, {}
    for name, t in device_events(prof):
        us[name] = us.get(name, 0.0) + t
        n[name] = n.get(name, 0) + 1
    return res, us, n


def profiled_ms(fn, kernel, reps):
    """Device ms per launch of the CUDA kernel named ``kernel`` over ``reps``
    calls of ``fn`` (torch.profiler), or None if it did not run once a call."""
    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    _, us, n = profile_frame(run)
    if n.get(kernel) != reps:
        emit("profiler_note", kernel=kernel, expected_launches=reps, traced=n.get(kernel, 0),
             note="the trace does not hold one event per launch; timed by CUDA events instead")
        return None
    return us[kernel] / reps / 1e3


def profiled_kernels_ms(fn, kernels, reps):
    """Per named CUDA kernel: device ms per call and launches per call over
    ``reps`` calls of ``fn`` (torch.profiler), or None if the trace does not
    hold the same number of launches of each in every call."""
    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    _, us, n = profile_frame(run)
    if any(n.get(k, 0) == 0 or n[k] % reps for k in kernels):
        emit("profiler_note", kernels=list(kernels), reps=reps,
             traced={k: n.get(k, 0) for k in kernels},
             note="the trace does not hold every launch; timed by CUDA events instead")
        return None
    return {k: {"ms": us[k] / reps / 1e3, "launches_per_call": n[k] // reps} for k in kernels}


def decode_png(path):
    """An 8-bit greyscale or RGB PNG without row filters, as the suite's
    ``write_png`` writes them, decoded with ``zlib``; every chunk's CRC is
    checked."""
    with open(path, "rb") as f:
        data = f.read()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        require(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body),
                f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    require(depth == 8 and color in (0, 2), f"{path}: bit depth {depth}, color type {color}")
    ch = 1 if color == 0 else 3
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    require(not rows[:, 0].any(), f"{path}: filtered rows")
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def psnr(a, b):
    from nerf_tpu_torch.utils.metrics import psnr as psnr_db

    return float(psnr_db(a, b))


def mlp_macs(cfg, with_dgrad_only=False):
    """Multiply-adds per sample of the per-sample network (direction branch
    per sample); ``with_dgrad_only``: those of its layers whose input needs a
    gradient (all but the products that read an encoding)."""
    h, ch = 256, 128
    enc = cfg.pos_dim * h * 2 + cfg.dir_dim * ch          # layer 0, skip rows, direction rows
    rest = 7 * h * h + h + h * ch + ch * 3
    if cfg.variant == "bmild":
        rest += h * h
    return rest if with_dgrad_only else enc + rest


def worst_rel(a, b):
    """(largest ||a - b|| / ||b|| over the leaves of two dicts, per leaf)."""
    rels = {str(k): ((a[k] - b[k]).norm() / (b[k].norm() + 1e-20)).item() for k in a}
    return max(rels.values()), rels


# ---------------------------------------------------------------------------
# multi-GPU on torch.distributed (nerf_tpu_torch/parallel, bench/scaling.py)

DIST_STEPS = 20               # sharded steps held against eager make_train_step (dist_world1, dp2)
TP_STEPS = 5                  # tensor-parallel steps held against it bit for bit (dist_tp2)
DIST_HW = (200, 200)          # the training phases' scene: 8 procedural views
DP_LOSS_RTOL = 1e-5           # data-parallel step 1 vs one process: tests/test_sharding.py:61-69
DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-4, 1e-6
SCALE_TOL = 1e-5              # a frame stitched from shards vs the one-shard frame
CHILD_TIMEOUT = 240           # seconds a child process may take


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_setup(dev):
    """The training phases' config (the default Config, white background,
    seed TRAIN_SEED) and scene (images and poses on ``dev``)."""
    from nerf_tpu_torch.config import default_config
    from nerf_tpu_torch.data.synthetic import make_procedural_dataset

    cfg = default_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, white_background=True),
                              train=dataclasses.replace(cfg.train, seed=TRAIN_SEED))
    ds = make_procedural_dataset(n_views=8, img_wh=DIST_HW)
    images = torch.as_tensor(np.asarray(ds.images, np.float32), device=dev)
    poses = torch.as_tensor(np.asarray(ds.poses, np.float32), device=dev)
    return cfg, images, poses, float(ds.focal)


def leaf_arrays(state):
    """{path: numpy} of a train state's params, mu and nu."""
    from nerf_tpu_torch.utils.tree import tree_leaves

    out = {}
    for (path, leaf), mu, nu in zip(tree_leaves(state.params), state.optimizer.mu,
                                    state.optimizer.nu):
        key = "/".join(map(str, path))
        out[f"param {key}"] = leaf.detach().cpu().numpy()
        out[f"mu {key}"] = mu.cpu().numpy()
        out[f"nu {key}"] = nu.cpu().numpy()
    return out


def k5_passes(n_rays):
    """K5a (and K5b) launches of one train step of ``n_rays`` rays."""
    from nerf_tpu_torch.ops import train_kernel

    return sum(len(train_kernel.pass_bounds(n_rays * s)) for s in (SPP, S3))


def child_main(argv):
    """One rank of a two-process phase: ``--dist-child MODE RANK WORLD PORT
    BACKEND OUT``. ``probe``: one all-reduce; ``dp2`` / ``tp2``: the sharded
    train step on a 2 x 1 / 1 x 2 mesh. Writes its result to OUT (JSON, and
    OUT.npz with rank 0's gathered state)."""
    mode, rank, world, port, backend, out = argv
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    from nerf_tpu_torch.parallel import (make_mesh, make_sharded_train_step, shard_train_state,
                                         tp_param_shardings)
    from nerf_tpu_torch.parallel.train import gather_train_state, initialize_distributed
    from nerf_tpu_torch.train.trainer import init_train_state
    from nerf_tpu_torch.utils.tree import tree_leaves

    res = {"mode": mode, "rank": rank, "backend": backend}
    if mode == "probe":      # what the backend says to two ranks on one card, recorded
        try:
            initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend)
            x = torch.full((4,), rank + 1.0, device="cuda")
            dist.all_reduce(x)
            torch.cuda.synchronize()
            res.update(ok=x.tolist() == [float(world * (world + 1) // 2)] * 4, values=x.tolist())
            dist.destroy_process_group()
        except Exception as e:      # the probe's finding, not a failure of this script
            res.update(ok=False, error=f"{type(e).__name__}: {e}"[-1500:])
        with open(out, "w") as f:
            json.dump(res, f)
        sys.stdout.flush()
        os._exit(0)                 # no teardown of a communicator in error: it may wait
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend)
    tp = mode == "tp2"
    mesh = make_mesh(*((1, 2) if tp else (2, 1)))
    cfg, images, poses, focal = dist_setup(mesh.device)
    state = shard_train_state(init_train_state(torch.Generator().manual_seed(TRAIN_SEED), cfg,
                                               mesh.device), mesh, tp=tp)
    step = make_sharded_train_step(cfg, DIST_HW, mesh, tp=tp)
    g = torch.Generator(device=mesh.device).manual_seed(TRAIN_SEED)
    reset_counts()
    losses, secs = [], []
    for k in range(TP_STEPS if tp else DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, images[k % len(images)], poses[k % len(poses)], focal, g)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        if k == 0 and not tp and rank == 0:
            np.savez(out + ".npz", **leaf_arrays(state))
    res.update(losses=losses, counts=read_counts(), coords=list(mesh.coords),
               ms_per_step=float(np.median(secs[1:])) * 1e3)
    # the step's collective alone, on a buffer of its size: the gradients
    # and 3 losses over the data group, or the split leaves over the model
    # group (the gather of the model axis)
    split = [a for _, a in tree_leaves(tp_param_shardings(state.params, mesh))]
    n = (sum(x.numel() * 2 for x, a in zip(state.leaves(), split) if a is not None) if tp
         else sum(x.numel() for x in state.leaves()) + 3)
    buf = torch.zeros(n, device=mesh.device)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.model_group if tp else mesh.data_group)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res.update(collective_bytes=4 * n, collective_ms=float(np.median(times[1:])) * 1e3)
    if tp:
        whole = gather_train_state(state, mesh, tp=True)
        if rank == 0:
            np.savez(out + ".npz", **leaf_arrays(whole))
        # every trunk and bottleneck leaf, its mu and its nu: half the
        # columns (the split axis) of the whole; the heads whole
        opt, misshapen = state.optimizer, []
        for (path, leaf), a, mu, nu, full in zip(tree_leaves(state.params), split, opt.mu,
                                                 opt.nu, whole.leaves()):
            want = list(full.shape)
            if a is not None:
                want[a] //= 2
            if not all(list(t.shape) == want for t in (leaf, mu, nu)):
                misshapen.append("/".join(map(str, path)))
        i = [p for p, _ in tree_leaves(state.params)].index(("fine", "trunk", 1, "w"))
        res.update(split_leaves=sum(a is not None for a in split), misshapen=misshapen,
                   local_shapes={"w": list(state.leaves()[i].shape),
                                 "mu": list(opt.mu[i].shape), "nu": list(opt.nu[i].shape)})
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def run_children(mode, backend, workdir, world=2):
    """Start ``world`` ranks of ``mode`` as child processes of this script
    (each under CHILD_TIMEOUT); returns (procs, out paths)."""
    port = free_port()
    outs = [os.path.join(workdir, f"{mode}_{backend}_rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-child", mode,
                               str(r), str(world), str(port), backend, outs[r]], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, outs


def wait_children(name, procs, outs, timeout=CHILD_TIMEOUT, must_succeed=True):
    """Wait for the children (killing all of them past ``timeout`` seconds,
    which fails the run); returns their results. With ``must_succeed`` a
    non-zero exit code or a missing result fails the run; without, a child
    that wrote nothing gives ``{"ok": False, "error": <its output's tail>}``."""
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        raise SystemExit(f"chip_smoke FAILED: {name}: a child ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for p, out, log in zip(procs, outs, logs):
        if must_succeed:
            require(p.returncode == 0 and os.path.exists(out),
                    f"{name}: a child exited {p.returncode}: {log[-3000:]}")
        if os.path.exists(out):
            with open(out) as f:
                results.append(json.load(f))
        else:
            results.append({"ok": False, "returncode": p.returncode, "error": log[-1500:]})
    return results


def multi_gpu_phases(dev, smi, paths, run_cli, workdir):
    """dist_world1, the backend probe, dist_dp2, dist_tp2, scale, cli_dist."""
    import torch.distributed as dist

    from nerf_tpu_torch.bench.scaling import _make_sharded_render, assemble_frame, scaling_report
    from nerf_tpu_torch.config import default_config
    from nerf_tpu_torch.models.nerf import params_from_numpy
    from nerf_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_train_state
    from nerf_tpu_torch.train.checkpoint import restore_bare_params
    from nerf_tpu_torch.train.trainer import (default_train_apply_fn, init_train_state,
                                              make_train_step)

    t_dist = time.perf_counter()
    # -- the probe: two ranks on this one card over NCCL -----------------------
    probe = run_children("probe", "nccl", workdir)
    probe_res = wait_children("nccl_probe", *probe, timeout=120, must_succeed=False)
    nccl_two = all(r.get("ok") for r in probe_res)
    emit("nccl_probe", world_size=2, device="cuda:0 for both ranks", ok=nccl_two,
         results=probe_res, returncodes=[p.returncode for p in probe[0]])
    backend = "nccl" if nccl_two else "gloo"

    cfg, images, poses, focal = dist_setup(dev)
    n_views = images.shape[0]

    def steps(step, state, n, snapshots=()):
        g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        losses, secs, snaps = [], [], {}
        for k in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, images[k % n_views], poses[k % n_views], focal, g)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
            if k + 1 in snapshots:
                snaps[k + 1] = leaf_arrays(state)
        return losses, float(np.median(secs[5:])) * 1e3, snaps

    def fresh():
        return init_train_state(torch.Generator().manual_seed(TRAIN_SEED), cfg, dev)

    # -- the reference: eager make_train_step on the kernels (K4 + K5), one process
    ref_losses, ref_ms, ref = steps(make_train_step(cfg, DIST_HW, default_train_apply_fn(cfg, dev)),
                                    fresh(), DIST_STEPS, (1, TP_STEPS, DIST_STEPS))

    # -- dist_world1: a process group of one over NCCL, the sharded step -------
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh()
        state = shard_train_state(fresh(), mesh)
        step = make_sharded_train_step(cfg, DIST_HW, mesh)
        reset_counts()
        w1_losses, w1_ms, w1 = steps(step, state, DIST_STEPS, (DIST_STEPS,))
        paths["dist_world1"] = counts = read_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, images[0], poses[0], focal, torch.Generator(device=dev).manual_seed(1))
            torch.cuda.synchronize()
        nccl_us, nccl_n, busy_us = {}, {}, 0.0
        for name, t in device_events(prof):
            busy_us += t
            if "nccl" in name.lower():
                nccl_us[name] = nccl_us.get(name, 0.0) + t
                nccl_n[name] = nccl_n.get(name, 0) + 1
        # the all-reduce alone, on the step's buffer (gradients and 3 losses)
        flat = torch.zeros(sum(x.numel() for x in state.leaves()) + 3, device=dev)
        allreduce_ms = call_ms(lambda: dist.all_reduce(flat), 20)
    finally:
        dist.destroy_process_group()
    per_step = {"mlp_forward": 2, "bwd_rows": k5_passes(TRAIN_RAYS), "wgrad": k5_passes(TRAIN_RAYS)}
    want = {k: v * DIST_STEPS for k, v in per_step.items()}
    bit_equal = w1_losses == ref_losses and all(
        np.array_equal(a, ref[DIST_STEPS][k]) for k, a in w1[DIST_STEPS].items())
    emit("dist_world1", backend="nccl", world_size=1, mesh=[1, 1], steps=DIST_STEPS,
         rays_per_step=TRAIN_RAYS, launches=counts, expected=want,
         losses_bit_equal_to_make_train_step=w1_losses == ref_losses,
         state_bit_equal_to_make_train_step=bit_equal, first_loss=w1_losses[0],
         last_loss=w1_losses[-1], ms_per_step=w1_ms, make_train_step_ms_per_step=ref_ms,
         nccl_kernels_device_ms={k: v / 1e3 for k, v in nccl_us.items()},
         nccl_kernel_launches=nccl_n, allreduce_device_ms=sum(nccl_us.values()) / 1e3,
         traced_step_device_busy_ms=busy_us / 1e3, allreduce_bytes=4 * flat.numel(),
         allreduce_event_ms=allreduce_ms,
         nvidia_smi=smi)
    for k in set(counts) | set(want):
        require(counts.get(k, 0) == want.get(k, 0),
                f"dist_world1: {k} launched {counts.get(k, 0)} times, expected {want.get(k, 0)}")
    require(bit_equal, "dist_world1: the sharded step through NCCL differs from make_train_step")
    del state

    # -- dist_dp2 and dist_tp2: two processes each, at the same time -----------
    dp = run_children("dp2", backend, workdir)
    tp = run_children("tp2", backend, workdir)
    dp_res, tp_res = wait_children("dist_dp2", *dp), wait_children("dist_tp2", *tp)

    half = {"mlp_forward": 2, "bwd_rows": k5_passes(TRAIN_RAYS // 2),
            "wgrad": k5_passes(TRAIN_RAYS // 2)}
    paths["dist_dp2"] = {k: sum(r["counts"].get(k, 0) for r in dp_res) for k in dp_res[0]["counts"]}
    same_each_step = dp_res[0]["losses"] == dp_res[1]["losses"]
    loss1_rel = abs(dp_res[0]["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    with np.load(dp[1][0] + ".npz") as f:
        dp_params = {k: f[k] for k in f.files if k.startswith("param")}
    worst, beyond = 0.0, 0
    for k, a in dp_params.items():
        b = ref[1][k]
        excess = np.abs(a - b) - (DP_PARAM_ATOL + DP_PARAM_RTOL * np.abs(b))
        worst = max(worst, float(np.abs(a - b).max()))
        beyond += int((excess > 0).sum())
    loss20_rel = max(abs(a - b) / abs(b) for a, b in zip(dp_res[0]["losses"], ref_losses))
    emit("dist_dp2", backend=backend, world_size=2, mesh=[2, 1], steps=DIST_STEPS,
         rays_per_rank=TRAIN_RAYS // 2, launches_by_rank=[r["counts"] for r in dp_res],
         expected_per_rank={k: v * DIST_STEPS for k, v in half.items()},
         ranks_same_loss_each_step=same_each_step, step1_loss=dp_res[0]["losses"][0],
         step1_loss_single_process=ref_losses[0], step1_loss_rel_diff=loss1_rel,
         loss_rtol=DP_LOSS_RTOL, step1_params_max_abs_diff=worst,
         step1_params_beyond_tolerance=beyond, param_rtol=DP_PARAM_RTOL,
         param_atol=DP_PARAM_ATOL, max_rel_loss_diff_over_steps=loss20_rel,
         ms_per_step_by_rank=[r["ms_per_step"] for r in dp_res],
         gradient_allreduce_ms_by_rank=[r["collective_ms"] for r in dp_res],
         gradient_allreduce_bytes=dp_res[0]["collective_bytes"], nvidia_smi=smi)
    for r in dp_res:
        for k in set(r["counts"]) | set(half):
            require(r["counts"].get(k, 0) == half.get(k, 0) * DIST_STEPS,
                    f"dist_dp2: rank {r['rank']} launched {k} {r['counts'].get(k, 0)} times")
    require(same_each_step, "dist_dp2: the ranks' losses differ")
    require(loss1_rel <= DP_LOSS_RTOL, f"dist_dp2: step 1 loss {loss1_rel} from one process's")
    require(beyond == 0, f"dist_dp2: {beyond} params beyond rtol {DP_PARAM_RTOL} / atol "
            f"{DP_PARAM_ATOL} after step 1 (largest difference {worst})")

    whole = {"mlp_forward": 2, "bwd_rows": k5_passes(TRAIN_RAYS), "wgrad": k5_passes(TRAIN_RAYS)}
    paths["dist_tp2"] = {k: sum(r["counts"].get(k, 0) for r in tp_res) for k in tp_res[0]["counts"]}
    with np.load(tp[1][0] + ".npz") as f:
        tp_state = {k: f[k] for k in f.files}
    tp_bit_equal = all(np.array_equal(a, ref[TP_STEPS][k]) for k, a in tp_state.items())
    tp_losses_equal = all(r["losses"] == ref_losses[:TP_STEPS] for r in tp_res)
    halves = all(r["local_shapes"] == {k: [256, 128] for k in ("w", "mu", "nu")}
                 and not r["misshapen"] and r["split_leaves"] == 32 for r in tp_res)
    emit("dist_tp2", backend=backend, world_size=2, mesh=[1, 2], steps=TP_STEPS,
         launches_by_rank=[r["counts"] for r in tp_res],
         expected_per_rank={k: v * TP_STEPS for k, v in whole.items()},
         local_shapes_fine_trunk_1=[r["local_shapes"] for r in tp_res],
         split_leaves_by_rank=[r["split_leaves"] for r in tp_res],
         leaves_not_halved=[r["misshapen"] for r in tp_res],
         losses_bit_equal=tp_losses_equal, gathered_state_bit_equal=tp_bit_equal,
         ms_per_step_by_rank=[r["ms_per_step"] for r in tp_res],
         weight_gather_allreduce_ms_by_rank=[r["collective_ms"] for r in tp_res],
         weight_gather_bytes=tp_res[0]["collective_bytes"], nvidia_smi=smi)
    for r in tp_res:
        for k in set(r["counts"]) | set(whole):
            require(r["counts"].get(k, 0) == whole.get(k, 0) * TP_STEPS,
                    f"dist_tp2: rank {r['rank']} launched {k} {r['counts'].get(k, 0)} times")
    require(halves, "dist_tp2: a rank holds other than half the columns of a trunk leaf, its "
            "mu or its nu")
    require(tp_losses_equal and tp_bit_equal, "dist_tp2: differs from the single process")

    # -- scale: the command line at its defaults, then the report over one card
    #    named 2 and 4 times (one shard each: no scaling number)
    scale_dir = os.path.join(workdir, "scale")
    spp, (sw, sh), n_frames = 64, (400, 300), 2
    lines, secs = run_cli("scale", ["scale", "--device", "cuda", "--checkpoint", PARAMS,
                                    "--output_dir", scale_dir], {"mlp_forward": 1 + n_frames})
    with open(os.path.join(scale_dir, "scaling_report.json")) as f:
        cli_rows = json.load(f)
    png = decode_png(os.path.join(scale_dir, "scaling_frame.png"))
    scfg = default_config()
    fine = params_from_numpy(restore_bare_params(PARAMS)["fine"], dev)
    from nerf_tpu_torch.utils.cameras import generate_rays

    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    ro, rd = (t.reshape(-1, 3) for t in generate_rays(pose, sw, sh, 800.0, dev))
    frames, frame_err = {}, {}
    for nd in (1, 2, 4):
        pad = (-ro.shape[0]) % nd
        render = _make_sharded_render(fine, scfg, [dev] * nd, spp)
        frames[nd] = assemble_frame(*render(torch.cat([ro, ro.new_zeros(pad, 3)]),
                                            torch.cat([rd, rd.new_ones(pad, 3)])),
                                    sw * sh, (sw, sh))
        frame_err[nd] = max(float(np.abs(frames[nd][0] - frames[1][0]).max()),
                            float(np.abs(frames[nd][1] - frames[1][1]).max()))
    png_equal = np.array_equal(png, (np.clip(frames[1][0], 0, 1) * 255).astype(np.uint8))
    reports = {}
    for k in (2, 4):
        reset_counts()
        rows = scaling_report(fine, scfg, resolution=(sw, sh), spp=spp, focal=800.0,
                              devices=[dev] * k, n_frames=n_frames, log=lambda m: None)
        torch.cuda.synchronize()
        paths[f"scale_x{k}"] = read_counts()
        reports[k] = [r.__dict__ for r in rows]
        want = sum((1 + n_frames) * nd for nd in (1, 2, 4) if nd <= k)   # a shard a launch
        require(paths[f"scale_x{k}"]["mlp_forward"] == want,
                f"scale: K4 launched {paths[f'scale_x{k}']['mlp_forward']} times over devices "
                f"x{k}, expected {want}")
    emit("scale", argv=f"scale --checkpoint final_params.npz (--resolution {sw}x{sh} --samples "
         f"{spp}: the defaults)", cli_rows=cli_rows, cli_launches=paths["scale"],
         cli_png_equal_one_shard_frame=png_equal, frame_max_abs_diff_vs_one_shard=frame_err,
         tol=SCALE_TOL, reports=reports, launches={k: paths[f"scale_x{k}"] for k in (2, 4)},
         note="one card named 2 and 4 times, one shard each: not a scaling number",
         seconds=secs, nvidia_smi=smi)
    require(png_equal, "scale: the command line's PNG differs from the one-shard frame")
    require(all(e <= SCALE_TOL for e in frame_err.values()), f"scale: frames differ {frame_err}")
    require(all(r["distinct_devices"] is (r["n_devices"] == 1) for rows in reports.values()
                for r in rows), f"scale: rows {reports}")

    # -- cli_dist: train --num_processes 2 on this card (NCCL, the command
    #    line's backend on a CUDA device), where the probe found NCCL takes
    #    two ranks on one device
    if not nccl_two:
        emit("cli_dist", ran=False, reason="NCCL refused two ranks on one device (nccl_probe); "
             "the command line's distributed train runs over gloo only with --device cpu, in "
             "tests/test_torch_parallel.py", probe_errors=[r.get("error") for r in probe_res])
    else:
        port = free_port()
        ckpt_dir = os.path.join(workdir, "cli_dist")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "nerf_tpu_torch.cli", "train", "--device", "cuda",
             "--data_dir", os.path.join(workdir, "no_blender_dataset"), "--image_size", "200",
             "--streaming_steps", "20", "--checkpoint_dir", ckpt_dir,
             "--output_dir", ckpt_dir, "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(r)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        finals = [ln for log in logs for ln in log.splitlines() if "FINAL LOSS" in ln]
        emit("cli_dist", ran=True, returncodes=[p.returncode for p in procs], final_lines=finals,
             checkpoint=os.path.exists(os.path.join(ckpt_dir, "final_model.npz")))
        require(all(p.returncode == 0 for p in procs) and len(finals) == 2
                and len({ln.split()[-1] for ln in finals}) == 1,
                f"cli_dist: {[log[-1500:] for log in logs]}")
    emit("dist", seconds=time.perf_counter() - t_dist, nvidia_smi=smi)


# ---------------------------------------------------------------------------
# fused_render_zvals: K3 in its plain output form, differentiable in the weights

ZV_RAYS = 4096                # rays of the render_zvals phase, at S3 depths each
ZV_REPS = 5                   # timed calls of a forward + backward


def render_zvals_phase(dev, smi, paths, poses, focal, cfg_ref, fine, coarse):
    """``render_kernel.fused_render_zvals`` forward and backward at full width,
    ``ZV_RAYS`` rays x ``S3`` depths from a coarse pass + ``sample_pdf``:
    K3 forward; backward K5 for the reference network (its two kernels in
    passes of 65,536 samples), autograd of ``apply_nerf`` for bmild, which
    K5 does not compute; int8 weights (dequantized in K3) forward only, as
    in the JAX package; one depth per ray (K4 forward, K5 backward). The
    launches are counted over these calls alone. Held: sigma and rgb
    against K3's plain version (K1_TOL, the route's QUANT_TOL), the weight
    gradients against the plain backward (K5's plain version, or bf16
    autograd for bmild; K5_PLAIN_TOL) and against float32 autograd (under
    max(2 x bf16 autograd's, K5_MIN_TOL)), the rays' and depths' cotangents
    zero. Then one forward + backward timed beside bf16 autograd of
    ``apply_nerf`` at the same points, and profiled by kernel."""
    from nerf_tpu_torch.config import bmild_config
    from nerf_tpu_torch.models.nerf import apply_nerf, init_nerf_params
    from nerf_tpu_torch.ops import composite_kernel, render_kernel, train_kernel
    from nerf_tpu_torch.ops.mlp_kernel import pack_params
    from nerf_tpu_torch.ops.quant import quantize_model
    from nerf_tpu_torch.utils.monitor import sync
    from nerf_tpu_torch.utils.rendering import sample_pdf
    from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves

    t0 = time.perf_counter()
    rcfg = cfg_ref.render
    cfg_bm = bmild_config().model
    seeded_bm = init_nerf_params(torch.Generator().manual_seed(1), cfg_bm, dev)
    ro, rd = camera_rays(poses[2], focal, dev, ZV_RAYS, seed=16)
    g = torch.Generator(device=dev).manual_seed(16)
    n = ZV_RAYS * S3
    nets = {}
    for vname, mcfg, p_coarse, p_fine in (("reference", cfg_ref.model, coarse, fine),
                                          ("bmild", cfg_bm, seeded_bm, seeded_bm)):
        z = hier_depths(render_kernel, composite_kernel, sample_pdf,
                        pack_params(p_coarse, mcfg, torch.bfloat16), ro, rd, mcfg, rcfg)
        ds = torch.randn(ZV_RAYS, S3, device=dev, generator=g) / n
        dr = torch.randn(ZV_RAYS, S3, 3, device=dev, generator=g) / n
        nets[vname] = (mcfg, p_fine, z, ds, dr)
    q8 = quantize_model({"fine": fine}, cfg_ref.model, bits=8, prune_fraction=0.1)[0]["fine"]

    def leaves_of(params):
        paths_, leaves = zip(*tree_leaves(params))
        leaves = [leaf.detach().clone().requires_grad_() for leaf in leaves]
        return paths_, leaves, tree_from_leaves(paths_, leaves)

    def points(z):
        pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
        return pts, rd.repeat_interleave(z.shape[1], dim=0)

    def autograd_grads(params, mcfg, z, ds, dr, dtype):
        paths_, leaves, tree = leaves_of(params)
        pts, dirs = points(z)
        out = apply_nerf(tree, pts, dirs, mcfg, compute_dtype=dtype)
        return dict(zip(paths_, torch.autograd.grad(out, leaves, (ds.reshape(-1),
                                                                  dr.reshape(-1, 3)))))

    def fwd_bwd(params, mcfg, z, ds, dr, rays_grad=False):
        paths_, leaves, tree = leaves_of(params)
        o, d, zz = ((t.detach().clone().requires_grad_() for t in (ro, rd, z)) if rays_grad
                    else (ro, rd, z))
        sigma, rgb = render_kernel.fused_render_zvals(tree, o, d, zz, mcfg)
        inputs = leaves + ([o, d, zz] if rays_grad else [])
        grads = torch.autograd.grad((sigma, rgb), inputs, (ds, dr))
        return sigma, rgb, dict(zip(paths_, grads[:len(leaves)])), grads[len(leaves):]

    # -- the calls whose launches are counted
    reset_counts()
    runs = {v: fwd_bwd(params, mcfg, z, ds, dr, rays_grad=True)
            for v, (mcfg, params, z, ds, dr) in nets.items()}
    sigma_q, rgb_q = render_kernel.fused_render_zvals(q8, ro, rd, nets["reference"][2],
                                                      cfg_ref.model)
    mref, _, z_ref, ds_ref, dr_ref = nets["reference"]
    one = fwd_bwd(fine, mref, z_ref[:, :1], ds_ref[:, :1], dr_ref[:, :1])
    sync((runs, sigma_q, rgb_q, one))
    counts = paths["render_zvals"] = read_counts()
    passes = len(train_kernel.pass_bounds(n)) + 1
    expect = {"render_zvals": 3, "dequant": 1, "dequant_stream": 1, "mlp_forward": 1,
              "bwd_rows": passes, "wgrad": passes}
    require({k: v for k, v in counts.items() if v} == expect,
            f"render_zvals: launches {counts}, expected {expect}")

    # -- held against the plain versions and autograd
    res = {}
    for vname, (mcfg, params, z, ds, dr) in nets.items():
        sigma, rgb, grads, ray_grads = runs[vname]
        packed = pack_params(params, mcfg, torch.bfloat16)
        raw_k = torch.cat([sigma[..., None], rgb], -1).reshape(ZV_RAYS, 4 * S3)
        raw_p = render_kernel.fused_render_zvals_plain(packed, ro, rd, z, mcfg)
        rgb_err, sig_err, sig_scale = rgb_sigma_err(raw_k, raw_p)
        g_f32 = autograd_grads(params, mcfg, z, ds, dr, torch.float32)
        g_bf16 = autograd_grads(params, mcfg, z, ds, dr, torch.bfloat16)
        if vname == "reference":
            pts, dirs = points(z)
            g_plain = dict(tree_leaves(train_kernel.unpack_grads(train_kernel.packed_grads_plain(
                packed, pts, dirs, ds.reshape(-1), dr.reshape(-1, 3), mcfg), mcfg)))
            del pts, dirs
        else:
            g_plain = g_bf16
        vs_plain, _ = worst_rel(grads, g_plain)
        noise, per_leaf = worst_rel(grads, g_f32)
        bf16_noise, _ = worst_rel(g_bf16, g_f32)
        limit = max(2.0 * bf16_noise, K5_MIN_TOL)
        rays_zero = all(bool((t == 0).all()) for t in ray_grads)
        res[vname] = dict(rays=ZV_RAYS, samples=S3, rgb_max_abs_err=rgb_err,
                          sigma_max_rel_err=sig_err, max_abs_sigma=sig_scale, tol=K1_TOL,
                          backward="K5 (bwd_rows + wgrad)" if vname == "reference"
                          else "autograd of apply_nerf, bf16 (K5 computes the reference variant)",
                          worst_leaf_vs_plain_backward=vs_plain, plain_tol=K5_PLAIN_TOL,
                          worst_leaf_vs_f32_autograd=noise, rel_err_vs_f32_by_leaf=per_leaf,
                          bf16_autograd_worst_leaf_vs_f32=bf16_noise, limit=limit,
                          ray_and_depth_cotangents_zero=rays_zero)
        require(bool(torch.isfinite(raw_k).all()) and all(
            bool(torch.isfinite(v).all()) for v in grads.values()),
                f"render_zvals {vname}: non-finite output or gradient")
        require(rgb_err <= K1_TOL and sig_err <= K1_TOL,
                f"render_zvals {vname}: rgb err {rgb_err}, sigma rel err {sig_err} > {K1_TOL}")
        require(vs_plain <= K5_PLAIN_TOL,
                f"render_zvals {vname}: gradient {vs_plain} from the plain backward")
        require(noise < limit, f"render_zvals {vname}: gradient {noise} from float32 autograd, "
                               f"bf16 autograd's {bf16_noise}")
        require(rays_zero, f"render_zvals {vname}: a ray or depth cotangent is not zero")
        del g_f32, g_bf16, g_plain, raw_p
        torch.cuda.empty_cache()
    raw_q = torch.cat([sigma_q[..., None], rgb_q], -1).reshape(ZV_RAYS, 4 * S3)
    e_q = rgb_sigma_err(raw_q, render_kernel.fused_render_zvals_plain(q8, ro, rd, z_ref, mref))[:2]
    res["int8"] = dict(rgb_max_abs_err=e_q[0], sigma_max_rel_err=e_q[1], tol=QUANT_TOL,
                       forward_only=not (sigma_q.requires_grad or rgb_q.requires_grad))
    require(max(e_q) <= QUANT_TOL and res["int8"]["forward_only"],
            f"render_zvals int8: errors {e_q} > {QUANT_TOL}, or a gradient on int8 weights")
    sigma1, rgb1, grads1, _ = one
    raw1 = torch.cat([sigma1[..., None], rgb1], -1).reshape(ZV_RAYS, 4)
    pk = pack_params(fine, mref, torch.bfloat16)
    e1 = rgb_sigma_err(raw1, render_kernel.fused_render_zvals_plain(pk, ro, rd, z_ref[:, :1],
                                                                    mref))[:2]
    pts1, dirs1 = points(z_ref[:, :1])
    g1_plain = dict(tree_leaves(train_kernel.unpack_grads(train_kernel.packed_grads_plain(
        pk, pts1, dirs1, ds_ref[:, :1].reshape(-1), dr_ref[:, :1].reshape(-1, 3), mref), mref)))
    e1_grad, _ = worst_rel(grads1, g1_plain)
    res["one_depth"] = dict(rays=ZV_RAYS, samples=1, rgb_max_abs_err=e1[0],
                            sigma_max_rel_err=e1[1], tol=K1_TOL,
                            worst_leaf_vs_plain_backward=e1_grad, plain_tol=K5_PLAIN_TOL)
    require(max(e1) <= K1_TOL and e1_grad <= K5_PLAIN_TOL,
            f"render_zvals at one depth per ray: errors {e1}, gradient {e1_grad}")

    # -- one forward + backward, timed beside bf16 autograd of apply_nerf at
    #    the same points (the JAX backward's recompute, and a forward), and
    #    profiled by kernel
    for vname, (mcfg, params, z, ds, dr) in nets.items():
        _, leaves, tree = leaves_of(params)
        pk = pack_params(params, mcfg, torch.bfloat16)
        fused = lambda: torch.autograd.grad(render_kernel.fused_render_zvals(
            tree, ro, rd, z, mcfg), leaves, (ds, dr))

        def plain():
            pts, dirs = points(z)
            out = apply_nerf(tree, pts, dirs, mcfg, compute_dtype=torch.bfloat16)
            return torch.autograd.grad(out, leaves, (ds.reshape(-1), dr.reshape(-1, 3)))

        def forward():
            with torch.no_grad():
                return render_kernel.fused_render_zvals(tree, ro, rd, z, mcfg)

        turns = [call_ms(plain, ZV_REPS), call_ms(fused, ZV_REPS), call_ms(fused, ZV_REPS),
                 call_ms(plain, ZV_REPS)]
        _, us, launched = profile_frame(lambda: sync(fused()))
        macs = mlp_macs(mcfg), mlp_macs(mcfg, with_dgrad_only=True)
        bound = bound_ms(2 * (2 * macs[0] + macs[1]) * n, 0,
                         nbytes(ro, rd, z, ds, dr, *pk) + 16 * n
                         + 4 * sum(leaf.numel() for leaf in leaves))
        kernels_us = {k: us[k] for k in (WGMMA["render_zvals"], *K5_KERNELS) if k in us}
        res[vname].update(
            fwd_bwd_ms=(turns[1] + turns[2]) / 2, plain_autograd_fwd_bwd_ms=(turns[0] + turns[3]) / 2,
            call_ms_turns_plain_fused_fused_plain=turns,
            forward_ms=call_ms(forward, ZV_REPS), bound_ms=bound[0], bound_by=bound[1],
            device_busy_ms=sum(us.values()) / 1e3, device_kernels=sum(launched.values()),
            device_ms_by_kernel={k: v / 1e3 for k, v in kernels_us.items()})
        del tree, leaves
        torch.cuda.empty_cache()
    emit("render_zvals", launches={k: v for k, v in counts.items() if v}, **res,
         timing="call ms by CUDA events over ZV_REPS calls, in turns (plain, fused, fused, "
                "plain); plain: bf16 autograd of apply_nerf at the materialized points",
         seconds=time.perf_counter() - t0, nvidia_smi=smi)
    return res


# -- the real-data path and the convergence run (cli_decode, cli_blender,
#    convergence) ------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
DECODE_SETS = ((10, 200), (100, 800))    # (PNGs, side): a small set, and lego's 800 x 800
BLENDER_VIEWS = (40, 8)                  # train, val: the convergence run's scene
BLENDER_SIDE = 400
EVAL_CHUNK = 4096                        # rays per chunk of NeRFTrainer.render_image
CONVERGENCE_IMG = 400                    # the recipe's (tools/convergence_run.recipe)
CONVERGENCE_STEPS = 2000
CONVERGENCE_DB = 20.0                    # val PSNR at step 2,000 (the JAX run: 20.6 at 1,000)
CONVERGENCE_DROP = 0.5                   # last tenth's mean loss <= this x the first tenth's
COMMITTED_RUN = os.path.join(ROOT, "results", "convergence_torch", "trajectory.json")


def rgba_png(rgba, interlace=False, level=6):
    """An RGBA8 ``[H, W, 4]`` uint8 image as PNG bytes, written here with
    ``zlib``: row i of the image stream under filter type i % 5 (None, Sub,
    Up, Average, Paeth), Adam7 where ``interlace``."""
    h, w, _ = rgba.shape
    parts, row = [], 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = rgba[y0::dy, x0::dx]
        if sub.size == 0:
            continue                                     # an empty pass has no rows
        raw = sub.reshape(sub.shape[0], -1).astype(np.int32)
        n = raw.shape[1]
        prev = np.vstack([np.zeros((1, n), np.int32), raw[:-1]])
        types = (np.arange(raw.shape[0]) + row) % 5
        rows = np.empty((raw.shape[0], 1 + n), np.uint8)
        rows[:, 0] = types
        for t in range(5):                               # each filter on its own rows
            x, b = raw[types == t], prev[types == t]
            a = np.pad(x, ((0, 0), (4, 0)))[:, :n]
            c = np.pad(b, ((0, 0), (4, 0)))[:, :n]
            if t == 4:
                p = a + b - c
                pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            else:
                pred = (0, a, b, (a + b) // 2)[t]
            rows[types == t, 1:] = (x - pred) & 0xFF
        parts.append(rows.tobytes())
        row += raw.shape[0]

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I",
                                                                        zlib.crc32(kind + data))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(b"".join(parts), level)) + chunk(b"IEND", b""))


def composite(rgba):
    """The float32 white-background composite ``rgb a + (1 - a)`` of RGBA8
    bytes, as the decoder computes it at the PNG's own size."""
    f = rgba.astype(np.float32) / np.float32(255)
    return f[..., :3] * f[..., 3:] + (np.float32(1) - f[..., 3:])


def probe_machine():
    """What the machine offers the host runtime: Pillow, matplotlib,
    pandas, psutil; the libpng and zlib headers; the shared libraries
    ``ldconfig`` knows; g++."""
    import importlib.util

    ld = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True)
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    return {
        "modules": {m: importlib.util.find_spec(m) is not None
                    for m in ("PIL", "matplotlib", "pandas", "psutil")},
        "headers": {h: os.path.exists(h) for h in ("/usr/include/png.h", "/usr/include/zlib.h")},
        "ldconfig_libpng_libz": [ln.strip() for ln in ld.stdout.splitlines()
                                 if "libpng" in ln or "libz." in ln],
        "gxx": gxx.stdout.splitlines()[0] if gxx.returncode == 0 else None,
        "cpu_count": os.cpu_count(), "cpus_usable": len(os.sched_getaffinity(0)),
    }


def decode_phase(smi, workdir):
    """cli_decode: the port's PNG decoder (``runtime/png.cpp``, built here
    with g++, no library) on RGBA PNGs this script writes: each set bit-equal
    to the numpy composite, and its rate on one thread and on all of them.
    Host work on the card's machine: no kernel runs."""
    from nerf_tpu_torch import runtime

    t_phase = time.perf_counter()
    emit("probe", **probe_machine())
    # built here from its source: a library some other machine built into
    # a copied build/ is removed first
    so = runtime.library_path("nerf_png")
    prebuilt = so.exists()
    so.unlink(missing_ok=True)
    t0 = time.perf_counter()
    runtime.load_png_library()
    build_s = time.perf_counter() - t0
    require(so.exists(), f"cli_decode: {so} was not built here")
    rng = np.random.default_rng(17)
    sets = {}
    for n, side in DECODE_SETS:
        d = os.path.join(workdir, f"decode_{side}")
        os.makedirs(d, exist_ok=True)
        base = (np.indices((side, side)).sum(0) * 255 // (2 * side)).astype(np.uint8)[..., None]
        tint = np.asarray([0, 60, 120], np.uint8)
        paths, want, file_bytes = [], [], 0
        t0 = time.perf_counter()
        for i in range(n):
            rgba = np.empty((side, side, 4), np.uint8)
            rgba[..., :3] = np.roll(base, 7 * i, axis=1) + tint   # wraps: uint8
            rgba[..., 3] = rng.integers(0, 256, (side, side), dtype=np.uint8)
            data = rgba_png(rgba, interlace=i == 0, level=1 if side > 200 else 6)
            path = os.path.join(d, f"r_{i}.png")
            with open(path, "wb") as f:
                f.write(data)
            paths.append(path)
            want.append(composite(rgba))
            file_bytes += len(data)
        write_s = time.perf_counter() - t0
        runs = {}
        for label, threads in (("1_thread", 1), ("all_threads", 0)):
            t0 = time.perf_counter()
            got = runtime.decode_png_batch(paths, (side, side), n_threads=threads)
            secs = time.perf_counter() - t0
            require(np.array_equal(got, np.stack(want)),
                    f"cli_decode: {n} PNGs at {side}x{side} on {label} differ from the composite")
            runs[label] = {"seconds": secs, "images_per_s": n / secs,
                           "file_mb_per_s": file_bytes / secs / 1e6,
                           "rgba_mb_per_s": n * side * side * 4 / secs / 1e6}
        sets[f"{n}x{side}x{side}"] = {"file_mb": file_bytes / 1e6, "write_s": write_s,
                                      "interlaced": 1, "bit_equal_composite": True, **runs}
        del want
    emit("cli_decode", decoder="nerf_tpu_torch/runtime/png.cpp (g++, links nothing)",
         library=so.name, build_s=build_s, prebuilt_removed=prebuilt, sets=sets,
         cpu_count=os.cpu_count(), cpus_usable=len(os.sched_getaffinity(0)),
         filters="row i under type i % 5; file 0 of each set Adam7",
         what="host work on the card's machine (no kernel)",
         seconds=time.perf_counter() - t_phase, nvidia_smi=smi)


def blender_phase(smi, paths, run_cli, workdir, expect):
    """cli_blender: the procedural views written as a Blender directory of
    RGBA PNGs, trained through ``train --data_dir`` at the PNGs' own size:
    the native decoder reads it with Pillow unimportable, the loaded images
    equal the numpy composite, the exact launches of the train loop's eager
    first chunk (``expect``), the loss falls, ``final_model.npz`` is
    written."""
    from nerf_tpu_torch import runtime
    from nerf_tpu_torch.data import blender
    from nerf_tpu_torch.data.synthetic import make_procedural_dataset
    from nerf_tpu_torch.train.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "blender_scene")
    rng = np.random.default_rng(23)
    want, file_bytes = {}, 0
    for split, n, seed in (("train", BLENDER_VIEWS[0], 0), ("val", BLENDER_VIEWS[1], 123)):
        ds = make_procedural_dataset(n, (BLENDER_SIDE, BLENDER_SIDE), seed=seed, split=split)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames, images = [], []
        for i in range(n):
            rgba = np.empty((BLENDER_SIDE, BLENDER_SIDE, 4), np.uint8)
            rgba[..., :3] = np.round(ds.images[i] * 255).astype(np.uint8)
            background = (ds.images[i] == 1.0).all(-1)
            # the background transparent over random colours, the sphere
            # opaque, a tenth of the pixels at a random alpha
            rgba[background, :3] = rng.integers(0, 256, (int(background.sum()), 3))
            rgba[..., 3] = np.where(background, 0, 255)
            partial = rng.random(background.shape) < 0.1
            rgba[partial, 3] = rng.integers(1, 255, int(partial.sum()))
            data = rgba_png(rgba, interlace=i == 0)
            with open(os.path.join(root, split, f"r_{i}.png"), "wb") as f:
                f.write(data)
            file_bytes += len(data)
            images.append(composite(rgba))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": ds.poses[i].tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
        want[split] = np.stack(images)

    # the loader runs with Pillow unimportable (sys.modules[...] = None), and
    # every decode it makes through the native decoder is recorded
    decoded, loaded = [], []
    decode, load_split = runtime.decode_png_batch, blender.load_blender_split

    def counted_decode(png_paths, img_wh, *a, **k):
        decoded.append(len(png_paths))
        return decode(png_paths, img_wh, *a, **k)

    def load_without_pil(*a, **k):
        saved = {m: sys.modules.get(m, False) for m in ("PIL", "PIL.Image")}
        sys.modules.update({m: None for m in saved})
        try:
            ds = load_split(*a, **k)
        finally:
            for m, mod in saved.items():
                if mod is False:
                    sys.modules.pop(m, None)
                else:
                    sys.modules[m] = mod
        loaded.append((ds.split, ds.images))
        return ds

    ckpt = os.path.join(workdir, "blender_ckpt")
    runtime.decode_png_batch, blender.load_blender_split = counted_decode, load_without_pil
    try:
        lines, secs = run_cli("cli_blender", [
            "train", "--device", "cuda", "--data_dir", root, "--image_size", str(BLENDER_SIDE),
            "--epochs", "2", "--no_resume", "--checkpoint_dir", ckpt, "--output_dir", ckpt],
            expect)
    finally:
        runtime.decode_png_batch, blender.load_blender_split = decode, load_split
    final_npz = os.path.join(ckpt, "final_model.npz")
    require(os.path.exists(final_npz), f"cli_blender: no {final_npz}")
    state, meta = restore_checkpoint(final_npz)
    losses = meta["train_losses"]
    emit("cli_blender", argv=f"train --data_dir (RGBA PNGs) --image_size {BLENDER_SIDE} "
         "--epochs 2 --no_resume", views=list(BLENDER_VIEWS), png_mb=file_bytes / 1e6,
         native_decodes=decoded, splits_loaded_without_pil=[s for s, _ in loaded],
         launches=paths["cli_blender"], expected=expect, epoch_losses=losses,
         step=state["step"], stdout_tail=lines[-4:], seconds=secs,
         phase_seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    require(decoded == list(BLENDER_VIEWS) and [split for split, _ in loaded] == ["train", "val"],
            f"cli_blender: the native decoder read {decoded} PNGs for "
            f"{[split for split, _ in loaded]}")
    require(all(np.array_equal(images, want[split]) for split, images in loaded),
            "cli_blender: the loaded images differ from the numpy composite")
    require(not any("procedural" in ln for ln in lines), "cli_blender: no Blender directory read")
    require(state["step"] == 2 * BLENDER_VIEWS[0] and len(losses) == 2
            and all(np.isfinite(losses)), f"cli_blender: step {state['step']}, losses {losses}")
    require(losses[1] < losses[0], f"cli_blender: the loss did not fall: {losses}")


def convergence_phase(smi, paths, workdir, train_chunk):
    """convergence: ``tools/convergence_run.run(steps=2000)`` at the recipe:
    val PSNR at step 2,000, the last tenth's loss against the first tenth's,
    its validations against the committed run's, its files and their keys,
    the exact launches of the eager first chunk of its train loop and of its
    validations' K4 (every other kernel 0)."""
    from nerf_tpu_torch import runtime
    from nerf_tpu_torch.tools import convergence_run

    out = os.path.join(workdir, "convergence")
    views = 40
    val_steps = convergence_run.validation_steps(CONVERGENCE_STEPS, views, 500)
    val_views = 5                                       # TrainConfig.max_val_images
    per_view = 2 * math.ceil(CONVERGENCE_IMG ** 2 / EVAL_CHUNK)   # coarse + fine K4 a chunk
    # the validations' views, then the final render of one held-out view
    views_rendered = len(val_steps) * val_views + 1
    expect = {"mlp_forward": 2 * train_chunk + views_rendered * per_view,
              "bwd_rows": K5_PASSES * train_chunk, "wgrad": K5_PASSES * train_chunk}
    lines = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = convergence_run.run(steps=CONVERGENCE_STEPS, out=out, log=lines.append)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = paths["convergence"] = read_counts()
    traj, losses = result["trajectory"], result["train_losses"]
    tenth = len(losses) // 10
    first, last = float(np.mean(losses[:tenth])), float(np.mean(losses[-tenth:]))
    with open(os.path.join(out, "trajectory.json")) as f:
        written = json.load(f)
    with np.load(os.path.join(out, "final_params.npz")) as a, np.load(PARAMS) as b:
        keys_equal = sorted(a.files) == sorted(b.files)
    # the schedule does not depend on the run's length, and the steps are
    # deterministic: these validations are the committed 24,000-step run's first
    with open(COMMITTED_RUN) as f:
        committed = json.load(f)["trajectory"][:len(val_steps)]
    pngs = runtime.decode_png_batch([os.path.join(out, f"{n}.png") for n in
                                     ("final_rgb", "ground_truth", "final_depth")],
                                    (CONVERGENCE_IMG, CONVERGENCE_IMG))
    emit("convergence", steps=CONVERGENCE_STEPS, trajectory=traj, timing=result["timing"],
         wall_time_s=result["wall_time_s"], loss_first_tenth=first, loss_last_tenth=last,
         launches=counts, expected=expect, views_rendered=views_rendered,
         params_keys_equal_jax_run=keys_equal, equals_committed_run=traj == committed,
         files=sorted(os.listdir(out)), psnr_min_db=CONVERGENCE_DB, seed=result["config"]["seed"],
         stdout=lines, seconds=secs, nvidia_smi=smi)
    for k in set(counts) | set(expect):
        require(counts.get(k, 0) == expect.get(k, 0),
                f"convergence: {k} launched {counts.get(k, 0)} times, expected {expect.get(k, 0)}")
    require([t["step"] for t in traj] == val_steps, f"convergence: validated at {traj}")
    require(traj == committed, f"convergence: {traj} differs from {COMMITTED_RUN}'s {committed}")
    require(traj[-1]["val_psnr_db"] >= CONVERGENCE_DB,
            f"convergence: {traj[-1]['val_psnr_db']} dB at step {CONVERGENCE_STEPS}")
    require(last <= CONVERGENCE_DROP * first, f"convergence: loss {first} -> {last}")
    require(set(written) >= {"config", "trajectory", "wall_time_s"}
            and written["config"]["seed"] == TRAIN_SEED and keys_equal,
            f"convergence: trajectory.json keys {list(written)}, params keys equal {keys_equal}")
    require(np.isfinite(pngs).all() and pngs[0].std() > 0.05,
            "convergence: the final render is degenerate")


MIP_KERNELS = ("ray_z_mip_wgmma_kernel", "ray_mip_wgmma_kernel")
MIP_ONLY = sys.argv[1:2] == ["--mip-only"]   # the build and mip_check alone
# digests of K5's scratch and partials from another commit (tools/k5_digest.py)
K5_REFERENCE = (sys.argv[sys.argv.index("--k5-reference") + 1]
                if "--k5-reference" in sys.argv[:-1] else None)
MIP_RAYS = 16384              # mip_check: one chunk of the engine
MIP_S = 128                   # the mip configuration's intervals a pass
MIP_SIDE = 800                # Blender's frames: 800 x 800
MIP_TOL = 1e-3                # the mip kernels' float32 raw vs their plain versions: rgb abs,
                              # density relative to max|density| (bf16 activations summed in
                              # another order: 9.8e-5 and 1.5e-4 read on seeded weights, whose
                              # density spans only 4% of its max, so a kernel that dropped
                              # the density product reads 3e-2)
MIP_TOL_BF16 = 2 ** -7        # their bfloat16 raw: the same, where the two may round a value
                              # to neighbouring bf16 numbers (one step: 2^-8 for rgb in
                              # [0.5, 1), 2^-9 for the density)
MIP_PSNR_MIN = 40.0           # the bf16 mip frame against the float32 torch engine


def mip_phase(dev, smi):
    """``mip_check``: the mip kernels (K1-mip ``ray_mip_wgmma_kernel``, K3-mip
    ``ray_z_mip_wgmma_kernel``) against their plain versions at 16,384 rays
    x 128 intervals on seeded weights (float32 and bf16 raw; K3-mip at the
    intervals ``mip_resample`` draws from K1-mip's K2 weights), K2's edges
    form against its plain version (1e-5; broadcast and per-ray edges,
    float32 and bf16 raw, with and without weights, 1, 1,001 and 16,384 rays),
    then ``mip_frame``: ``CudaEngine`` on the mip configuration in the
    hierarchical mode at 800 x 800, counting 40 + 40 mip launches and 80 of
    K2's edges form a frame and nothing else, and its PSNR against the
    float32 ``TorchEngine`` at 200 x 200."""
    import dataclasses

    from nerf_tpu_torch.config import mip_config
    from nerf_tpu_torch.models.nerf import init_nerf_params
    from nerf_tpu_torch.ops import composite_kernel, ray_wgmma, render_kernel
    from nerf_tpu_torch.ops.mlp_kernel import pack_params
    from nerf_tpu_torch.render.engines import CudaEngine, SharedModel, TorchEngine
    from nerf_tpu_torch.utils.cameras import focal_from_angle, pixel_radius, spherical_pose
    from nerf_tpu_torch.utils.rendering import mip_resample, uniform_edges

    cfg = mip_config()
    mcfg, rcfg = cfg.model, cfg.render
    g = torch.Generator().manual_seed(5)
    net = init_nerf_params(g, mcfg, dev)
    packed = pack_params(net, mcfg, torch.bfloat16)
    focal = focal_from_angle(MIP_SIDE, CAMERA_ANGLE_X)
    radius = pixel_radius(focal)
    pose = spherical_pose(40.0, -30.0, 4.0)
    lib = ray_wgmma.load()
    emit("mip_build", kernels=["ray_mip_wgmma_kernel", "ray_z_mip_wgmma_kernel"],
         dynamic_smem_bytes=lib.ray_mip_wgmma_smem_bytes(MIP_S),
         ring_stages=lib.ray_mip_wgmma_stages(MIP_S),
         stream_chunks=len(ray_wgmma.chunk_schedule(mcfg)))
    from nerf_tpu_torch.utils.cameras import generate_rays

    ro, rd = generate_rays(pose, MIP_SIDE, MIP_SIDE, focal, dev)
    idx = torch.randperm(MIP_SIDE * MIP_SIDE, generator=torch.Generator().manual_seed(2))
    idx = idx[:MIP_RAYS].to(dev)
    ro, rd = ro.reshape(-1, 3)[idx].contiguous(), rd.reshape(-1, 3)[idx].contiguous()
    edges_c = uniform_edges(rcfg.near, rcfg.far, MIP_S + 1, dev).expand(MIP_RAYS, -1)
    errs = {}
    for raw_dtype in (torch.float32, torch.bfloat16):
        tol = MIP_TOL if raw_dtype == torch.float32 else MIP_TOL_BF16
        n1 = render_kernel.launches["render_mip"]
        raw_k = render_kernel.fused_render_mip_raw(packed, ro, rd, radius, rcfg.near, rcfg.far,
                                                   MIP_S, mcfg, raw_dtype=raw_dtype)
        require(render_kernel.launches["render_mip"] == n1 + 1,
                "K1-mip did not reach csrc/ray_wgmma.cu")
        raw_p = render_kernel.fused_render_mip_plain(packed, ro, rd, radius, rcfg.near,
                                                     rcfg.far, MIP_S, mcfg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(raw_k.float()).all()), "K1-mip: non-finite output")
        rgb_err, sig_err, sig_scale = rgb_sigma_err(raw_k.float(), raw_p.to(raw_dtype).float())
        name = f"k1_mip {str(raw_dtype)[6:]}"
        errs[name] = (rgb_err, sig_err)
        emit("mip_check", kernel="ray_mip_wgmma_kernel", raw=str(raw_dtype)[6:], rays=MIP_RAYS,
             intervals=MIP_S, rgb_max_abs_err=rgb_err, density_max_rel_err=sig_err,
             max_abs_density=sig_scale, tol=tol, **agreement(raw_k, raw_p.to(raw_dtype)))
        require(rgb_err <= tol and sig_err <= tol,
                f"K1-mip ({raw_dtype}): rgb err {rgb_err}, density rel err {sig_err} > {tol}")
    raw_c = render_kernel.fused_render_mip_raw(packed, ro, rd, radius, rcfg.near, rcfg.far,
                                               MIP_S, mcfg)
    out_c = composite_kernel.composite_edges(raw_c, edges_c, rd, rcfg, with_weights=True)
    edges_f = mip_resample(edges_c, out_c.weights, rcfg.resample_padding)
    require(bool(torch.isfinite(edges_f).all()) and bool((edges_f[:, 1:] >= edges_f[:, :-1]).all()),
            "mip_resample: fine edges not finite and sorted")
    for raw_dtype in (torch.float32, torch.bfloat16):
        tol = MIP_TOL if raw_dtype == torch.float32 else MIP_TOL_BF16
        n3 = render_kernel.launches["render_edges_mip"]
        raw_k = render_kernel.fused_render_edges_mip_raw(packed, ro, rd, radius, edges_f, mcfg,
                                                         raw_dtype=raw_dtype)
        require(render_kernel.launches["render_edges_mip"] == n3 + 1,
                "K3-mip did not reach csrc/ray_wgmma.cu")
        raw_p = render_kernel.fused_render_edges_mip_plain(packed, ro, rd, radius, edges_f, mcfg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(raw_k.float()).all()), "K3-mip: non-finite output")
        rgb_err, sig_err, sig_scale = rgb_sigma_err(raw_k.float(), raw_p.to(raw_dtype).float())
        errs[f"k3_mip {str(raw_dtype)[6:]}"] = (rgb_err, sig_err)
        emit("mip_check", kernel="ray_z_mip_wgmma_kernel", raw=str(raw_dtype)[6:],
             rays=MIP_RAYS, intervals=MIP_S, edges="K1-mip + K2 edges + mip_resample",
             rgb_max_abs_err=rgb_err, density_max_rel_err=sig_err, max_abs_density=sig_scale,
             tol=tol, **agreement(raw_k, raw_p.to(raw_dtype)))
        require(rgb_err <= tol and sig_err <= tol,
                f"K3-mip ({raw_dtype}): rgb err {rgb_err}, density rel err {sig_err} > {tol}")
    # K2's edges form against its plain version, on K3-mip's raw
    raw_f = render_kernel.fused_render_edges_mip_raw(packed, ro, rd, radius, edges_f, mcfg)
    for n in (1, 1001, MIP_RAYS):
        for raw_dtype in (torch.float32, torch.bfloat16):
            for name, e in (("broadcast", edges_c), ("per ray", edges_f)):
                raw = raw_f[:n].to(raw_dtype).contiguous()
                ne = composite_kernel.edges_launches
                out_k, w_k = composite_kernel._launch_edges(raw, e[:n], rd[:n], True)
                out_n, w_n = composite_kernel._launch_edges(raw, e[:n], rd[:n], False)
                require(composite_kernel.edges_launches == ne + 2,
                        "K2's edges form did not reach csrc/composite.cu")
                out_p, w_p = composite_kernel.composite_edges_plain(raw, e[:n], rd[:n])
                torch.cuda.synchronize()
                e_rgb, e_depth, e_w = composited_err(out_k, w_k, out_p, w_p)
                emit("mip_check", kernel=composite_kernel.EDGES_KERNEL, rays=n, intervals=MIP_S,
                     raw=str(raw_dtype)[6:], edges=name, rgb_acc_max_abs_err=e_rgb,
                     depth_max_rel_err=e_depth, w_max_abs_err=e_w, tol=K2_TOL,
                     weightless_equal=bool(torch.equal(out_k, out_n)))
                require(max(e_rgb, e_depth, e_w) <= K2_TOL and torch.equal(out_k, out_n),
                        f"K2 edges ({n}, {raw_dtype}, {name}): errors {e_rgb}, {e_depth}, {e_w}")

    # mip_frame: the engine's hierarchical path, launches counted
    shared = SharedModel(cfg, device=dev)
    shared.params = {"coarse": net, "fine": net}
    engine = CudaEngine(shared, chunk_rays=MIP_RAYS)
    engine.render_image(pose, (MIP_SIDE, MIP_SIDE), SPP, focal=focal, mode="hierarchical",
                        monitor=True)
    reset_counts()
    frames = [engine.render_image(spherical_pose(40.0 + 30.0 * k, -30.0, 4.0),
                                  (MIP_SIDE, MIP_SIDE), SPP, focal=focal, mode="hierarchical",
                                  monitor=True) for k in range(2)]
    counts = read_counts()
    per_frame = -(-MIP_SIDE * MIP_SIDE // MIP_RAYS)
    expect = {"render_mip": per_frame, "render_edges_mip": per_frame,
              "composite_edges": 2 * per_frame}
    for k, n in counts.items():
        want = expect.get(k, 0) * len(frames)
        require(n == want, f"mip_frame: {k} launched {n} times, expected {want}")
    require(all(np.isfinite(f.rgb).all() and np.isfinite(f.depth).all() for f in frames),
            "mip_frame: non-finite frame")
    q = 200
    qfocal = focal_from_angle(q, CAMERA_ANGLE_X)
    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    shared32 = SharedModel(cfg32, device=dev)
    shared32.params = shared.params
    truth = TorchEngine(shared32).render_image(pose, (q, q), SPP, focal=qfocal,
                                               mode="hierarchical", monitor=False).rgb
    got = engine.render_image(pose, (q, q), SPP, focal=qfocal, mode="hierarchical",
                              monitor=False).rgb
    db = psnr(got, truth)
    wall = float(np.median([f.stats.wall_time_s for f in frames]))
    emit("mip_frame", resolution=[MIP_SIDE, MIP_SIDE], intervals=[MIP_S, MIP_S],
         ms_per_frame=wall * 1e3, rays_per_s=MIP_SIDE * MIP_SIDE / wall,
         peak_device_mb=max(f.stats.peak_device_mb for f in frames), launches=counts,
         expected_per_frame=expect, rgb_mean=float(frames[0].rgb.mean()),
         rgb_std=float(frames[0].rgb.std()), psnr_vs_torch_f32_db=db, min_db=MIP_PSNR_MIN,
         nvidia_smi=smi)
    require(db >= MIP_PSNR_MIN, f"mip_frame: {db} dB against the float32 torch engine")
    reset_counts()
    return errs


MIP360_ONLY = sys.argv[1:2] == ["--mip360-only"]   # the build and mip360_check alone
MIP360_KERNELS = ("ray_z_prop360_wgmma_kernel", "mip360_encode_kernel",
                  "mip360_dense_wgmma_kernel", "mip360_dir_kernel")
MIP360_RAYS = 16384           # mip360_check: one chunk of the engine
MIP360_SIDE = (1237, 822)     # the 360 outdoor scenes at the published factor 4
MIP360_ANGLE_X = 1.10
MIP360_TOL = 2e-2             # the new kernels against their plain versions on the card: rgb abs,
                              # density relative to max|density|; bf16 activations summed in
                              # another order through 8 layers of 1,024 flip roundings that the
                              # plain version keeps (8.0e-3 rgb and 9.6e-3 density read on the
                              # H100 at one chunk on seeded weights)
MIP360_PSNR_MIN = 30.0        # the bf16 frame against the float32 torch engine


def mip360_phase(dev, smi):
    """``mip360_check``: the Mip-NeRF 360 kernels against their plain versions
    on the card at one 16,384-ray chunk of the engine on seeded weights, at
    the edges each level draws from the level before: the proposal entry
    (``ray_z_prop360_wgmma_kernel``) at both proposal levels' 64 intervals,
    K2's opaque edges form (both entries through their wrappers, 1e-5), the NeRF pass (encoder,
    eight trunk layers, bottleneck and density, direction term, color) at
    32; each launch counted. Device ms of each kernel by the profiler at
    that chunk, beside its bound and, for the NeRF trunk's layers,
    ``torch.matmul`` on the same bf16 shapes (the library's time; the port
    never calls it). Then ``mip360_frame``: ``CudaEngine`` on
    ``mip360_config()`` at 1,237 x 822 in the hierarchical mode, counting
    every launch a frame, and its PSNR against the float32
    ``TorchEngine`` at 124 x 82."""
    import dataclasses

    from nerf_tpu_torch.config import mip360_config
    from nerf_tpu_torch.models.mip360 import N_PROP_LEVELS, init_mip360_params, resample_360
    from nerf_tpu_torch.ops import composite_kernel, mip360_kernel, ray_wgmma, render_kernel
    from nerf_tpu_torch.render.engines import CudaEngine, SharedModel, TorchEngine
    from nerf_tpu_torch.utils.cameras import (focal_from_angle, generate_rays, pixel_radius,
                                              spherical_pose)
    from nerf_tpu_torch.utils.rendering import first_level_360, s_to_t

    cfg = mip360_config()
    mcfg, rcfg = cfg.model, cfg.render
    params = init_mip360_params(torch.Generator().manual_seed(5), mcfg, dev)
    packed = mip360_kernel.pack_mip360(params, mcfg)
    w, h = MIP360_SIDE
    focal = focal_from_angle(w, MIP360_ANGLE_X)
    radius = pixel_radius(focal)
    pose = spherical_pose(40.0, -15.0, 1.0)
    lib = mip360_kernel.load()
    rlib = ray_wgmma.load()
    emit("mip360_build", kernels=list(MIP360_KERNELS),
         dense_smem_bytes=[lib.mip360_dense_smem(e) for e in range(3)],
         stages=lib.mip360_stages(), tile_rows=lib.mip360_tile_rows(),
         prop_smem_bytes=rlib.ray_mip_wgmma_smem_bytes(rcfg.n_coarse),
         prop_ring_stages=rlib.ray_mip_wgmma_stages(rcfg.n_coarse))
    require(lib.mip360_tile_rows() == mip360_kernel.TILE
            and lib.mip360_enc_chunks() * mip360_kernel.CHUNK_K == mip360_kernel.ENC_K,
            "the NeRF pass's layout differs from ops/mip360_kernel.py")
    ro, rd = generate_rays(pose, w, h, focal, dev)
    idx = torch.randperm(w * h, generator=torch.Generator().manual_seed(2))[:MIP360_RAYS].to(dev)
    ro, rd = ro.reshape(-1, 3)[idx].contiguous(), rd.reshape(-1, 3)[idx].contiguous()
    errs = {}
    prod, wts = 1, None
    for level in range(N_PROP_LEVELS):
        s = (first_level_360(rcfg.n_coarse, MIP360_RAYS, dev) if level == 0
             else resample_360(s, wts, rcfg.n_coarse, prod, rcfg))
        prod *= rcfg.n_coarse
        t = t_prop = s_to_t(s, rcfg.near, rcfg.far)
        n0 = render_kernel.launches["prop_mip360"]
        dens_k = render_kernel.fused_render_prop_mip360(packed["coarse"], ro, rd, radius, t, mcfg)
        require(render_kernel.launches["prop_mip360"] == n0 + 1,
                "the proposal entry did not reach csrc/ray_wgmma.cu")
        dens_p = render_kernel.fused_render_prop_mip360_plain(packed["coarse"], ro, rd, radius,
                                                              t, mcfg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(dens_k).all()), "the proposal entry: non-finite output")
        scale = dens_p.abs().max().item()
        err = (dens_k - dens_p).abs().max().item() / max(scale, 1e-6)
        errs[f"prop level {level}"] = err
        emit("mip360_check", kernel="ray_z_prop360_wgmma_kernel", level=level, rays=MIP360_RAYS,
             intervals=rcfg.n_coarse, density_max_rel_err=err, max_abs_density=scale,
             density_mean_abs_err=(dens_k - dens_p).abs().mean().item(),
             share_bit_equal=(dens_k == dens_p).float().mean().item(), tol=MIP360_TOL)
        require(err <= MIP360_TOL, f"the proposal entry (level {level}): density rel err {err}")
        ne = composite_kernel.edges360_launches
        wts = composite_kernel.composite_weights_360(dens_k, t, rd)
        require(composite_kernel.edges360_launches == ne + 1,
                "K2's opaque edges form did not reach csrc/composite.cu")
        w_p = composite_kernel.composite_weights_360_plain(dens_k, t, rd)
        e_w = (wts - w_p).abs().max().item()
        emit("mip360_check", kernel=composite_kernel.EDGES360_KERNEL, entry="weights", level=level,
             w_max_abs_err=e_w, tol=K2_TOL)
        require(e_w <= K2_TOL, f"K2's opaque edges form (weights): {e_w}")
    s = resample_360(s, wts, rcfg.n_fine, prod, rcfg)
    t = s_to_t(s, rcfg.near, rcfg.far)
    require(bool(torch.isfinite(t).all()) and bool((s[:, 1:] >= s[:, :-1]).all()),
            "resample_360: the NeRF level's edges not finite and sorted")
    before = dict(mip360_kernel.launches)
    raw_k = mip360_kernel.nerf_mip360_raw(packed["fine"], ro, rd, radius, t, mcfg)
    ran = {k: mip360_kernel.launches[k] - before[k] for k in before}
    require(ran == {"encode": 1, "dense": mcfg.n_layers, "bottleneck": 1, "dir": 1, "color": 1},
            f"the NeRF pass's launches: {ran}")
    raw_p = mip360_kernel.nerf_mip360_plain(packed["fine"], ro, rd, radius, t, mcfg)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(raw_k).all()), "the NeRF pass: non-finite output")
    rgb_err, sig_err, sig_scale = rgb_sigma_err(raw_k, raw_p)
    errs["nerf"] = (rgb_err, sig_err)
    emit("mip360_check", kernel="NeRF pass", rays=MIP360_RAYS, intervals=rcfg.n_fine,
         rgb_max_abs_err=rgb_err, density_max_rel_err=sig_err, max_abs_density=sig_scale,
         launches=ran, tol=MIP360_TOL, **agreement(raw_k, raw_p))
    require(rgb_err <= MIP360_TOL and sig_err <= MIP360_TOL,
            f"the NeRF pass: rgb err {rgb_err}, density rel err {sig_err} > {MIP360_TOL}")
    ne = composite_kernel.edges360_launches
    res_k = composite_kernel.composite_edges_360(raw_k, t, rd, rcfg)
    require(composite_kernel.edges360_launches == ne + 1,
            "K2's opaque edges form did not reach csrc/composite.cu")
    res_p = composite_kernel._outputs(composite_kernel.composite_edges_360_plain(raw_k, t, rd),
                                      None, rcfg)
    torch.cuda.synchronize()
    out_k, out_p = (torch.cat([r.rgb, r.depth[:, None], r.acc[:, None]], 1)
                    for r in (res_k, res_p))          # composited_err's columns
    e_rgb, e_depth, _ = composited_err(out_k, None, out_p, None)
    emit("mip360_check", kernel=composite_kernel.EDGES360_KERNEL, entry="raw",
         rgb_acc_max_abs_err=e_rgb, depth_max_rel_err=e_depth, tol=K2_TOL)
    require(max(e_rgb, e_depth) <= K2_TOL, f"K2's opaque edges form (raw): {e_rgb}, {e_depth}")

    # device ms of each kernel at the chunk, beside its bound; the trunk's
    # layers beside torch.matmul on the same bf16 shapes. A trace that does
    # not hold every launch (this machine's profiler drops records now and
    # then) gives way to CUDA events around the calls
    reps = 3

    def by_kernel(fn, expect):
        """``(ms a call, {kernel: (ms a call, launches)}, [(kernel, ms) of
        each launch in order], source)``: the profiler's device times when
        the trace holds ``expect[k]`` launches of each kernel ``k`` a call,
        else CUDA events' time a call and no breakdown."""
        def run():
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        cuda = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        order = [(n, us * 1e-3) for n, us in
                 device_events(types.SimpleNamespace(events=lambda: cuda))
                 if not n.startswith("kernel.")]          # the spans' mirrors
        out = {}
        for n, ms in order:
            t, k = out.get(n, (0.0, 0))
            out[n] = (t + ms / reps, k + 1)
        if all(out.get(k, (0, 0))[1] == reps * c for k, c in expect.items()):
            return sum(t for t, _ in out.values()), out, order, "profiler"
        emit("profiler_note", kernels=expect, reps=reps, traced={k: v[1] for k, v in out.items()},
             note="the trace does not hold every launch; timed by CUDA events instead")
        return call_ms(fn, reps), None, [], "events"

    rows = MIP360_RAYS * rcfg.n_fine
    nerf_flops = 2.0 * rows * (mcfg.pos_dim * mcfg.hidden_dim
                               + (mcfg.n_layers - 2) * mcfg.hidden_dim ** 2
                               + (mcfg.hidden_dim + mcfg.pos_dim) * mcfg.hidden_dim
                               + mcfg.hidden_dim * (1 + mcfg.bottleneck_dim)
                               + mcfg.bottleneck_dim * mcfg.color_hidden_dim
                               + mcfg.color_hidden_dim * 3)
    prop_rows = MIP360_RAYS * rcfg.n_coarse
    prop_flops = 2.0 * prop_rows * (mcfg.pos_dim * 256 + 3 * 256 * 256 + 256)
    nerf_ms, nerf_t, order, nerf_from = by_kernel(
        lambda: mip360_kernel.nerf_mip360_raw(packed["fine"], ro, rd, radius, t, mcfg),
        {"mip360_encode_kernel": 1, "mip360_dense_wgmma_kernel": mcfg.n_layers + 2,
         "mip360_dir_kernel": 1})
    layers_ms = [ms for n, ms in order if n == "mip360_dense_wgmma_kernel"][:mcfg.n_layers + 2]
    prop_ms, prop_t, _, prop_from = by_kernel(lambda: render_kernel.fused_render_prop_mip360(
        packed["coarse"], ro, rd, radius, t_prop, mcfg), {"ray_z_prop360_wgmma_kernel": 1})
    a = torch.randn(rows, mcfg.hidden_dim, device=dev).to(torch.bfloat16)
    wm = torch.randn(mcfg.hidden_dim, mcfg.hidden_dim, device=dev).to(torch.bfloat16)
    lib_ms, lib_t, _, lib_from = by_kernel(lambda: torch.matmul(a, wm), {})
    if not lib_t or len(lib_t) != 1 or next(iter(lib_t.values()))[1] != reps:
        lib_ms, lib_from = call_ms(lambda: torch.matmul(a, wm), reps), "events"
    layer_flops = 2.0 * rows * mcfg.hidden_dim ** 2
    emit("mip360_times", chunk_rays=MIP360_RAYS, device_ms=nerf_t, prop_device_ms=prop_t,
         nerf_pass_ms=nerf_ms, nerf_from=nerf_from, nerf_bound_ms=nerf_flops / 989e12 * 1e3,
         nerf_roofline_pct=100 * nerf_flops / 989e12 / (nerf_ms * 1e-3),
         prop_ms=prop_ms, prop_from=prop_from, prop_bound_ms=prop_flops / 989e12 * 1e3,
         prop_roofline_pct=100 * prop_flops / 989e12 / (prop_ms * 1e-3),
         dense_ms_by_launch=dict(zip(["layer0", *[f"layer{i}" for i in range(1, 8)],
                                      "bottleneck", "color"], layers_ms)),
         trunk_layer_library_ms=lib_ms, library_from=lib_from,
         trunk_layer_bound_ms=layer_flops / 989e12 * 1e3, nvidia_smi=smi)
    del a, wm, raw_p

    # mip360_frame: the engine's path, launches counted
    shared = SharedModel(cfg, device=dev)
    shared.params = params
    engine = CudaEngine(shared, chunk_rays=MIP360_RAYS)
    engine.render_image(pose, (w, h), SPP, focal=focal, mode="hierarchical", monitor=True)
    reset_counts()
    frames = [engine.render_image(spherical_pose(40.0 + 60.0 * k, -15.0, 1.0), (w, h), SPP,
                                  focal=focal, mode="hierarchical", monitor=True)
              for k in range(2)]
    counts = read_counts()
    chunks = -(-w * h // MIP360_RAYS)
    expect = {"prop_mip360": N_PROP_LEVELS * chunks, "nerf_mip360": chunks,
              "composite_edges_360": (N_PROP_LEVELS + 1) * chunks,
              "mip360_encode": chunks, "mip360_dense": mcfg.n_layers * chunks,
              "mip360_bottleneck": chunks, "mip360_dir": chunks, "mip360_color": chunks}
    for k, n in counts.items():
        want = expect.get(k, 0) * len(frames)
        require(n == want, f"mip360_frame: {k} launched {n} times, expected {want}")
    require(all(np.isfinite(f.rgb).all() and np.isfinite(f.depth).all() for f in frames),
            "mip360_frame: non-finite frame")
    qw, qh = 124, 82
    qfocal = focal_from_angle(qw, MIP360_ANGLE_X)
    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    shared32 = SharedModel(cfg32, device=dev)
    shared32.params = params
    truth = TorchEngine(shared32, chunk_rays=2048).render_image(
        pose, (qw, qh), SPP, focal=qfocal, mode="hierarchical", monitor=False).rgb
    got = engine.render_image(pose, (qw, qh), SPP, focal=qfocal, mode="hierarchical",
                              monitor=False).rgb
    db = psnr(got, truth)
    wall = float(np.median([f.stats.wall_time_s for f in frames]))
    emit("mip360_frame", resolution=[w, h], intervals=[rcfg.n_coarse] * N_PROP_LEVELS
         + [rcfg.n_fine], ms_per_frame=wall * 1e3, rays_per_s=w * h / wall,
         peak_device_mb=max(f.stats.peak_device_mb for f in frames), launches=counts,
         expected_per_frame=expect, rgb_mean=float(frames[0].rgb.mean()),
         rgb_std=float(frames[0].rgb.std()), psnr_vs_torch_f32_db=db, min_db=MIP360_PSNR_MIN,
         nvidia_smi=smi)
    require(db >= MIP360_PSNR_MIN, f"mip360_frame: {db} dB against the float32 torch engine")
    reset_counts()
    return errs


def reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    from nerf_tpu_torch.ops import (composite_kernel, dequant_stream, mip360_kernel, mlp_kernel,
                                    occupancy, quant, render_kernel, train_kernel)

    for k in render_kernel.launches:
        render_kernel.launches[k] = 0
    for k in quant.launches:
        quant.launches[k] = 0
    composite_kernel.launches = composite_kernel.planar_launches = 0
    composite_kernel.bf16_launches = composite_kernel.weightless_launches = 0
    composite_kernel.edges_launches = composite_kernel.edges360_launches = 0
    for k in mip360_kernel.launches:
        mip360_kernel.launches[k] = 0
    mlp_kernel.launches = 0
    dequant_stream.launches = 0
    occupancy.launches = 0
    for k in train_kernel.launches:
        train_kernel.launches[k] = 0


def read_counts():
    """Every kernel wrapper's launch count, by counter."""
    from nerf_tpu_torch.ops import (composite_kernel, dequant_stream, mip360_kernel, mlp_kernel,
                                    occupancy, quant, render_kernel, train_kernel)

    return {**render_kernel.launches, **quant.launches, "dequant_stream": dequant_stream.launches,
            "composite": composite_kernel.launches,
            "composite_bf16": composite_kernel.bf16_launches,
            "composite_planar": composite_kernel.planar_launches,
            "composite_edges": composite_kernel.edges_launches,
            "composite_edges_360": composite_kernel.edges360_launches,
            **{f"mip360_{k}": n for k, n in mip360_kernel.launches.items()},
            "mlp_forward": mlp_kernel.launches, "occupancy": occupancy.launches,
            **train_kernel.launches}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    from nerf_tpu_torch.config import default_config, bmild_config
    from nerf_tpu_torch.data.synthetic import make_procedural_dataset
    from nerf_tpu_torch.models.nerf import apply_nerf, init_nerf_params, params_from_numpy
    from nerf_tpu_torch.ops import (_ext, composite_kernel, dequant_stream, mlp_kernel, occupancy,
                                    quant, ray_wgmma, render_kernel, train_kernel)
    from nerf_tpu_torch.ops.mlp_kernel import pack_params
    from nerf_tpu_torch.ops.quant import prune_params, quantize_model
    from nerf_tpu_torch.bench.suite import UnifiedBenchmarkSuite, summarize
    from nerf_tpu_torch.render.engines import (ENGINE_CLASSES, AccelEngine, CompressedEngine,
                                               CudaEngine, Int8ComputeEngine, SharedModel,
                                               TorchEngine)
    from nerf_tpu_torch.render.pipeline import render_rays
    from nerf_tpu_torch.train.checkpoint import restore_bare_params, restore_checkpoint
    from nerf_tpu_torch.train.trainer import NeRFTrainer
    from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves
    from nerf_tpu_torch.utils.cameras import (BENCHMARK_FOCAL, focal_from_angle, generate_rays,
                                              orbit_poses, spherical_pose)
    from nerf_tpu_torch.utils.monitor import profile_trace
    from nerf_tpu_torch.utils.rendering import sample_pdf
    from nerf_tpu_torch.tools import composite_ab as k2_ab
    from nerf_tpu_torch.tools import k5_ab, k5_digest

    require(K2_KERNEL == composite_kernel.KERNEL,
            "K2's kernel name differs from ops/composite_kernel.py's")
    require(OCC_KERNEL == occupancy.KERNEL,
            "the depths kernel's name differs from ops/occupancy.py's")
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ---------------------------------------------------------------
    secs = _ext.build()
    ptxas = {n: [ln.strip() for ln in _ext.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln or "Function properties" in ln]
             for n in _ext.LIBRARIES}

    def kernel_ptxas(name, kernels):
        """ptxas's report of a library, per kernel: stack, spill bytes and
        registers at launch, and its notes on the wgmma pipeline (C7511 /
        C7512: products serialized; C7519: a warpgroup.arrive it inserted)."""
        log = _ext.build_log(name).splitlines()
        out, entry = {}, None
        for ln in log:
            if "Function properties for" in ln:
                entry = next((k for k in kernels if k in ln), None)
            elif entry and "spill" in ln:
                nums = [int(t) for t in ln.replace(",", " ").split() if t.isdigit()]
                out[entry] = dict(stack_bytes=nums[0], spill_store_bytes=nums[1],
                                  spill_load_bytes=nums[2])
            elif entry and "Used" in ln and "registers" in ln:
                out[entry]["registers_at_launch"] = int(ln.split("Used")[1].split()[0])
                entry = None
        notes = {"C7511_C7512_serialized": sum("C7511" in ln or "C7512" in ln for ln in log),
                 "C7519_arrive_inserted": sum("C7519" in ln for ln in log)}
        return out, notes

    # the Hopper ray kernels, each build of ray_wgmma.cu (the bf16 build
    # serves the bf16 and the dequantize routes): registers, stack and spills
    # per kernel, ptxas's notes on the wgmma pipeline, shared memory, ring
    # stages and landing slots
    wgmma_builds = {}
    for name in dict.fromkeys(ray_wgmma.LIBRARIES.values()):
        route = min(r for r, n in ray_wgmma.LIBRARIES.items() if n == name)
        kernels, notes = kernel_ptxas(name, ("ray_z_wgmma_kernel", "ray_wgmma_kernel",
                                             *WGMMA_COMPOSITED.values(), K4_KERNEL,
                                             "l2_probe_kernel"))
        lib = ray_wgmma.load(name)
        require(lib.ray_wgmma_route() == route, f"{name} is built for route "
                f"{lib.ray_wgmma_route()}, not {route}")
        wgmma_builds[name] = dict(
            route=route, ptxas=kernels, notes=notes,
            dynamic_smem_bytes={S: lib.ray_wgmma_smem_bytes(S) for S in (SPP, S3)},
            ring_stages={S: lib.ray_wgmma_stages(S) for S in (SPP, S3)},
            landing_slots=lib.ray_wgmma_landing_slots(),
            registers_after_setmaxnreg={"consumers": lib.ray_wgmma_registers(1),
                                        "producer_warpgroup": lib.ray_wgmma_registers(0)},
            composited_lanes={R: lib.ray_wgmma_composited_lanes(R) for R in (1, 1001, CHUNK)},
            per_sample={"kernel": K4_KERNEL, "ptxas": kernels.get(K4_KERNEL),
                        "dynamic_smem_bytes": lib.mlp_wgmma_smem_bytes(),
                        "ring_stages": lib.mlp_wgmma_stages(),
                        "stream_chunks": [lib.mlp_wgmma_stream_chunks(b) for b in (0, 1)]})
        require([lib.mlp_wgmma_stream_chunks(b) for b in (0, 1)] == [
            len(ray_wgmma.sample_chunk_schedule(c.model, route))
            for c in (default_config(), bmild_config())],
            f"{name}: the per-sample stream's chunks differ from ops/ray_wgmma.py")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        require(all(lib.ray_wgmma_composited_lanes(R) == 2 * ray_wgmma.composited_grid(R, n_sm)
                    for R in (0, 1, 2, 3, 263, 264, 265, 1001, CHUNK)),
                f"{name}: the composited modes' grid differs from ops/ray_wgmma.py")
    # the Hopper K5 (csrc/mlp_backward_wgmma.cu): its two kernels, and the
    # layout it shares with ops/train_kernel.py
    k5_lib = train_kernel.load()
    k5_ptxas, k5_notes = kernel_ptxas(train_kernel.LIBRARY, K5_KERNELS)
    k5_build = dict(
        ptxas=k5_ptxas, notes=k5_notes, row_pass_dynamic_smem_bytes=k5_lib.bwd_rows_smem_bytes(),
        row_pass_ring_stages=k5_lib.bwd_rows_stages(),
        row_pass_staging={"piece_bytes": k5_lib.bwd_rows_staging(0),
                          "slots_a_consumer": k5_lib.bwd_rows_staging(1)},
        row_pass_sass_stores=k5_ab.sass_stores(_ext.library_path(train_kernel.LIBRARY)),
        wgrad_dynamic_smem_bytes=k5_lib.wgrad_smem_bytes(),
        scratch_features=k5_lib.bwd_scratch_features(), stream_chunks=k5_lib.bwd_stream_chunks(),
        wgrad_jobs=len(train_kernel.wgrad_jobs(default_config().model)))
    dq_ptxas, _ = kernel_ptxas(dequant_stream.LIBRARY, (DEQUANT_KERNEL,))
    emit("build", seconds=secs, libraries=len(_ext.LIBRARIES), sources=list(_ext.SOURCES),
         variants={k: list(v) for k, v in _ext.VARIANTS.items()}, ptxas=ptxas,
         dequant_stream={"ptxas": dq_ptxas}, ray_wgmma=wgmma_builds, mlp_backward_wgmma=k5_build)
    for k in WGMMA.values():         # the bf16 route: no spill (the quantized builds: reported)
        r = wgmma_builds[ray_wgmma.LIBRARY]["ptxas"].get(k, {})
        require(r.get("spill_store_bytes") == 0 and r.get("spill_load_bytes") == 0,
                f"ptxas: {k} spills ({r})")
    for name, build in wgmma_builds.items():   # B9: no spill but on int8 compute
        route = build["route"]
        for k in WGMMA_COMPOSITED.values():
            r = wgmma_builds[name]["ptxas"].get(k, {})
            require(route == quant.ROUTE_INT8_COMPUTE or (r.get("spill_store_bytes") == 0
                                                          and r.get("spill_load_bytes") == 0),
                    f"ptxas: {k} in {name} spills ({r})")
    for name, build in wgmma_builds.items():   # K4 and K7's bf16 build: no spill
        r = build["ptxas"].get(K4_KERNEL, {})
        require(build["route"] == quant.ROUTE_INT8_COMPUTE or (r.get("spill_store_bytes") == 0
                                                               and r.get("spill_load_bytes") == 0),
                f"ptxas: {K4_KERNEL} in {name} spills ({r})")
    require(dequant_stream.load().dequant_stream_resident() == dequant_stream.RESIDENT_VALUES,
            "dequant_stream: the resident parameters differ from ops/dequant_stream.py")
    for k, r in dq_ptxas.items():
        require(r.get("spill_store_bytes") == 0 and r.get("spill_load_bytes") == 0,
                f"ptxas: {k} spills ({r})")
    for k in K5_KERNELS:
        r = k5_ptxas.get(k, {})
        require(r.get("spill_store_bytes") == 0 and r.get("spill_load_bytes") == 0,
                f"ptxas: {k} spills ({r})")
    require(k5_build["scratch_features"] == train_kernel.SCRATCH_FEATURES
            and k5_build["stream_chunks"] == len(ray_wgmma.bwd_chunk_schedule(default_config().model))
            and k5_lib.wgrad_job_ints() == train_kernel.jobs_tensor(default_config().model).shape[1],
            f"K5's layout differs between the kernels and ops/train_kernel.py ({k5_build})")
    # K5a's stores of the scratch: the staging the kernel reports is
    # ops/train_kernel.py's, and the scratch leaves by bulk copies alone
    require([k5_lib.bwd_rows_staging(i) for i in (0, 1)] == [train_kernel.STAGE_PIECE,
                                                          train_kernel.STAGE_DEPTH]
            and k5_lib.bwd_rows_stages() == train_kernel.ROW_STAGES
            and k5_lib.bwd_rows_smem_bytes() == train_kernel.ROWS_SMEM_BYTES,
            f"K5a's staging differs from ops/train_kernel.py ({k5_build})")
    sass = k5_build["row_pass_sass_stores"]
    require(sass["STG"] == 0 and sass["ST"] == 0 and sass["UBLKCP"] > 0,
            f"{K5_KERNELS[0]} stores the scratch other than by bulk copies ({sass})")

    # the mip kernels: no spill; then mip_check and mip_frame
    mip_ptxas, mip_notes = kernel_ptxas(ray_wgmma.LIBRARY, MIP_KERNELS)
    emit("mip_ptxas", ptxas=mip_ptxas, notes=mip_notes)
    for k in MIP_KERNELS:
        r = mip_ptxas.get(k, {})
        require(r.get("spill_store_bytes") == 0 and r.get("spill_load_bytes") == 0,
                f"ptxas: {k} spills ({r})")
    if MIP_ONLY:
        mip_phase(dev, smi)
        print(json.dumps({"mip_only": True, "device": torch.cuda.get_device_name(0)}), flush=True)
        return
    # the Mip-NeRF 360 kernels: no spill; mip360_check and mip360_frame run
    # last (--mip360-only: here)
    m360_ptxas, m360_notes = kernel_ptxas(ray_wgmma.LIBRARY, MIP360_KERNELS[:1])
    m360_ptxas.update(kernel_ptxas("mip360_wgmma", MIP360_KERNELS[1:])[0])
    emit("mip360_ptxas", ptxas=m360_ptxas, notes=m360_notes,
         notes_nerf_pass=kernel_ptxas("mip360_wgmma", MIP360_KERNELS[1:])[1])
    for k in MIP360_KERNELS:
        r = m360_ptxas.get(k, {})
        require(r.get("spill_store_bytes") == 0 and r.get("spill_load_bytes") == 0,
                f"ptxas: {k} spills ({r})")
    if MIP360_ONLY:
        mip360_phase(dev, smi)
        print(json.dumps({"mip360_only": True, "device": torch.cuda.get_device_name(0)}),
              flush=True)
        return
    mip_phase(dev, smi)

    # K2 (csrc/composite.cu): registers and spills of every body (none may
    # spill), and its schedule: the library's against ops/composite_kernel.py
    comp_lib = _ext.load("composite")
    comp_lib.composite_rays_grid.restype = ctypes.c_longlong
    comp_lib.composite_rays_grid.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
    k2_ptxas = composite_ptxas(_ext.build_log("composite"))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    k2_sched = {}
    for S in (*k2_ab.SAMPLE_COUNTS, K2_CHUNKED_S):
        P, k = composite_kernel.segment_lanes(S), composite_kernel.run_length(S)
        require(comp_lib.composite_rays_segment(S) == P and comp_lib.composite_rays_run(S) == k,
                f"K2 at S = {S}: the library's segment / run {comp_lib.composite_rays_segment(S)}"
                f" / {comp_lib.composite_rays_run(S)} differ from ops/composite_kernel.py's "
                f"{P} / {k}")
        for bf16 in (0, 1):
            for even in (0, 1) if k % 2 == 0 and S % 2 == 0 else (0,):
                bps = comp_lib.composite_rays_blocks_per_sm(S, bf16, even)
                grids = {n: comp_lib.composite_rays_grid(n, S, bf16, even)
                         for n in (*K2_RAYS, 2 * n_sm * 8 * 32 + 5)}
                require(bps >= 1 and all(g == composite_kernel.rays_grid(n, S, n_sm, bps)
                                         for n, g in grids.items()),
                        f"K2 at S = {S}, bf16 {bf16}, even {even}: the library's grid {grids} "
                        f"({bps} blocks an SM) differs from ops/composite_kernel.py's")
                k2_sched[f"S={S} {'bf16' if bf16 else 'f32'}{' even' if even else ''}"] = dict(
                    segment_lanes=P, rays_per_warp=32 // P, run=k, blocks_per_sm=bps,
                    grid=grids)
    require(comp_lib.composite_rays_max_run() == composite_kernel.MAX_RUN
            and comp_lib.composite_rays_threads() == composite_kernel.RAYS_THREADS,
            "K2's bodies differ from ops/composite_kernel.py's MAX_RUN / RAYS_THREADS")
    emit("k2_build", ptxas=k2_ptxas, schedule=k2_sched, sms=n_sm,
         schedule_equals_python=True)
    # the bodies of the paths' sample counts (runs up to 6: S <= 192) may not
    # spill; the others are reported
    path_bodies = {k: r for k, r in k2_ptxas.items()
                   if not k.startswith(f"{K2_KERNEL}<7")}
    require(all(r["spill_store_bytes"] == 0 and r["spill_load_bytes"] == 0
                for r in path_bodies.values())
            and sum(k.startswith(K2_KERNEL) for k in k2_ptxas) == K2_BODIES,
            f"ptxas: a body of csrc/composite.cu on a path spills, or one is missing "
            f"({k2_ptxas})")

    white = lambda c: dataclasses.replace(
        c, render=dataclasses.replace(c.render, white_background=True))
    f32 = lambda c: dataclasses.replace(
        c, train=dataclasses.replace(c.train, compute_dtype="float32"))
    cfg_ref = white(default_config())
    trained = restore_bare_params(PARAMS)
    fine = params_from_numpy(trained["fine"], dev)
    coarse = params_from_numpy(trained["coarse"], dev)
    focal = focal_from_angle(W, CAMERA_ANGLE_X)
    poses = [spherical_pose(30.0 + 17.0 * i, -30.0, 4.0) for i in range(4)]
    rcfg = cfg_ref.render

    def check_kernels():
        """K1, K3, their composited modes and K2 against their plain
        versions; returns the largest errors."""
        # -- K1 and K3: kernel vs plain, both variants ---------------------------
        # 1001 rays (3 of them padding): the last 128-row tile is partial, and at
        # 192 depths every other ray starts mid-tile
        k1_err, k3_err = {}, {}
        cfg_bm = bmild_config()
        g_bm = torch.Generator().manual_seed(1)
        variants = (
            ("reference", cfg_ref.model, coarse, fine),
            ("bmild", cfg_bm.model, init_nerf_params(g_bm, cfg_bm.model, dev),
             init_nerf_params(g_bm, cfg_bm.model, dev)),
        )
        n_check = 1001
        ro_chk, rd_chk = with_padding(*camera_rays(poses[0], focal, dev, n_check - 3, seed=0), 3)
        checked = {}
        for name, mcfg, p_coarse, p_fine in variants:
            packed_c = pack_params(p_coarse, mcfg, torch.bfloat16)
            packed_f = pack_params(p_fine, mcfg, torch.bfloat16)
            n_k1 = render_kernel.launches["render_samples"]
            raw_k, _ = render_kernel.fused_render_samples(packed_f, ro_chk, rd_chk, 2.0, 6.0, SPP,
                                                          mcfg, raw=True)
            require(render_kernel.launches["render_samples"] == n_k1 + 1,
                    "K1 on bf16 weights did not launch csrc/ray_wgmma.cu")
            raw_p = render_kernel.fused_render_samples_plain(packed_f, ro_chk, rd_chk, 2.0, 6.0,
                                                             SPP, mcfg)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(raw_k).all()), f"K1 {name}: non-finite output")
            rgb_err, sig_err, sig_scale = rgb_sigma_err(raw_k, raw_p)
            k1_err[name] = rgb_err
            emit("k1_check", variant=name, kernel=WGMMA["render_samples"], rays=n_check,
                 samples=SPP, rgb_max_abs_err=rgb_err, sigma_max_rel_err=sig_err,
                 max_abs_sigma=sig_scale, tol=K1_TOL, **agreement(raw_k, raw_p))
            require(rgb_err <= K1_TOL and sig_err <= K1_TOL,
                    f"K1 {name}: rgb err {rgb_err}, sigma rel err {sig_err} > {K1_TOL}")

            z_f = hier_depths(render_kernel, composite_kernel, sample_pdf, packed_c, ro_chk,
                              rd_chk, mcfg, rcfg)
            require(bool(torch.isfinite(z_f).all()) and bool((z_f[:, 1:] >= z_f[:, :-1]).all()),
                    f"K3 {name}: fine depths not finite and sorted")
            n_k3 = render_kernel.launches["render_zvals"]
            raw3_k = render_kernel.fused_render_zvals_raw(packed_f, ro_chk, rd_chk, z_f, mcfg)
            require(render_kernel.launches["render_zvals"] == n_k3 + 1,
                    "K3 on bf16 weights did not launch csrc/ray_wgmma.cu")
            raw3_p = render_kernel.fused_render_zvals_plain(packed_f, ro_chk, rd_chk, z_f, mcfg)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(raw3_k).all()), f"K3 {name}: non-finite output")
            rgb_err, sig_err, sig_scale = rgb_sigma_err(raw3_k, raw3_p)
            k3_err[name] = rgb_err
            emit("k3_check", variant=name, kernel=WGMMA["render_zvals"], rays=n_check,
                 samples=S3, depths="coarse pass + sample_pdf", rgb_max_abs_err=rgb_err,
                 sigma_max_rel_err=sig_err, max_abs_sigma=sig_scale, tol=K1_TOL,
                 **agreement(raw3_k, raw3_p))
            require(rgb_err <= K1_TOL and sig_err <= K1_TOL,
                    f"K3 {name}: rgb err {rgb_err}, sigma rel err {sig_err} > {K1_TOL}")
            checked[name] = (mcfg, packed_f, raw_k, z_f, raw3_k)

        # -- B9: the composited modes (the Hopper entries) vs the plain
        #    compositing of the raw Hopper kernels' own output (the MLP's error
        #    is held above; this isolates the in-kernel compositing). Beside
        #    the paths' depth counts, K1 at 8 and K3 at 100 depths for the
        #    reference network: several rays a 64-row step, and rays that cross
        #    steps at every offset
        b9_err = {"render_samples_composited": 0.0, "render_zvals_composited": 0.0}
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        g9 = torch.Generator(device=dev).manual_seed(9)
        for name, (mcfg, packed_f, raw_k, z_f, raw3_k) in checked.items():
            cases = [(SPP, raw_k, None), (S3, raw3_k, z_f)]
            if name == "reference":
                z100 = torch.sort(2.0 + 4.0 * torch.rand(n_check, 100, device=dev, generator=g9),
                                  -1).values
                cases += [(8, render_kernel.fused_render_samples(
                    packed_f, ro_chk, rd_chk, 2.0, 6.0, 8, mcfg, raw=True)[0], None),
                          (100, render_kernel.fused_render_zvals_raw(
                              packed_f, ro_chk, rd_chk, z100, mcfg), z100)]
            for S, raw, zz in cases:
                kname = "render_samples_composited" if zz is None else "render_zvals_composited"
                before = render_kernel.launches[kname]
                if zz is None:
                    out, w, zz = render_kernel.fused_render_samples_composited(
                        packed_f, ro_chk, rd_chk, 2.0, 6.0, S, mcfg, with_weights=True,
                        sentinel=sent, eps=eps)
                    ref = composite_kernel.fused_volume_render_interleaved_plain(
                        raw, zz, rd_chk, sent, eps, dz=(6.0 - 2.0) / (S - 1))
                else:
                    out, w = render_kernel.fused_render_zvals_composited(
                        packed_f, ro_chk, rd_chk, zz, mcfg, with_weights=True, sentinel=sent,
                        eps=eps)
                    ref = composite_kernel.fused_volume_render_interleaved_plain(raw, zz, rd_chk,
                                                                                 sent, eps)
                require(render_kernel.launches[kname] == before + 1,
                        f"{kname} on bf16 weights did not launch csrc/ray_wgmma.cu")
                torch.cuda.synchronize()
                require(bool(torch.isfinite(out).all() and torch.isfinite(w).all()),
                        f"{kname} {name}: non-finite output")
                e_rgb_acc, e_depth, e_w = composited_err(out, w, *ref)
                b9_err[kname] = max(b9_err[kname], e_rgb_acc, e_w)
                emit("b9_check", kernel=kname, cuda_kernel=WGMMA_COMPOSITED[kname], variant=name,
                     rays=n_check, samples=S, rgb_acc_max_abs_err=e_rgb_acc,
                     depth_max_rel_err=e_depth, w_max_abs_err=e_w, tol=B9_TOL,
                     reference="plain compositing of the raw Hopper kernel's output")
                require(e_rgb_acc <= B9_TOL and e_depth <= B9_TOL and e_w <= B9_TOL,
                        f"{kname} {name} S={S}: errors {e_rgb_acc}, {e_depth}, {e_w} > {B9_TOL}")

        # -- K2: kernel vs plain at every sample count (the paths' 1, 16, 32, 64,
        #    128, 192; 45 and 200: masked runs; 300: the chunked body), both raw
        #    types, broadcast and per-ray depths, 1, 1,001 and 16,384 rays, with
        #    zero-sigma and opaque samples; without the weights the outputs must
        #    equal those with them bit for bit
        k2_err, k2_cases = 0.0, {}
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        for i, (S2, dt, per_ray, n2) in enumerate(
                (S2, dt, per_ray, n2) for S2 in (*k2_ab.SAMPLE_COUNTS, K2_CHUNKED_S)
                for dt in (torch.float32, torch.bfloat16) for per_ray in (False, True)
                for n2 in K2_RAYS):
            raw2, zz, d2 = k2_ab.inputs(n2, S2, dt, per_ray, dev, seed=100 + i)
            before = composite_kernel.launches, composite_kernel.weightless_launches
            out_k, w_k = composite_kernel._launch(raw2, zz, d2, sent, eps)
            out_0, w_0 = composite_kernel._launch(raw2, zz, d2, sent, eps, with_weights=False)
            require((composite_kernel.launches - before[0],
                     composite_kernel.weightless_launches - before[1]) == (2, 1),
                    "k2_check: two launches of K2, one without weights, were not counted")
            out_p, w_p = composite_kernel.fused_volume_render_interleaved_plain(
                raw2, zz, d2, sent, eps)
            torch.cuda.synchronize()
            e = composited_err(out_k, w_k, out_p, w_p)
            same = w_0 is None and torch.equal(out_0, out_k)
            k2_err = max(k2_err, e[0], e[2])
            k2_cases[f"S={S2} {str(dt).split('.')[-1]} {'per-ray' if per_ray else 'broadcast'}"
                     f" z N={n2}"] = dict(errors=e, without_weights_bit_equal=same)
            require(bool(torch.isfinite(out_k).all() and torch.isfinite(w_k).all()),
                    f"K2 S={S2} {dt} N={n2}: non-finite output")
            require(max(e) <= K2_TOL, f"K2 S={S2} {dt} per-ray z {per_ray} N={n2}: errors {e} "
                    f"> {K2_TOL}")
            require(same, f"K2 S={S2} {dt} per-ray z {per_ray} N={n2}: the output without "
                    "weights differs from the output with them")
        emit("k2_check", kernel=K2_KERNEL, cases=k2_cases, tol=K2_TOL,
             error_kinds=["rgb/acc max abs", "depth max rel", "w max abs"],
             worst=max(max(c["errors"]) for c in k2_cases.values()))
        return k1_err, k3_err, b9_err, k2_err

    k1_err, k3_err, b9_err, k2_err = check_kernels()

    def sample_batch(n_rays, S, seed):
        """Samples as a pass of the trainer makes them: camera rays of the
        trained scene at S sorted random depths in [near, far]. Returns flat
        positions and directions [n_rays * S, 3]."""
        g = torch.Generator(device=dev).manual_seed(seed)
        ro, rd = camera_rays(poses[seed % len(poses)], focal, dev, n_rays, seed)
        z = torch.sort(2.0 + 4.0 * torch.rand(n_rays, S, device=dev, generator=g), -1).values
        pos = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
        return pos, rd[:, None, :].expand(n_rays, S, 3).reshape(-1, 3).contiguous()

    def check_new_kernels():
        """K4, K5 and K6 against their plain versions (K5 also against
        autograd); returns each kernel's largest absolute error."""
        mcfg = cfg_ref.model
        cfg_bm = bmild_config()
        seeded = init_nerf_params(torch.Generator().manual_seed(0), mcfg, dev)
        seeded_bm = init_nerf_params(torch.Generator().manual_seed(1), cfg_bm.model, dev)

        # -- K4: both variants, at a ragged sample count and at every shape a
        #    driven path gives it: a train step's coarse and fine pass, and a
        #    chunk of the uniform hierarchical frame's two passes
        k4_err = 0.0
        k4_shapes = ((1001, S3), (TRAIN_RAYS, SPP), (TRAIN_RAYS, S3), (CHUNK, SPP),
                     (CHUNK, N_FINE))
        for name, mc, params in (("reference", mcfg, fine), ("bmild", cfg_bm.model, seeded_bm)):
            pk = pack_params(params, mc, torch.bfloat16)
            for n_rays, S4 in k4_shapes:
                pos, dirs = sample_batch(n_rays, S4, seed=n_rays + S4)
                hopper = mlp_kernel.launches
                out_k = mlp_kernel._launch(pk, pos, dirs, mc)
                require(mlp_kernel.launches == hopper + 1, f"K4 {name} did not reach {K4_KERNEL}")
                out_p = mlp_kernel.fused_nerf_apply_plain(pk, pos, dirs, mc)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(out_k).all()), f"K4 {name}: non-finite output")
                rgb_err, sig_err, sig_scale = rgb_sigma_err(out_k.reshape(n_rays, -1),
                                                            out_p.reshape(n_rays, -1))
                k4_err = max(k4_err, rgb_err)
                emit("k4_check", variant=name, samples=n_rays * S4, rgb_max_abs_err=rgb_err,
                     sigma_max_rel_err=sig_err, max_abs_sigma=sig_scale, tol=K1_TOL,
                     kernel=K4_KERNEL, library=ray_wgmma.LIBRARY,
                     **agreement(out_k.reshape(n_rays, -1), out_p.reshape(n_rays, -1)))
                require(rgb_err <= K1_TOL and sig_err <= K1_TOL,
                        f"K4 {name}: rgb err {rgb_err}, sigma rel err {sig_err} > {K1_TOL}")
                del out_k, out_p

        # -- K5: trained and seeded weights, N = 1,500 and a train step's coarse
        #    and fine pass
        def autograd_grads(params, pos, dirs, dsig, drgb, dtype):
            paths, leaves = zip(*tree_leaves(params))
            leaves = [leaf.detach().clone().requires_grad_() for leaf in leaves]
            out = apply_nerf(tree_from_leaves(paths, leaves), pos, dirs, mcfg,
                             compute_dtype=dtype)
            return dict(zip(paths, torch.autograd.grad(out, leaves, (dsig, drgb))))

        k5_err = 0.0
        for name, params in (("trained", fine), ("seeded", seeded)):
            pk = pack_params(params, mcfg, torch.bfloat16)
            pos_all, dirs_all = sample_batch(TRAIN_RAYS, S3, seed=7)
            for n in (1500, N_COARSE_TRAIN, N_FINE_TRAIN):
                g = torch.Generator(device=dev).manual_seed(n)
                pos, dirs = pos_all[:n].contiguous(), dirs_all[:n].contiguous()
                dsig = torch.randn(n, device=dev, generator=g) / n
                drgb = torch.randn(n, 3, device=dev, generator=g) / n
                # each kernel on the first pass against its own plain version:
                # K5a's scratch (every quantity a leaf), K5b's partials slot by
                # slot on K5a's own scratch
                p1 = min(n, train_kernel.PASS_ROWS)
                scratch = torch.empty(train_kernel.scratch_elems(p1), dtype=torch.bfloat16,
                                      device=dev)
                parts = torch.empty(train_kernel.n_splits(p1), train_kernel.GRAD_FLOATS,
                                    device=dev)
                train_kernel.launch_rows(pk, pos[:p1], dirs[:p1], dsig[:p1], drgb[:p1], mcfg,
                                         scratch)
                train_kernel.launch_wgrad(scratch, p1, mcfg, parts, 0)
                rows_k = train_kernel.image_rows(scratch, p1)
                rows_p = train_kernel.scratch_rows(train_kernel.bwd_rows_plain(
                    pk, pos[:p1], dirs[:p1], dsig[:p1], drgb[:p1], mcfg))
                split = lambda f: {q: f[:, r:r + w] for (q, w), r in
                                   zip(train_kernel.SCRATCH, train_kernel.SCRATCH_ROW.values())}
                rows_vs_plain, rows_by_quantity = worst_rel(split(rows_k), split(rows_p))
                rows_bit_equal = (rows_k == rows_p).float().mean().item()
                parts_p = train_kernel.wgrad_split_plain(rows_k, train_kernel.split_bounds(p1),
                                                         mcfg)
                parts_vs_plain = max(worst_rel(train_kernel.grads_from_flat(parts[s]),
                                               train_kernel.grads_from_flat(parts_p[s]))[0]
                                     for s in range(parts.shape[0]))
                require(bool(torch.isfinite(parts).all()), f"K5b {name} N={n}: non-finite partial")
                del scratch, rows_k, rows_p, parts, parts_p
                g_k = train_kernel._launch(pk, pos, dirs, dsig, drgb, mcfg)
                g_k2 = train_kernel._launch(pk, pos, dirs, dsig, drgb, mcfg)
                g_p = train_kernel.packed_grads_plain(pk, pos, dirs, dsig, drgb, mcfg)
                torch.cuda.synchronize()
                require(all(bool(torch.isfinite(v).all()) for v in g_k.values()),
                        f"K5 {name} N={n}: non-finite gradient")
                bit_equal = all(torch.equal(g_k[k], g_k2[k]) for k in g_k)
                vs_plain, per_leaf = worst_rel(g_k, g_p)
                k5_err = max(k5_err, max((g_k[k] - g_p[k]).abs().max().item() for k in g_k))
                g_f32 = autograd_grads(params, pos, dirs, dsig, drgb, torch.float32)
                g_bf16 = autograd_grads(params, pos, dirs, dsig, drgb, torch.bfloat16)
                kernel_noise, _ = worst_rel(dict(tree_leaves(train_kernel.unpack_grads(g_k, mcfg))),
                                            g_f32)
                bf16_noise, _ = worst_rel(g_bf16, g_f32)
                limit = max(2.0 * bf16_noise, K5_MIN_TOL)
                emit("k5_check", weights=name, samples=n, two_runs_bit_equal=bit_equal,
                     passes=len(train_kernel.pass_bounds(n)),
                     k5a_scratch_worst_quantity_vs_plain=rows_vs_plain,
                     k5a_scratch_rel_err_by_quantity=rows_by_quantity,
                     k5a_scratch_share_bit_equal=rows_bit_equal,
                     k5b_worst_slot_leaf_vs_plain=parts_vs_plain, k5b_tol=K5B_PLAIN_TOL,
                     rel_err_vs_plain_by_leaf=per_leaf, worst_leaf_vs_plain=vs_plain,
                     plain_tol=K5_PLAIN_TOL, worst_leaf_vs_f32_autograd=kernel_noise,
                     bf16_autograd_worst_leaf_vs_f32=bf16_noise, limit=limit)
                require(bit_equal, f"K5 {name} N={n}: two runs differ")
                require(rows_vs_plain <= K5_PLAIN_TOL,
                        f"K5a {name} N={n}: scratch {rows_vs_plain} from bwd_rows_plain")
                require(parts_vs_plain <= K5B_PLAIN_TOL,
                        f"K5b {name} N={n}: partials {parts_vs_plain} from wgrad_split_plain")
                require(vs_plain <= K5_PLAIN_TOL,
                        f"K5 {name} N={n}: worst leaf {vs_plain} from the plain version")
                require(kernel_noise < limit,
                        f"K5 {name} N={n}: worst leaf {kernel_noise} vs float32 autograd, "
                        f"bf16 autograd's {bf16_noise}")
                del g_k, g_k2, g_p, g_f32, g_bf16
                torch.cuda.empty_cache()

        # the bytes K5 writes, against another commit's (--k5-reference)
        digests = k5_digest.digests()
        same = None
        if K5_REFERENCE is not None:
            with open(K5_REFERENCE) as f:
                ref = json.load(f)["digests"]
            same = {n: [a == b for a, b in zip(d["passes"], ref[n]["passes"])]
                    + [d["grads"] == ref[n]["grads"]] for n, d in digests.items()}
        emit("k5_digest", passes={n: len(d["passes"]) for n, d in digests.items()},
             reference=K5_REFERENCE, passes_and_grads_equal_to_reference=same, digests=digests)
        require(same is None or all(all(v) for v in same.values()),
                f"K5's scratch or partials differ from {K5_REFERENCE}: {same}")

        # -- K6: both sample counts of the uniform render, three input forms ------
        g = torch.Generator(device=dev).manual_seed(6)
        k6_err = 0.0
        for S6 in (SPP, N_FINE):
            sigma = torch.rand(CHUNK, S6, device=dev, generator=g) * 50.0
            sigma[:, ::7] = 0.0
            sigma[::5, S6 // 2] = 1e6                                   # opaque samples
            rgb = torch.rand(CHUNK, S6, 3, device=dev, generator=g)
            z6 = torch.sort(2.0 + 4.0 * torch.rand(CHUNK, S6, device=dev, generator=g), -1).values
            d6 = torch.randn(CHUNK, 3, device=dev, generator=g)
            out4 = torch.cat([sigma[..., None], rgb], -1).reshape(CHUNK * S6, 4).contiguous()
            forms = {
                "[N,S,3]": (sigma, rgb.unbind(-1)),
                "three planes": (sigma, [rgb[..., c].contiguous() for c in range(3)]),
                "views of the MLP kernel's [N*S,4]": (
                    out4[:, 0].reshape(CHUNK, S6), out4[:, 1:4].reshape(CHUNK, S6, 3).unbind(-1)),
            }
            out_p, w_p = composite_kernel.fused_volume_render_plain(
                sigma, rgb.unbind(-1), z6, d6, rcfg.dist_sentinel, rcfg.transmittance_eps)
            for form, (sg, planes) in forms.items():
                out_k, w_k = composite_kernel._launch_planar(sg, planes, z6, d6, rcfg.dist_sentinel,
                                                             rcfg.transmittance_eps)
                torch.cuda.synchronize()
                e_rgb_acc, e_depth, e_w = composited_err(out_k, w_k, out_p, w_p)
                k6_err = max(k6_err, e_rgb_acc, e_w)
                emit("k6_check", rays=CHUNK, samples=S6, rgb_form=form,
                     rgb_acc_max_abs_err=e_rgb_acc, depth_max_rel_err=e_depth,
                     w_max_abs_err=e_w, tol=K2_TOL)
                require(e_rgb_acc <= K2_TOL and e_depth <= K2_TOL and e_w <= K2_TOL,
                        f"K6: errors {e_rgb_acc}, {e_depth}, {e_w} > {K2_TOL}")
        return k4_err, k5_err, k6_err

    k4_err, k5_err, k6_err = check_new_kernels()
    torch.cuda.empty_cache()

    def time_k2(raw_dtype):
        """K2 in two turns (device ms per launch by the profiler) at every
        case of a raw type at the chunk: S in k2_ab.SAMPLE_COUNTS, broadcast
        and per-ray depths, with and without the weights; each with its
        bound (its bytes: no weights where none are written). Returns {case:
        times}."""
        res = {}
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        out8 = torch.empty(CHUNK, 8, device=dev)
        for i, (S2, dt, per_ray, with_w) in enumerate(k2_ab.cases((raw_dtype,))):
            raw2, zz, d2 = k2_ab.inputs(CHUNK, S2, dt, per_ray, dev, seed=200 + i)
            k2 = lambda: composite_kernel._launch(raw2, zz, d2, sent, eps, with_w)
            turns = k2_ab.device_ms_in_turns([("k2", k2, (K2_KERNEL,))] * 2,
                                             tries=1 + RETRACES)
            require(turns is not None,
                    f"K2 S={S2} {dt}: {1 + RETRACES} traces lost kernel records")
            w_out = torch.empty(CHUNK, S2, device=dev)
            b = bound_ms(0, 20 * CHUNK * S2, nbytes(raw2, zz, d2, out8, w_out if with_w
                                                    else None))
            ms = float(np.mean(turns["k2"]))
            res[f"S={S2} {'per-ray' if per_ray else 'broadcast'} z "
                f"{'with' if with_w else 'without'} w"] = dict(
                samples=S2, per_ray_z=per_ray, with_weights=with_w,
                chunks=len(composite_kernel.ray_chunks(S2)), ms=ms, turns=turns["k2"],
                bound_ms=b[0], bound_by=b[1], bound_share=b[0] / ms)
            del raw2, zz, d2, w_out
        return res

    def time_kernels():
        """Each kernel and its plain version at a chunk of the main paths:
        times, bound, and the kernel's output held against its reference
        there. Returns the times, the bounds and each kernel's largest
        absolute error at the chunk."""
        # -- kernel times and checks at the main paths' chunk shapes -------------
        # call_ms: stream time per call between CUDA events over back-to-back
        # calls
        mcfg = cfg_ref.model
        packed = pack_params(fine, mcfg, torch.bfloat16)
        packed_c = pack_params(coarse, mcfg, torch.bfloat16)
        ro, rd = camera_rays(poses[1], focal, dev, CHUNK, seed=1)
        raw, z = render_kernel.fused_render_samples(packed, ro, rd, 2.0, 6.0, SPP, mcfg, raw=True)
        z3 = hier_depths(render_kernel, composite_kernel, sample_pdf, packed_c, ro, rd, mcfg, rcfg)
        raw3 = render_kernel.fused_render_zvals_raw(packed, ro, rd, z3, mcfg)
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        plain_composite = composite_kernel.fused_volume_render_interleaved_plain
        k1_plain = lambda: render_kernel.fused_render_samples_plain(packed, ro, rd, 2.0, 6.0, SPP,
                                                                    mcfg)
        k3_plain = lambda: render_kernel.fused_render_zvals_plain(packed, ro, rd, z3, mcfg)
        # name: (kernel call, plain version, repetitions of each, the reference
        # the kernel's output is held against, tolerance). The composited
        # kernels are held against the plain compositing of the raw kernels'
        # output at the same chunk (B9_TOL); the MLP's error is K1_TOL's.
        calls = {
            "render_samples": (
                lambda: render_kernel._launch(packed, ro, rd, 2.0, 6.0, SPP, mcfg),
                k1_plain, 10, 3, k1_plain, K1_TOL),
            # K2 without its weights, as the benchmark frame and the fine pass
            # call it
            "composite": (
                lambda: composite_kernel._launch(raw, z, rd, sent, eps, with_weights=False),
                lambda: plain_composite(raw, z, rd, sent, eps),
                30, 10, lambda: plain_composite(raw, z, rd, sent, eps), K2_TOL),
            "composite_192": (
                lambda: composite_kernel._launch(raw3, z3, rd, sent, eps, with_weights=False),
                lambda: plain_composite(raw3, z3, rd, sent, eps),
                30, 10, lambda: plain_composite(raw3, z3, rd, sent, eps), K2_TOL),
            "render_zvals": (
                lambda: render_kernel._launch(packed, ro, rd, 0.0, 0.0, S3, mcfg, z_vals=z3),
                k3_plain, 5, 2, k3_plain, K1_TOL),
            "render_samples_composited": (   # with weights: the hierarchical coarse pass
                lambda: render_kernel._launch(packed, ro, rd, 2.0, 6.0, SPP, mcfg, composited=True,
                                              with_weights=True, sentinel=sent, eps=eps),
                lambda: render_kernel.fused_render_samples_composited_plain(
                    packed, ro, rd, 2.0, 6.0, SPP, mcfg, sent, eps),
                10, 3, lambda: plain_composite(raw, z, rd, sent, eps, dz=(6.0 - 2.0) / (SPP - 1)),
                B9_TOL),
            "render_zvals_composited": (     # without weights: the hierarchical fine pass
                lambda: render_kernel._launch(packed, ro, rd, 0.0, 0.0, S3, mcfg, z_vals=z3,
                                              composited=True, sentinel=sent, eps=eps),
                lambda: render_kernel.fused_render_zvals_composited_plain(
                    packed, ro, rd, z3, mcfg, sent, eps),
                5, 2, lambda: plain_composite(raw3, z3, rd, sent, eps), B9_TOL),
        }
        t_call, t_plain, chunk_err, chunk_abs, chunk_agree = {}, {}, {}, {}, {}
        for name, (kern, plain, reps, plain_reps, ref, tol) in calls.items():
            t_call[name] = call_ms(kern, reps)
            t_plain[name] = call_ms(plain, plain_reps)
            got, want = kern(), ref()
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):            # raw: (rgb abs, sigma rel)
                require(bool(torch.isfinite(got).all()), f"{name} chunk: non-finite output")
                e = rgb_sigma_err(got, want)[:2]
                chunk_abs[name] = e[0]
                chunk_agree[name] = agreement(got, want)
            else:                                        # composited: (rgb/acc abs, depth rel, w abs)
                require(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
                        f"{name} chunk: non-finite output")
                e = composited_err(*got, *want)
                chunk_abs[name] = max(e[0], e[2])
            chunk_err[name] = e
            require(max(e) <= tol, f"{name} at {CHUNK} rays: errors {e} > {tol}")
            del got, want
            torch.cuda.empty_cache()
        # the Hopper kernels on the other variant at the chunk (seeded bmild
        # weights; K3 at the same depths)
        cfg_bm = bmild_config().model
        packed_bm = pack_params(init_nerf_params(torch.Generator().manual_seed(1), cfg_bm, dev),
                                cfg_bm, torch.bfloat16)
        for name, kern, plain in (
                ("render_samples", lambda: render_kernel._launch(packed_bm, ro, rd, 2.0, 6.0, SPP,
                                                                 cfg_bm),
                 lambda: render_kernel.fused_render_samples_plain(packed_bm, ro, rd, 2.0, 6.0, SPP,
                                                                  cfg_bm)),
                ("render_zvals", lambda: render_kernel._launch(packed_bm, ro, rd, 0.0, 0.0, S3,
                                                               cfg_bm, z_vals=z3),
                 lambda: render_kernel.fused_render_zvals_plain(packed_bm, ro, rd, z3, cfg_bm))):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"{name} bmild chunk: non-finite output")
            e = rgb_sigma_err(got, want)[:2]
            chunk_err[f"{name} bmild"] = e
            chunk_abs[name] = max(chunk_abs[name], e[0])
            chunk_agree[f"{name} bmild"] = agreement(got, want)
            require(max(e) <= K1_TOL, f"{name} bmild at {CHUNK} rays: errors {e} > {K1_TOL}")
            del got, want
        emit("chunk_check", rays=CHUNK, errors=chunk_err, agreement_raw=chunk_agree,
             kernels={**WGMMA, **WGMMA_COMPOSITED},
             tol={name: c[5] for name, c in calls.items()},
             error_kinds={"raw": ["rgb max abs", "sigma max rel"],
                          "composited": ["rgb/acc max abs", "depth max rel", "w max abs"]})
        comp_ops = 20                         # float32 operations per composited sample
        out8 = torch.empty(CHUNK, 8, device=dev)
        w64, w192 = torch.empty(CHUNK, SPP, device=dev), torch.empty(CHUNK, S3, device=dev)
        weights_bytes = nbytes(*packed)
        bounds = {
            "render_samples": bound_ms(k1_flops(mcfg, CHUNK, SPP), 0,
                                       nbytes(ro, rd) + weights_bytes + CHUNK * SPP * 16),
            "composite": bound_ms(0, comp_ops * CHUNK * SPP, nbytes(raw, z, rd, out8)),
            "composite_192": bound_ms(0, comp_ops * CHUNK * S3, nbytes(raw3, z3, rd, out8)),
            "render_zvals": bound_ms(k1_flops(mcfg, CHUNK, S3), 0,
                                     nbytes(ro, rd, z3) + weights_bytes + CHUNK * S3 * 16),
            "render_samples_composited": bound_ms(k1_flops(mcfg, CHUNK, SPP),
                                                  comp_ops * CHUNK * SPP,
                                                  nbytes(ro, rd, out8, w64) + weights_bytes),
            "render_zvals_composited": bound_ms(k1_flops(mcfg, CHUNK, S3), comp_ops * CHUNK * S3,
                                                nbytes(ro, rd, z3, out8) + weights_bytes),
        }
        # the L2 probe: 132 blocks stream the 1 MiB weight stream through a
        # ring as the producer does
        stream = ray_wgmma.stream_for(packed, mcfg)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        probe_reps = 50
        probe_ms = call_ms(lambda: ray_wgmma.l2_probe(stream, probe_reps, n_sm), 5)
        stream_bytes = stream.numel() * stream.element_size()
        tiles = {k: CHUNK * S / 128 for k, S in (("render_samples", SPP), ("render_zvals", S3))}
        l2 = dict(blocks=n_sm, reps=probe_reps, bytes=stream_bytes, ms=probe_ms,
                  bytes_per_s=n_sm * probe_reps * stream_bytes / (probe_ms * 1e-3),
                  weight_stream_bytes_per_s={k: tiles[k] * stream_bytes / (t_call[k] * 1e-3)
                                             for k in WGMMA},
                  at_bound_bytes_per_s={k: tiles[k] * stream_bytes / (bounds[k][0] * 1e-3)
                                        for k in WGMMA})
        # K2 at every case on a float32 raw, the launch floor (an empty
        # kernel's device time), and K6 again
        k2_turns = time_k2(torch.float32)
        floor_ms = k2_ab.launch_floor_ms()
        g6 = torch.Generator(device=dev).manual_seed(8)
        sig6 = torch.rand(CHUNK, N_FINE, device=dev, generator=g6) * 50.0
        rgb6 = torch.rand(CHUNK, N_FINE, 3, device=dev, generator=g6)
        z6 = torch.sort(2.0 + 4.0 * torch.rand(CHUNK, N_FINE, device=dev, generator=g6),
                        -1).values
        d6 = torch.randn(CHUNK, 3, device=dev, generator=g6)
        k6 = lambda: composite_kernel._launch_planar(sig6, rgb6.unbind(-1), z6, d6, sent, eps)
        k6_turns = k2_ab.device_ms_in_turns([("k6", k6, ("composite_planar_kernel",))] * 2)
        k6_times = dict(ms=None if k6_turns is None else float(np.mean(k6_turns["k6"])),
                        turns=k6_turns, bound=bound_ms(0, 20 * CHUNK * N_FINE, nbytes(
                            sig6, rgb6, z6, d6) + CHUNK * 8 * 4 + CHUNK * N_FINE * 4))
        del sig6, rgb6, z6, d6
        emit("kernel_times", rays=CHUNK, samples={"render_samples": SPP, "composite": SPP,
                                                  "composite_192": S3, "render_zvals": S3,
                                                  "render_samples_composited": SPP,
                                                  "render_zvals_composited": S3},
             call_ms=t_call, plain_ms=t_plain,
             bound_ms={k: v[0] for k, v in bounds.items()},
             bound_by={k: v[1] for k, v in bounds.items()},
             l2_probe=l2, k2_f32=k2_turns, launch_floor_ms=floor_ms,
             k6_at_16384x128={"ms": k6_times["ms"], "turns": k6_times["turns"],
                              "bound_ms": k6_times["bound"][0]},
             nvidia_smi=smi)
        return t_call, t_plain, bounds, chunk_abs, l2, k2_turns, floor_ms, k6_times

    # each phase's tensors are freed before the frames, so a frame's peak
    # device memory is the weights and the frame's own
    (t_call, t_plain, bounds, chunk_abs, l2_probe, k2_f32, k2_floor,
     k6_times) = time_kernels()
    torch.cuda.empty_cache()

    def time_new_kernels():
        """K4 and K5 at a train step's two shapes and K6 at a chunk of the
        uniform fine pass: stream time per call, the plain version's, the
        bound, and for K5 the backward of bf16 autograd through apply_nerf
        (a chain of library products) on the same samples."""
        mcfg = cfg_ref.model
        pk = pack_params(fine, mcfg, torch.bfloat16)
        weights_bytes = nbytes(*pk)
        grad_bytes = 4 * sum(math.prod(shape) for shape in train_kernel.GRAD_SHAPES.values())
        fwd, dgrad = mlp_macs(mcfg), mlp_macs(mcfg, with_dgrad_only=True)
        res = {"mlp_forward": {}, "mlp_backward": {}}
        for n in (N_COARSE_TRAIN, N_FINE_TRAIN):
            pos, dirs = sample_batch(TRAIN_RAYS, S3, seed=9)
            pos, dirs = pos[:n].contiguous(), dirs[:n].contiguous()
            g = torch.Generator(device=dev).manual_seed(n)
            dsig = torch.randn(n, device=dev, generator=g) / n
            drgb = torch.randn(n, 3, device=dev, generator=g) / n
            paths, leaves = zip(*tree_leaves(fine))
            leaves = [leaf.detach().clone().requires_grad_() for leaf in leaves]
            tree = tree_from_leaves(paths, leaves)
            out = apply_nerf(tree, pos, dirs, mcfg, compute_dtype=torch.bfloat16)

            def autograd_fwd_bwd():
                o = apply_nerf(tree, pos, dirs, mcfg, compute_dtype=torch.bfloat16)
                torch.autograd.grad(o, leaves, (dsig, drgb))

            # K4 in two turns
            k4 = lambda: mlp_kernel._launch(pk, pos, dirs, mcfg)
            turns = [call_ms(k4, 10), call_ms(k4, 10)]
            res["mlp_forward"][n] = dict(
                device_ms=profiled_ms(k4, K4_KERNEL, 5), call_ms=float(np.mean(turns)),
                call_ms_turns=turns,
                plain_ms=call_ms(lambda: mlp_kernel.fused_nerf_apply_plain(pk, pos, dirs, mcfg), 3),
                bound=bound_ms(2 * fwd * n, 0, nbytes(pos, dirs) + weights_bytes + n * 16))
            # K5 in two turns; the bound is the algorithm's, whatever runs it
            k5 = lambda: train_kernel._launch(pk, pos, dirs, dsig, drgb, mcfg)
            turns = [call_ms(k5, 5), call_ms(k5, 5)]
            by_kernel = profiled_kernels_ms(k5, K5_KERNELS, 5)
            res["mlp_backward"][n] = dict(
                device_ms=None if by_kernel is None else sum(v["ms"] for v in by_kernel.values()),
                device_ms_by_kernel=by_kernel, call_ms=float(np.mean(turns)),
                call_ms_turns=turns,
                plain_ms=call_ms(lambda: train_kernel.packed_grads_plain(pk, pos, dirs, dsig, drgb,
                                                                         mcfg), 2),
                library_ms=call_ms(lambda: torch.autograd.grad(out, leaves, (dsig, drgb),
                                                               retain_graph=True), 3),
                library_fwd_bwd_ms=call_ms(autograd_fwd_bwd, 3),
                bound=bound_ms(2 * (2 * fwd + dgrad) * n, 0,
                               nbytes(pos, dirs, dsig, drgb) + weights_bytes + grad_bytes))
            del out, tree, leaves
            torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(8)
        sigma = torch.rand(CHUNK, N_FINE, device=dev, generator=g) * 50.0
        rgb = torch.rand(CHUNK, N_FINE, 3, device=dev, generator=g)
        z6 = torch.sort(2.0 + 4.0 * torch.rand(CHUNK, N_FINE, device=dev, generator=g), -1).values
        d6 = torch.randn(CHUNK, 3, device=dev, generator=g)
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        res["composite_planar"] = {CHUNK * N_FINE: dict(
            device_ms=profiled_ms(lambda: composite_kernel._launch_planar(
                sigma, rgb.unbind(-1), z6, d6, sent, eps), "composite_planar_kernel", 20),
            call_ms=call_ms(lambda: composite_kernel._launch_planar(sigma, rgb.unbind(-1), z6, d6,
                                                                    sent, eps), 30),
            plain_ms=call_ms(lambda: composite_kernel.fused_volume_render_plain(
                sigma, rgb.unbind(-1), z6, d6, sent, eps), 10),
            bound=bound_ms(0, 20 * CHUNK * N_FINE,
                           nbytes(sigma, rgb, z6, d6) + CHUNK * 8 * 4 + CHUNK * N_FINE * 4))}
        emit("kernel_times_train", nvidia_smi=smi, samples_or_rays_x_samples={
            k: {str(n): {**{kk: vv for kk, vv in v.items() if kk != "bound"},
                         "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                for n, v in by_n.items()} for k, by_n in res.items()},
            library="mlp_backward: the backward (and forward + backward) of bf16 autograd "
                    "through apply_nerf, a chain of library products")
        return res

    new_times = time_new_kernels()
    torch.cuda.empty_cache()

    def quantized(params, mcfg, bits, act_bits):
        """One network pruned and quantized as the engines do it."""
        return quantize_model({"fine": params}, mcfg, bits=bits, prune_fraction=0.1,
                              act_bits=act_bits, pos_bound=POS_BOUND)[0]["fine"]

    ROUTES = (("int8", 8, None), ("int16", 16, None), ("int8_compute", 8, 8))

    def check_quant_kernels():
        """K7, the ray kernels on quantized weights and the int8-compute
        route against their plain versions, and the bf16 and planar raw
        outputs against the fp32 raw output; returns the largest errors by
        summary row."""
        cfg_bm = bmild_config()
        seeded_bm = init_nerf_params(torch.Generator().manual_seed(1), cfg_bm.model, dev)
        variants = (("reference", cfg_ref.model, fine), ("bmild", cfg_bm.model, seeded_bm))
        n_check = 1001
        ro_s, rd_s = with_padding(*camera_rays(poses[0], focal, dev, n_check - 3, seed=0), 3)
        ro_c, rd_c = camera_rays(poses[1], focal, dev, CHUNK, seed=1)
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        worst = {"mlp_quant": 0.0, "ray_dequant": 0.0, "int8": 0.0, "planar": 0.0,
                 "raw_bf16": 0.0, "b9": 0.0}

        def held(phase, what, got, want, tol, **kw):
            require(bool(torch.isfinite(got).all()), f"{phase} {what}: non-finite output")
            rgb_err, sig_err, sig_scale = rgb_sigma_err(got, want)
            diff = (got.reshape(-1, 4)[:, 1:] - want.reshape(-1, 4)[:, 1:]).abs()
            emit(phase, what=what, rgb_max_abs_err=rgb_err, sigma_max_rel_err=sig_err,
                 max_abs_sigma=sig_scale, tol=tol, rgb_mean_abs_err=diff.mean().item(),
                 share_of_values_equal=(diff == 0).float().mean().item(), **kw)
            require(rgb_err <= tol and sig_err <= tol,
                    f"{phase} {what}: rgb err {rgb_err}, sigma rel err {sig_err} > {tol}")
            return rgb_err

        for vname, mcfg, params in variants:
            packed_c = pack_params(coarse if vname == "reference" else params, mcfg,
                                   torch.bfloat16)
            for route, bits, act_bits in ROUTES:
                q = quantized(params, mcfg, bits, act_bits)
                k8 = act_bits is not None
                tol = K8_TOL if k8 else QUANT_TOL
                # -- dequant_check: the dequantize routes' prologue against its
                #    plain version on the CPU, bit for bit, on both streams
                q_cpu = None if k8 else type(q)(*[None if t is None else t.cpu() for t in q])
                for per_sample in () if k8 else (False, True):
                    q_stream = (ray_wgmma.sample_stream_for if per_sample
                                else ray_wgmma.stream_for)(q, mcfg)
                    before = dequant_stream.launches
                    got = dequant_stream.dequant_stream(q, q_stream, mcfg, per_sample)
                    want = dequant_stream.dequant_stream_plain(q_cpu, q_stream.cpu(), mcfg,
                                                               per_sample)
                    equal = [torch.equal(a.cpu().view(torch.int16), b.view(torch.int16))
                             for a, b in zip(got, want)]
                    emit("dequant_check", route=route, variant=vname, per_sample=per_sample,
                         kernel=DEQUANT_KERNEL, stream_values=got.stream.numel(),
                         resident_values=got.resident.numel(), stream_bit_equal=equal[0],
                         resident_bit_equal=equal[1])
                    require(all(equal) and dequant_stream.launches == before + 1,
                            f"dequant_check {route} {vname} per_sample={per_sample}: "
                            f"bit-equal {equal}, launches {dequant_stream.launches - before}")
                # -- K7 (k7_check; on the int8-compute route: k8_check) at a ragged
                #    count and at the uniform hierarchical frame's two chunks
                shapes = ((n_check, S3), (CHUNK, SPP), (CHUNK, N_FINE))
                for n_rays, S in shapes if vname == "reference" else shapes[:1]:
                    pos, dirs = sample_batch(n_rays, S, seed=n_rays + S)
                    hopper = quant.launches["mlp_quant"]
                    got = quant._launch(q, pos, dirs, mcfg).reshape(n_rays, -1)
                    require(quant.launches["mlp_quant"] == hopper + 1,
                            f"K7 on {route} weights did not reach {K4_KERNEL}")
                    e = held("k8_check" if k8 else "k7_check",
                             f"mlp_quant {route} {vname} {n_rays * S} samples", got,
                             quant.quantized_nerf_apply_plain(q, pos, dirs, mcfg).reshape(n_rays, -1),
                             tol, kernel=K4_KERNEL, library=ray_wgmma.LIBRARIES[quant.route_of(q)])
                    worst["int8" if k8 else "mlp_quant"] = max(worst["int8" if k8 else "mlp_quant"], e)
                    del pos, dirs, got
                # -- K1 and K3 raw and composited (quant_ray_check / k8_check) at
                #    1,001 rays and, for the trained network, at the chunk
                for ro, rd in ((ro_s, rd_s), (ro_c, rd_c)) if vname == "reference" else (
                        (ro_s, rd_s),):
                    R = ro.shape[0]
                    phase = "k8_check" if k8 else "quant_ray_check"
                    hopper = render_kernel.launches["render_samples"]
                    raw1, z1 = render_kernel.fused_render_samples(q, ro, rd, 2.0, 6.0, SPP, mcfg,
                                                                  raw=True)
                    require(render_kernel.launches["render_samples"] == hopper + 1,
                            f"K1 on {route} weights did not launch csrc/ray_wgmma.cu")
                    e1 = held(phase, f"render_samples {route} {vname} {R} rays", raw1,
                              render_kernel.fused_render_samples_plain(q, ro, rd, 2.0, 6.0, SPP,
                                                                       mcfg), tol,
                              kernel=WGMMA["render_samples"],
                              library=render_kernel.kernel_library(quant.route_of(q), False))
                    z_f = hier_depths(render_kernel, composite_kernel, sample_pdf, packed_c, ro,
                                      rd, mcfg, rcfg)
                    hopper = render_kernel.launches["render_zvals"]
                    raw3 = render_kernel.fused_render_zvals_raw(q, ro, rd, z_f, mcfg)
                    require(render_kernel.launches["render_zvals"] == hopper + 1,
                            f"K3 on {route} weights did not launch csrc/ray_wgmma.cu")
                    e3 = held(phase, f"render_zvals {route} {vname} {R} rays", raw3,
                              render_kernel.fused_render_zvals_plain(q, ro, rd, z_f, mcfg), tol,
                              kernel=WGMMA["render_zvals"],
                              library=render_kernel.kernel_library(quant.route_of(q), False))
                    # B9 on this route: the composited Hopper entries vs the plain
                    # compositing of the route's raw Hopper output
                    hopper = (render_kernel.launches["render_samples_composited"],
                              render_kernel.launches["render_zvals_composited"])
                    out1, w1, _ = render_kernel.fused_render_samples_composited(
                        q, ro, rd, 2.0, 6.0, SPP, mcfg, with_weights=True, sentinel=sent, eps=eps)
                    ref1 = composite_kernel.fused_volume_render_interleaved_plain(
                        raw1, z1, rd, sent, eps, dz=(6.0 - 2.0) / (SPP - 1))
                    out3, w3 = render_kernel.fused_render_zvals_composited(
                        q, ro, rd, z_f, mcfg, with_weights=True, sentinel=sent, eps=eps)
                    ref3 = composite_kernel.fused_volume_render_interleaved_plain(raw3, z_f, rd,
                                                                                  sent, eps)
                    require((render_kernel.launches["render_samples_composited"],
                             render_kernel.launches["render_zvals_composited"])
                            == (hopper[0] + 1, hopper[1] + 1),
                            f"composited K1/K3 on {route} weights did not launch csrc/ray_wgmma.cu")
                    torch.cuda.synchronize()
                    require(all(bool(torch.isfinite(t).all()) for t in (out1, w1, out3, w3)),
                            f"{phase} composited {route} {vname}: non-finite output")
                    ec = [composited_err(out1, w1, *ref1), composited_err(out3, w3, *ref3)]
                    emit(phase, what=f"composited {route} {vname} {R} rays",
                         errors={"render_samples_composited": ec[0],
                                 "render_zvals_composited": ec[1]}, tol=B9_TOL,
                         error_kinds=["rgb/acc max abs", "depth max rel", "w max abs"],
                         kernels=WGMMA_COMPOSITED,
                         library=render_kernel.kernel_library(quant.route_of(q), True),
                         reference="plain compositing of the raw Hopper kernel's output")
                    require(max(max(ec[0]), max(ec[1])) <= B9_TOL,
                            f"{phase} composited {route} {vname}: errors {ec} > {B9_TOL}")
                    worst["b9"] = max(worst["b9"], *(max(e[0], e[2]) for e in ec))
                    key = "int8" if k8 else "ray_dequant"
                    worst[key] = max(worst[key], e1, e3)
                    del raw1, raw3, out1, out3, w1, w3, ref1, ref3, z_f
                    torch.cuda.empty_cache()

        # -- K8's corner cases: a layer whose activations are 0 on every row (its
        #    bias pushed far below 0: ax = 0, the row quantizes to zeros) and
        #    positions beyond pos_bound (the int8 clip saturates)
        mcfg = cfg_ref.model
        dead = {**fine, "trunk": [dict(layer) for layer in fine["trunk"]]}
        dead["trunk"][2]["b"] = torch.full_like(fine["trunk"][2]["b"], -1e3)
        q_dead = quantized(dead, mcfg, 8, 8)
        pos, dirs = sample_batch(n_check, SPP, seed=3)
        k_dead = quant._launch(q_dead, pos, dirs, mcfg)
        p_dead = quant.quantized_nerf_apply_plain(q_dead, pos, dirs, mcfg)
        e_dead = held("k8_check", "mlp_quant int8_compute, trunk layer 2 dead on every row",
                      k_dead.reshape(n_check, -1), p_dead.reshape(n_check, -1), K8_TOL)
        q_small = quantize_model({"fine": fine}, mcfg, bits=8, prune_fraction=0.1, act_bits=8,
                                 pos_bound=1.0)[0]["fine"]
        far = pos * 5.0 / pos.abs().amax(dim=-1, keepdim=True)       # |x|_inf = 5, 5 x the bound
        e_far = held("k8_check", "mlp_quant int8_compute, positions 5 x beyond pos_bound = 1",
                     quant._launch(q_small, far, dirs, mcfg).reshape(n_check, -1),
                     quant.quantized_nerf_apply_plain(q_small, far, dirs, mcfg).reshape(n_check, -1),
                     K8_TOL)
        raw_far, _ = render_kernel.fused_render_samples(q_small, ro_s, rd_s, 2.0, 6.0, SPP, mcfg,
                                                        raw=True)
        e_far1 = held("k8_check", "render_samples int8_compute, pos_bound = 1 (rays reach 6)",
                      raw_far, render_kernel.fused_render_samples_plain(q_small, ro_s, rd_s, 2.0,
                                                                        6.0, SPP, mcfg), K8_TOL)
        worst["int8"] = max(worst["int8"], e_dead, e_far, e_far1)

        # -- modes_check: the three raw forms of the Hopper kernels, both variants:
        #    the fp32 raw against the plain version, bf16 raw and planar against
        #    the fp32 raw, K2 on the bf16 raw and K6 on the planes
        pk_ref = (pack_params(fine, mcfg, torch.bfloat16), pack_params(coarse, mcfg, torch.bfloat16))
        pk_bm = pack_params(seeded_bm, cfg_bm.model, torch.bfloat16)
        for vname, mcfg, (packed, packed_c), ro, rd in (
                ("reference", cfg_ref.model, pk_ref, ro_s, rd_s),
                ("reference", cfg_ref.model, pk_ref, ro_c, rd_c),
                ("bmild", cfg_bm.model, (pk_bm, pk_bm), ro_s, rd_s)):
            R = ro.shape[0]
            z_f = hier_depths(render_kernel, composite_kernel, sample_pdf, packed_c, ro, rd, mcfg,
                              rcfg)
            raw1, z1 = render_kernel.fused_render_samples(packed, ro, rd, 2.0, 6.0, SPP, mcfg,
                                                          raw=True)
            raw3 = render_kernel.fused_render_zvals_raw(packed, ro, rd, z_f, mcfg)
            b1, _ = render_kernel.fused_render_samples(packed, ro, rd, 2.0, 6.0, SPP, mcfg,
                                                       raw=True, raw_dtype=torch.bfloat16)
            b3 = render_kernel.fused_render_zvals_raw(packed, ro, rd, z_f, mcfg,
                                                      raw_dtype=torch.bfloat16)
            sg1, pl1, _ = render_kernel.fused_render_samples(packed, ro, rd, 2.0, 6.0, SPP, mcfg,
                                                             planar=True)
            sg3, pl3 = render_kernel.fused_render_zvals_planar(packed, ro, rd, z_f, mcfg)
            torch.cuda.synchronize()
            plain = {"render_samples": render_kernel.fused_render_samples_plain(
                         packed, ro, rd, 2.0, 6.0, SPP, mcfg),
                     "render_zvals": render_kernel.fused_render_zvals_plain(packed, ro, rd, z_f,
                                                                            mcfg)}
            for kname, raw, b, sg, pl, zz in (("render_samples", raw1, b1, sg1, pl1, z1),
                                              ("render_zvals", raw3, b3, sg3, pl3, z_f)):
                require(bool(torch.isfinite(raw).all()), f"modes_check {kname}: non-finite raw")
                e_plain = rgb_sigma_err(raw, plain[kname])[:2]
                require(max(e_plain) <= K1_TOL,
                        f"modes_check {kname} {vname}: f32 raw vs plain {e_plain} > {K1_TOL}")
                require(b.dtype == torch.bfloat16 and b.shape == raw.shape,
                        f"modes_check {kname}: bf16 raw has {b.dtype} {tuple(b.shape)}")
                rel = ((b.float() - raw).abs() / raw.abs().clamp_min(1e-30)).max().item()
                bf16_exact = torch.equal(b, raw.bfloat16())
                want_sg, want_pl = render_kernel.planes_of(raw)
                planes_equal = torch.equal(sg, want_sg) and all(
                    torch.equal(a, c) for a, c in zip(pl, want_pl))
                out_b, w_b = composite_kernel._launch(b, zz, rd, sent, eps)
                ref_b = composite_kernel.fused_volume_render_interleaved_plain(b, zz, rd, sent, eps)
                out_p, w_p = composite_kernel._launch_planar(sg, pl, zz, rd, sent, eps)
                ref_p = composite_kernel.fused_volume_render_interleaved_plain(raw, zz, rd, sent,
                                                                               eps)
                torch.cuda.synchronize()
                e_b, e_p = composited_err(out_b, w_b, *ref_b), composited_err(out_p, w_p, *ref_p)
                emit("modes_check", kernel=kname, cuda_kernel=WGMMA[kname], variant=vname, rays=R,
                     samples=zz.shape[1], f32_raw_vs_plain_errors=e_plain, f32_raw_tol=K1_TOL,
                     f32_raw_vs_plain=agreement(raw, plain[kname]),
                     bf16_raw_max_rel_err_vs_f32_raw=rel, bf16_rounding=2.0 ** -8,
                     bf16_raw_equals_rounded_f32_raw=bf16_exact,
                     planes_bit_equal_to_deinterleaved_raw=planes_equal,
                     composite_on_bf16_raw_errors=e_b, composite_planar_on_planes_errors=e_p,
                     tol=K2_TOL)
                require(rel <= 2.0 ** -8, f"modes_check {kname}: bf16 raw {rel} from the f32 raw")
                require(planes_equal, f"modes_check {kname}: planes differ from the raw output")
                require(max(e_b) <= K2_TOL and max(e_p) <= K2_TOL,
                        f"modes_check {kname}: compositor errors {e_b}, {e_p} > {K2_TOL}")
                worst["raw_bf16"] = max(worst["raw_bf16"], rgb_sigma_err(b.float(), raw)[0],
                                        e_b[0])
                worst["planar"] = max(worst["planar"], (sg - want_sg).abs().max().item(), e_p[0])
            del raw1, raw3, b1, b3, sg1, pl1, sg3, pl3, z_f, plain
            torch.cuda.empty_cache()
        return worst

    quant_err = check_quant_kernels()
    torch.cuda.empty_cache()

    def check_one_depth():
        """K3 at one depth per ray (ROADMAP C1) on every weight route, both
        variants, in every form: each ray one row of the route's per-sample
        kernel, the composited form composited by K2. Held against K3's
        plain version (the route's tolerance), the bf16 raw and the planes
        against the float32 raw (bit-equal), the composited output against
        plain compositing of the kernel's own raw (B9_TOL). Returns the
        largest raw rgb error."""
        cfg_bm = bmild_config()
        seeded_bm = init_nerf_params(torch.Generator().manual_seed(1), cfg_bm.model, dev)
        n_check = 1001
        ro, rd = with_padding(*camera_rays(poses[0], focal, dev, n_check - 3, seed=0), 3)
        z = 2.0 + 4.0 * torch.rand(n_check, 1, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(11))
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        worst = 0.0
        for vname, mcfg, params in (("reference", cfg_ref.model, fine),
                                    ("bmild", cfg_bm.model, seeded_bm)):
            for route, bits, act_bits in (("bf16", None, None), *ROUTES):
                w = (pack_params(params, mcfg, torch.bfloat16) if bits is None
                     else quantized(params, mcfg, bits, act_bits))
                tol = K8_TOL if act_bits else QUANT_TOL if bits else K1_TOL
                before = read_counts()
                raw = render_kernel.fused_render_zvals_raw(w, ro, rd, z, mcfg)
                b16 = render_kernel.fused_render_zvals_raw(w, ro, rd, z, mcfg,
                                                           raw_dtype=torch.bfloat16)
                sg, pl = render_kernel.fused_render_zvals_planar(w, ro, rd, z, mcfg)
                out, wts = render_kernel.fused_render_zvals_composited(
                    w, ro, rd, z, mcfg, with_weights=True, sentinel=sent, eps=eps)
                weightless = composite_kernel.weightless_launches
                out0 = render_kernel.fused_render_zvals_composited(
                    w, ro, rd, z, mcfg, with_weights=False, sentinel=sent, eps=eps)
                weightless = composite_kernel.weightless_launches - weightless
                torch.cuda.synchronize()
                moved = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
                entry = "mlp_forward" if bits is None else "mlp_quant"
                require(torch.equal(out0, out) and weightless == 1,
                        f"c1_check {route} {vname}: without weights, K2 gave another output or "
                        f"was not asked for none ({weightless} launches without)")
                prologues = 5 if route in ("int8", "int16") else 0
                require(moved.get(entry) == 5 and moved.get("composite") == 2
                        and moved.get("dequant_stream", 0) == prologues
                        and not any(moved.get(k) for k in (*WGMMA, *WGMMA_COMPOSITED)),
                        f"c1_check {route} {vname}: launches {moved}, expected 5 of {entry} "
                        f"and 2 of composite, {prologues} of dequant_stream, no ray kernel")
                require(all(bool(torch.isfinite(t).all()) for t in (raw, out, wts)),
                        f"c1_check {route} {vname}: non-finite output")
                plain = render_kernel.fused_render_zvals_plain(w, ro, rd, z, mcfg)
                e_raw = rgb_sigma_err(raw, plain)[:2]
                want_sg, want_pl = render_kernel.planes_of(raw)
                planes_equal = torch.equal(sg, want_sg) and all(
                    torch.equal(a, c) for a, c in zip(pl, want_pl))
                bf16_exact = torch.equal(b16, raw.bfloat16())
                e_comp = composited_err(out, wts, *composite_kernel.fused_volume_render_interleaved_plain(
                    raw, z, rd, sent, eps))
                emit("c1_check", route=route, variant=vname, rays=n_check, samples=1,
                     entry=K4_KERNEL, library=render_kernel.kernel_library(
                         0 if bits is None else quant.route_of(w), False),
                     launches=moved, raw_vs_plain_errors=e_raw, tol=tol,
                     bf16_raw_equals_rounded_f32_raw=bf16_exact,
                     planes_bit_equal_to_deinterleaved_raw=planes_equal,
                     composited_errors=e_comp, composited_tol=B9_TOL)
                require(max(e_raw) <= tol, f"c1_check {route} {vname}: raw {e_raw} > {tol}")
                require(bf16_exact and planes_equal,
                        f"c1_check {route} {vname}: bf16 raw or planes differ from the raw")
                require(max(e_comp) <= B9_TOL,
                        f"c1_check {route} {vname}: composited {e_comp} > {B9_TOL}")
                worst = max(worst, e_raw[0])
        return worst

    c1_err = check_one_depth()
    torch.cuda.empty_cache()

    def time_quant_kernels():
        """Device ms per launch (torch.profiler) of every new kernel and route
        at the 16,384-ray chunk, beside the bf16 kernels on the same weights
        (pruned as the compressed engine prunes them); the plain versions'
        stream time; the bounds."""
        mcfg = cfg_ref.model
        pruned = prune_params(fine, 0.1)
        packed = pack_params(pruned, mcfg, torch.bfloat16)
        packed_c = pack_params(coarse, mcfg, torch.bfloat16)
        ro, rd = camera_rays(poses[1], focal, dev, CHUNK, seed=1)
        z3 = hier_depths(render_kernel, composite_kernel, sample_pdf, packed_c, ro, rd, mcfg, rcfg)
        sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
        weights = {"bf16": packed, **{r: quantized(fine, mcfg, b, a) for r, b, a in ROUTES}}
        wbytes = {r: nbytes(*[t for t in w if t is not None]) for r, w in weights.items()}
        res = {}

        def flops(n_rays, S, per_sample_dirs):
            total = (2 * mlp_macs(mcfg) * n_rays * S if per_sample_dirs
                     else k1_flops(mcfg, n_rays, S))
            return total, trunk_flops(mcfg, n_rays * S)

        def ray_bound(route, S, in_bytes, out_bytes, per_sample_dirs=False, f32_ops=0):
            total, trunk = flops(CHUNK, S, per_sample_dirs)
            if route == "int8_compute":
                return bound_ms(total - trunk, f32_ops, in_bytes + wbytes[route] + out_bytes,
                                trunk)
            return bound_ms(total, f32_ops, in_bytes + wbytes[route] + out_bytes)

        def timed(kern, name, reps, plain, bound, **more):
            """Device ms per launch by the profiler, stream ms per call by
            CUDA events (the fallback where the trace drops an event), the
            plain version's stream ms."""
            return dict(device_ms=profiled_ms(kern, name, reps), call_ms=call_ms(kern, reps),
                        plain_ms=call_ms(plain, 2) if callable(plain) else plain, bound=bound,
                        cuda_kernel=name, **more)

        comp = dict(composited=True, sentinel=sent, eps=eps)
        for route, w in weights.items():
            # the Hopper kernels on every route, raw and composited (B9, K1
            # with its weights as the hierarchical coarse pass takes them)
            wr = 0 if route == "bf16" else quant.route_of(w)
            plain = {
                "render_samples": lambda: render_kernel.fused_render_samples_plain(
                    w, ro, rd, 2.0, 6.0, SPP, mcfg),
                "render_zvals": lambda: render_kernel.fused_render_zvals_plain(w, ro, rd, z3, mcfg),
                "render_samples_composited":
                    lambda: render_kernel.fused_render_samples_composited_plain(
                        w, ro, rd, 2.0, 6.0, SPP, mcfg, sent, eps),
                "render_zvals_composited": lambda: render_kernel.fused_render_zvals_composited_plain(
                    w, ro, rd, z3, mcfg, sent, eps)}
            for name, S, kw, reps, out_bytes in (
                    ("render_samples", SPP, dict(near=2.0, far=6.0), 5, CHUNK * SPP * 16),
                    ("render_zvals", S3, dict(near=0.0, far=0.0, z_vals=z3), 3, CHUNK * S3 * 16),
                    ("render_samples_composited", SPP,
                     dict(near=2.0, far=6.0, with_weights=True, **comp), 5,
                     CHUNK * 32 + CHUNK * SPP * 4),
                    ("render_zvals_composited", S3, dict(near=0.0, far=0.0, z_vals=z3, **comp), 3,
                     CHUNK * 32)):
                res[f"{name} {route}"] = timed(
                    lambda: render_kernel._launch(w, ro, rd, S=S, cfg=mcfg, **kw),
                    {**WGMMA, **WGMMA_COMPOSITED}[name], reps, plain[name],
                    ray_bound(route, S, nbytes(ro, rd, kw.get("z_vals")), out_bytes,
                              f32_ops=20 * CHUNK * S if "composited" in name else 0),
                    library=render_kernel.kernel_library(wr, "composited" in name))
                if wr in ray_wgmma.DEQUANTIZED:     # the call's prologue, beside the kernel
                    res[f"{name} {route}"]["prologue_device_ms"] = profiled_ms(
                        lambda: render_kernel._launch(w, ro, rd, S=S, cfg=mcfg, **kw),
                        DEQUANT_KERNEL, reps)
            torch.cuda.empty_cache()
        # K4 and K7 at the uniform hierarchical frame's two chunks: the Hopper
        # kernel in the build of each route
        for S in (SPP, N_FINE):
            pos, dirs = sample_batch(CHUNK, S, seed=S)
            n = CHUNK * S
            for route, w in weights.items():
                if route == "bf16":
                    run = lambda: mlp_kernel._launch(w, pos, dirs, mcfg)
                    plain = lambda: mlp_kernel.fused_nerf_apply_plain(w, pos, dirs, mcfg)
                    key, lib_name = f"mlp_forward bf16 x{S}", ray_wgmma.LIBRARY
                else:
                    run = lambda: quant._launch(w, pos, dirs, mcfg)
                    plain = lambda: quant.quantized_nerf_apply_plain(w, pos, dirs, mcfg)
                    key = f"mlp_quant {route} x{S}"
                    lib_name = ray_wgmma.LIBRARIES[quant.route_of(w)]
                res[key] = timed(run, K4_KERNEL, 3, plain,
                                 ray_bound(route, S, nbytes(pos, dirs), n * 16, per_sample_dirs=True),
                                 library=lib_name)
                if route in ("int8", "int16"):
                    res[key]["prologue_device_ms"] = profiled_ms(run, DEQUANT_KERNEL, 3)
            del pos, dirs
            torch.cuda.empty_cache()
        # the dequantize routes' prologue alone, on the ray stream (bytes)
        for route in ("int8", "int16"):
            w = weights[route]
            s_q = ray_wgmma.stream_for(w, mcfg)
            q_cpu = type(w)(*[None if t is None else t.cpu() for t in w])
            one = dequant_stream.dequant_stream(w, s_q, mcfg)
            res[f"dequant_stream {route}"] = timed(
                lambda: dequant_stream.dequant_stream(w, s_q, mcfg), DEQUANT_KERNEL, 50,
                lambda: dequant_stream.dequant_stream_plain(q_cpu, s_q.cpu(), mcfg),
                bound_ms(0, 0, nbytes(s_q, *one, *[getattr(w, f"{n}_{x}") for n in
                                                    ("wsig", "wc1", "wdir") for x in "qs"])),
                launch_floor_ms=k2_ab.launch_floor_ms())
            del one
        # the raw output forms of K1/K3 on bf16 weights, and K2 on a bf16 raw
        raw_b, z = render_kernel.fused_render_samples(packed, ro, rd, 2.0, 6.0, SPP, mcfg, raw=True,
                                                      raw_dtype=torch.bfloat16)
        raw3_b = render_kernel.fused_render_zvals_raw(packed, ro, rd, z3, mcfg,
                                                      raw_dtype=torch.bfloat16)
        out8 = torch.empty(CHUNK, 8, device=dev)
        for form, kw, out_bytes in (("raw_bf16", dict(raw_dtype=torch.bfloat16), 8),
                                    ("planar", dict(planar=True), 16)):
            res[f"render_samples {form}"] = timed(
                lambda: render_kernel._launch(packed, ro, rd, 2.0, 6.0, SPP, mcfg, **kw),
                WGMMA["render_samples"], 5, res["render_samples bf16"]["plain_ms"],
                ray_bound("bf16", SPP, nbytes(ro, rd), CHUNK * SPP * out_bytes))
            res[f"render_zvals {form}"] = timed(
                lambda: render_kernel._launch(packed, ro, rd, 0.0, 0.0, S3, mcfg, z_vals=z3, **kw),
                WGMMA["render_zvals"], 3, res["render_zvals bf16"]["plain_ms"],
                ray_bound("bf16", S3, nbytes(ro, rd, z3), CHUNK * S3 * out_bytes))
        # K2 on a bf16 raw as the bf16-raw frames call it: with the weights at
        # 64 (the coarse pass), without at 192 (the fine pass)
        for name, raw, zz, S, with_w in (("composite raw_bf16 x64", raw_b, z, SPP, True),
                                         ("composite raw_bf16 x192", raw3_b, z3, S3, False)):
            w_out = torch.empty(CHUNK, S, device=dev) if with_w else None
            raw_f = raw.float()
            res[name] = timed(
                lambda: composite_kernel._launch(raw, zz, rd, sent, eps, with_w), K2_KERNEL, 20,
                lambda: composite_kernel.fused_volume_render_interleaved_plain(raw, zz, rd, sent,
                                                                               eps),
                bound_ms(0, 20 * CHUNK * S, nbytes(raw, zz, rd, out8, w_out)),
                with_weights=with_w,
                f32_raw_device_ms=profiled_ms(lambda: composite_kernel._launch(
                    raw_f, zz, rd, sent, eps, with_w), K2_KERNEL, 20),
                f32_raw_call_ms=call_ms(lambda: composite_kernel._launch(raw_f, zz, rd, sent, eps,
                                                                         with_w), 20))
        k2_bf16 = time_k2(torch.bfloat16)
        emit("kernel_times_quant", rays=CHUNK, samples={"render_samples": SPP, "render_zvals": S3,
                                                        "render_samples_composited": SPP,
                                                        "render_zvals_composited": S3,
                                                        "mlp x64": SPP, "mlp x128": N_FINE},
             weights="final_params.npz fine, pruned 10% (the bf16 rows too)",
             times={k: {**{kk: vv for kk, vv in v.items() if kk != "bound"},
                        "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                    for k, v in res.items()},
             int8_peak="1,979 TOP/s for the trunk products of the int8_compute rows, "
                       "989 TFLOP/s bf16 for the rest", k2_bf16=k2_bf16,
             launch_floor_ms=k2_ab.launch_floor_ms(), nvidia_smi=smi)
        return res, k2_bf16

    quant_times, k2_bf16 = time_quant_kernels()
    torch.cuda.empty_cache()

    per_frame = math.ceil(W * H / CHUNK)
    shared = SharedModel(cfg_ref, dev).load(PARAMS)
    ref_engine = TorchEngine(SharedModel(f32(cfg_ref), dev).load(PARAMS), chunk_rays=CHUNK)
    qw, qh = 200, 150
    qfocal = focal_from_angle(qw, CAMERA_ANGLE_X)
    paths = {}            # path -> launches by kernel over its timed frames

    def drive(engine, mode, name, expect, views=3, spp=SPP, weightless=None):
        """One warm frame, then the path: counts set to 0, ``views`` views,
        counts read. Requires ``expect[kernel]`` launches per chunk of every
        kernel (0 for the kernels the path must not run), and, where
        ``weightless`` is given, that many of K2's per chunk without weights."""
        engine.render_image(poses[0], (W, H), spp, focal=focal, mode=mode, monitor=True)
        reset_counts()
        frames = [engine.render_image(p, (W, H), spp, focal=focal, mode=mode, monitor=True)
                  for p in poses[1:1 + views]]
        counts = read_counts()
        paths[name] = counts
        for k, n in counts.items():
            want = expect.get(k, 0) * per_frame * len(frames)
            require(n == want, f"{name}: {k} launched {n} times, expected {want} "
                    f"({expect.get(k, 0) * per_frame} per frame x {len(frames)} frames)")
        if weightless is not None:
            n = composite_kernel.weightless_launches
            want = weightless * per_frame * len(frames)
            require(n == want, f"{name}: K2 launched {n} times without weights, expected {want}")
        wall = float(np.median([f.stats.wall_time_s for f in frames]))
        img = frames[0].rgb
        corners = np.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
        require(all(np.isfinite(f.rgb).all() and np.isfinite(f.depth).all() for f in frames),
                f"{name}: non-finite frame")
        require(corners.min() > 0.99 and img.std() > 0.05,
                f"{name} looks degenerate: corners {corners.min()}, std {img.std()}")
        return dict(resolution=[W, H], views=len(frames), ms_per_frame=wall * 1e3,
                    rays_per_s=W * H / wall,
                    peak_device_mb=max(f.stats.peak_device_mb for f in frames),
                    launches=counts,
                    expected_per_frame={k: v * per_frame for k, v in expect.items()},
                    rgb_mean=float(img.mean()),
                    rgb_std=float(img.std()), corner_min=float(corners.min()), nvidia_smi=smi)

    def against_torch(engine, mode, ref_rgb):
        a = engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal, mode=mode,
                                monitor=False).rgb
        return psnr(a, ref_rgb), float(np.abs(a - ref_rgb).max())

    def frame_profile(engine, mode, expect, spp=SPP):
        """Where one frame's device time goes; each kernel's device ms per
        launch is its total over the frame's launches (``expect``: launches
        per chunk by CUDA kernel name)."""
        traced, us, n = profile_frame(lambda: engine.render_image(
            poses[2], (W, H), spp, focal=focal, mode=mode, monitor=True))
        frame_ms = traced.stats.wall_time_s * 1e3
        busy_ms = sum(us.values()) / 1e3
        per_launch = {k: us[k] / n[k] / 1e3 for k in expect if n.get(k) == per_frame * expect[k]}
        return per_launch, dict(frame_ms=frame_ms, device_busy_ms=busy_ms,
                                device_idle_share=1.0 - busy_ms / frame_ms,
                                device_ms_by_kernel={k: v / 1e3 for k, v in
                                                     sorted(us.items(), key=lambda kv: -kv[1])},
                                launches_by_kernel=n, device_ms_per_launch=per_launch)

    device_ms = {}       # launch counter -> device ms per launch (profiler)

    # -- path 1: the benchmark frame (K1 -> K2) -------------------------------
    engine = CudaEngine(shared, chunk_rays=CHUNK)
    frame_res = drive(engine, "benchmark", "benchmark",
                      {"render_samples": 1, "composite": 1}, weightless=1)
    emit("frame", mode="benchmark", samples=SPP, **frame_res)
    per_launch, prof = frame_profile(engine, "benchmark",
                                     {WGMMA["render_samples"]: 1, K2_KERNEL: 1})
    emit("frame_profile", mode="benchmark", **prof)
    device_ms["render_samples"] = per_launch.get(WGMMA["render_samples"])
    device_ms["composite"] = per_launch.get(K2_KERNEL)
    ref_bench = ref_engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal,
                                        monitor=False).rgb
    p_db, p_err = against_torch(engine, "benchmark", ref_bench)
    emit("frame_vs_torch_f32", resolution=[qw, qh], samples=SPP, psnr_db=p_db, min_db=PSNR_MIN,
         floor_db=PSNR_FLOOR["benchmark"], max_abs_err=p_err)
    require(p_db >= max(PSNR_MIN, PSNR_FLOOR["benchmark"]),
            f"frame PSNR {p_db} dB against the float32 torch engine")

    # -- path 2: the hierarchical frame (K1 -> K2 -> sample_pdf -> K3 -> K2) ---
    emit("hier_frame", mode="hierarchical", samples=[SPP, N_FINE], **drive(
        engine, "hierarchical", "hierarchical",
        {"render_samples": 1, "composite": 2, "render_zvals": 1}, weightless=1))
    per_launch, prof = frame_profile(engine, "hierarchical",
                                     {WGMMA["render_samples"]: 1, K2_KERNEL: 2,
                                      WGMMA["render_zvals"]: 1})
    emit("hier_frame_profile", mode="hierarchical", **prof)
    device_ms["render_zvals"] = per_launch.get(WGMMA["render_zvals"])
    ref_hier = ref_engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal,
                                       mode="hierarchical", monitor=False).rgb
    p_db, p_err = against_torch(engine, "hierarchical", ref_hier)
    extra = {}
    if p_db < PSNR_MIN:
        # separate the kernels' error from bf16 coarse weights moving the
        # fine depths: the same frame from the bf16 plain engine
        bf16_ref = TorchEngine(shared, chunk_rays=CHUNK).render_image(
            poses[1], (qw, qh), SPP, focal=qfocal, mode="hierarchical", monitor=False).rgb
        extra["psnr_db_vs_torch_bf16"], _ = against_torch(engine, "hierarchical", bf16_ref)
    emit("hier_vs_torch_f32", resolution=[qw, qh], samples=[SPP, N_FINE], psnr_db=p_db,
         min_db=PSNR_MIN, floor_db=PSNR_FLOOR["hierarchical"], max_abs_err=p_err, **extra)
    require(p_db >= max(PSNR_MIN, PSNR_FLOOR["hierarchical"]),
            f"hierarchical PSNR {p_db} dB against the float32 torch engine")

    # -- path 3: fuse_composite=True in both modes (the composited K1/K3 on
    #    the Hopper body; the profile shows the kernels by name)
    fused = CudaEngine(shared, chunk_rays=CHUNK, fuse_composite=True)
    fused_res = {}
    for mode, expect, ref_rgb in (
            ("benchmark", {"render_samples_composited": 1}, ref_bench),
            ("hierarchical", {"render_samples_composited": 1, "render_zvals_composited": 1},
             ref_hier)):
        res = drive(fused, mode, f"fused_{mode}", expect)
        res["psnr_db"], res["max_abs_err"] = against_torch(fused, mode, ref_rgb)
        require(res["psnr_db"] >= PSNR_MIN,
                f"fused {mode} PSNR {res['psnr_db']} dB against the float32 torch engine")
        per_launch, res["profile"] = frame_profile(
            fused, mode, {WGMMA_COMPOSITED[k]: 1 for k in expect if k in WGMMA_COMPOSITED})
        for k, v in per_launch.items():
            device_ms[f"fused_{mode} {k}"] = v
        fused_res[mode] = res
    emit("fused_frames", min_db=PSNR_MIN, psnr_resolution=[qw, qh], **fused_res, nvidia_smi=smi)
    # the hierarchical frame's: K1 with its weights, as the row's shape says
    for k, cuda_name in WGMMA_COMPOSITED.items():
        device_ms[k] = device_ms.get(f"fused_hierarchical {cuda_name}")

    # -- path 4: the uniform hierarchical frame (render_rays on K4 + K6) -------
    uniform = lambda c: dataclasses.replace(
        c, render=dataclasses.replace(c.render, use_importance=False))
    engine_u = CudaEngine(SharedModel(uniform(cfg_ref), dev).load(PARAMS), chunk_rays=CHUNK)
    res_u = drive(engine_u, "hierarchical", "uniform_hierarchical",
                  {"mlp_forward": 2, "composite_planar": 2})
    per_launch, prof = frame_profile(engine_u, "hierarchical",
                                     {K4_KERNEL: 2, "composite_planar_kernel": 2})
    device_ms["uniform mlp_forward"] = per_launch.get(K4_KERNEL)
    ref_u = TorchEngine(SharedModel(uniform(f32(cfg_ref)), dev).load(PARAMS),
                        chunk_rays=CHUNK).render_image(
        poses[1], (qw, qh), SPP, focal=qfocal, mode="hierarchical", monitor=False).rgb
    res_u["psnr_db"], res_u["max_abs_err"] = against_torch(engine_u, "hierarchical", ref_u)
    emit("uniform_hier_frame", mode="hierarchical", use_importance=False,
         samples=[SPP, N_FINE], min_db=PSNR_MIN, psnr_resolution=[qw, qh], **res_u, profile=prof)
    require(res_u["psnr_db"] >= PSNR_MIN,
            f"uniform hierarchical PSNR {res_u['psnr_db']} dB against the float32 torch engine")

    # -- path 5: the compressed and int8-compute engines -----------------------
    # both modes on int8 weights (K1/K3 dequantizing in the kernel, or on the
    # int8-compute route), the uniform hierarchical mode (K7 + K6), and the
    # benchmark mode on int16 weights. PSNR against the float32 TorchEngine
    # (limits: PSNR_MIN for the dequantize routes, PSNR_MIN_INT8 for int8
    # compute) and against CudaEngine on the unquantized weights
    cuda_small = {"benchmark": engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal,
                                                   monitor=False).rgb,
                  "hierarchical": engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal,
                                                      mode="hierarchical", monitor=False).rgb,
                  "uniform_hierarchical": engine_u.render_image(
                      poses[1], (qw, qh), SPP, focal=qfocal, mode="hierarchical",
                      monitor=False).rgb}
    torch_small = {"benchmark": ref_bench, "hierarchical": ref_hier,
                   "uniform_hierarchical": ref_u}
    shared_u = SharedModel(uniform(cfg_ref), dev).load(PARAMS)

    def quant_frames(phase, cls, route_key, min_db, **kw):
        """Drive one quantized engine class through its modes."""
        res = {}
        k7_int8 = {"mlp_quant_int8": 2} if route_key == "int8" else {}
        # on the dequantize route every K1/K3/K7 call runs dequant_stream first
        prologue = lambda n: {"dequant_stream": n} if route_key == "dequant" else {}
        for path, eng, mode, expect, views in (
                ("benchmark", cls(shared, chunk_rays=CHUNK, **kw), "benchmark",
                 {"render_samples": 1, "composite": 1, route_key: 1, **prologue(1)}, 3),
                ("hierarchical", cls(shared, chunk_rays=CHUNK, **kw), "hierarchical",
                 {"render_samples": 1, "render_zvals": 1, "composite": 2, route_key: 2,
                  **prologue(2)}, 3),
                ("fused_benchmark", cls(shared, chunk_rays=CHUNK, fuse_composite=True, **kw),
                 "benchmark", {"render_samples_composited": 1, route_key: 1, **prologue(1)}, 2),
                ("fused_hierarchical", cls(shared, chunk_rays=CHUNK, fuse_composite=True, **kw),
                 "hierarchical", {"render_samples_composited": 1, "render_zvals_composited": 1,
                                  route_key: 2, **prologue(2)}, 2),
                ("uniform_hierarchical", cls(shared_u, chunk_rays=CHUNK, **kw), "hierarchical",
                 {"mlp_quant": 2, "composite_planar": 2, **k7_int8, **prologue(2)}, 2)):
            r = drive(eng, mode, f"{phase}_{path}", expect, views)
            small = eng.render_image(poses[1], (qw, qh), SPP, focal=qfocal, mode=mode,
                                     monitor=False).rgb
            ref = path.replace("fused_", "")       # the fused frames: the same frames' references
            r["psnr_db_vs_torch_f32"] = psnr(small, torch_small[ref])
            r["max_abs_err_vs_torch_f32"] = float(np.abs(small - torch_small[ref]).max())
            r["psnr_db_vs_cuda_engine"] = psnr(small, cuda_small[ref])
            r["max_abs_err_vs_cuda_engine"] = float(np.abs(small - cuda_small[ref]).max())
            require(r["psnr_db_vs_torch_f32"] >= min_db and r["psnr_db_vs_cuda_engine"] >= min_db,
                    f"{phase} {path}: PSNR {r['psnr_db_vs_torch_f32']} dB against the float32 "
                    f"torch engine, {r['psnr_db_vs_cuda_engine']} dB against CudaEngine "
                    f"(limit {min_db})")
            if path == "hierarchical":
                per_launch, r["profile"] = frame_profile(
                    eng, mode, {WGMMA["render_samples"]: 1, WGMMA["render_zvals"]: 1,
                                K2_KERNEL: 2, **({DEQUANT_KERNEL: 2} if prologue(1) else {})})
                for k, v in per_launch.items():
                    device_ms[f"{phase} {k}"] = v
            elif path == "fused_hierarchical":
                per_launch, r["profile"] = frame_profile(
                    eng, mode, {k: 1 for k in WGMMA_COMPOSITED.values()})
                for k, v in per_launch.items():
                    device_ms[f"{phase} fused {k}"] = v
            elif path == "uniform_hierarchical":
                per_launch, r["profile"] = frame_profile(
                    eng, mode, {K4_KERNEL: 2, "composite_planar_kernel": 2})
                device_ms[f"{phase} uniform {K4_KERNEL}"] = per_launch.get(K4_KERNEL)
            res[path] = r
            stats = eng.compression_stats()
        emit(phase, min_db=min_db, psnr_resolution=[qw, qh], compression_stats=stats,
             weights_in_global_memory=str(eng.engine_params()["fine"].wt_q.dtype), **res)
        return res

    quant_frames("compressed_frames", CompressedEngine, "dequant", PSNR_MIN)
    quant_frames("int8_frames", Int8ComputeEngine, "int8", PSNR_MIN_INT8)
    eng16 = CompressedEngine(shared, chunk_rays=CHUNK, bits=16)
    res16 = drive(eng16, "benchmark", "compressed16_benchmark",
                  {"render_samples": 1, "composite": 1, "dequant": 1, "dequant_stream": 1}, 2)
    res16["psnr_db_vs_torch_f32"], res16["max_abs_err_vs_torch_f32"] = against_torch(
        eng16, "benchmark", ref_bench)
    emit("compressed16_frame", min_db=PSNR_MIN, psnr_resolution=[qw, qh],
         compression_stats=eng16.compression_stats(), **res16)
    require(res16["psnr_db_vs_torch_f32"] >= PSNR_MIN,
            f"compressed16 PSNR {res16['psnr_db_vs_torch_f32']} dB against the float32 engine")

    # -- path 6: the raw output forms of K1/K3 in the hierarchical mode ---------
    mode_res = {}
    for key, eng, expect in (
            ("raw_bf16", CudaEngine(shared, chunk_rays=CHUNK, raw_dtype="bfloat16"),
             {"render_samples": 1, "render_zvals": 1, "composite": 2, "raw_bf16": 2,
              "composite_bf16": 2}),
            ("planar", CudaEngine(shared, chunk_rays=CHUNK, planar=True),
             {"render_samples": 1, "render_zvals": 1, "planar": 2, "composite_planar": 2})):
        r = drive(eng, "hierarchical", f"{key}_hierarchical", expect, 2)
        r["psnr_db"], r["max_abs_err"] = against_torch(eng, "hierarchical", ref_hier)
        small = eng.render_image(poses[1], (qw, qh), SPP, focal=qfocal, mode="hierarchical",
                                 monitor=False).rgb
        r["max_abs_err_vs_cuda_engine"] = float(np.abs(small - cuda_small["hierarchical"]).max())
        require(r["psnr_db"] >= PSNR_MIN,
                f"{key} hierarchical PSNR {r['psnr_db']} dB against the float32 torch engine")
        mode_res[key] = r
    # the planes carry the raw output's values, so the planar frame is the
    # interleaved one up to K6's against K2's summation (1e-7 on the coarse
    # weights, which sample_pdf can turn into 1e-4 of a drawn depth)
    require(mode_res["planar"]["max_abs_err_vs_cuda_engine"] <= 1e-3,
            f"planar frame differs from the interleaved one by "
            f"{mode_res['planar']['max_abs_err_vs_cuda_engine']}")
    emit("mode_frames", min_db=PSNR_MIN, psnr_resolution=[qw, qh], **mode_res)

    # -- path: fused_render_zvals, K3 differentiable in the weights
    zv_res = render_zvals_phase(dev, smi, paths, poses, focal, cfg_ref, fine, coarse)

    # -- path 7: the accel engine (benchmark mode: the occupancy grid, baked
    #    once through K4 in the first frame's untimed warm frame, places the
    #    depths; K3 -> K2, or the composited K3), and beside it the uniform
    #    benchmark frame at the same sample counts
    mcfg = cfg_ref.model
    acc = AccelEngine(shared, chunk_rays=CHUNK)
    grid_res = acc.grid_resolution
    bake_launches = -(-grid_res ** 3 // BAKE_CHUNK)
    reset_counts()
    acc.render_image(poses[0], (W, H), ACCEL_SPP[0], focal=focal, monitor=True)
    paths["accel_first_frame"] = first = read_counts()
    require(first["mlp_forward"] == bake_launches and first["render_zvals"] == 2 * per_frame
            and first["composite"] == 2 * per_frame and first["occupancy"] == 2 * per_frame
            and first["render_samples"] == 0,
            f"accel: the first frame (warm + timed) launched {first}, expected "
            f"{bake_launches} of K4 (the bake) and {2 * per_frame} of the depths kernel, K3 "
            f"and K2")

    def bake():
        """A fresh accel engine's bake, between two synchronize fences:
        (grid, wall ms)."""
        eng = AccelEngine(shared, chunk_rays=CHUNK)
        eng.engine_params()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = eng.occupancy_grid()
        torch.cuda.synchronize()
        return grid, (time.perf_counter() - t0) * 1e3

    _, bake_wall_ms = bake()
    (_, bake_wall_profiled_ms), us_b, n_b = profile_frame(bake)
    # the grid at full resolution through K4, against K4's plain version in
    # bf16 and against the float32 apply_nerf, both on the card
    packed_f = acc.engine_params()["fine"]
    plain_k4 = lambda p, x, d, cfg, compute_dtype=None: (
        lambda o: (o[:, 0], o[:, 1:4]))(mlp_kernel.fused_nerf_apply_plain(p, x, d, cfg))
    dens = {name: occupancy.build_occupancy_grid(
                p, mcfg, resolution=grid_res, aabb=acc.aabb, apply_fn=fn,
                compute_dtype=torch.float32, store="density").occupancy
            for name, p, fn in (("k4", packed_f, mlp_kernel.make_cuda_apply_fn(torch.bfloat16)),
                                ("k4_plain", packed_f, plain_k4),
                                ("apply_nerf_f32", fine, apply_nerf))}
    th = acc.density_threshold
    scale = dens["apply_nerf_f32"].max().item()
    e_plain = (dens["k4"] - dens["k4_plain"]).abs().max().item() / scale
    e_f32 = (dens["k4"] - dens["apply_nerf_f32"]).abs().max().item() / scale
    occupied = int((dens["apply_nerf_f32"] > th).sum())
    flips = int(((dens["k4"] > th) != (dens["apply_nerf_f32"] > th)).sum())
    grid = acc.occupancy_grid()
    emit("accel_bake", grid_resolution=grid_res, store=acc.grid_store,
         points=grid_res ** 3, k4_launches=n_b.get(K4_KERNEL), expected_k4_launches=bake_launches,
         k4_launches_in_first_frame=first["mlp_forward"],
         device_ms=sum(us_b.values()) / 1e3, k4_device_ms=us_b.get(K4_KERNEL, 0.0) / 1e3,
         device_ms_by_kernel={k: v / 1e3 for k, v in sorted(us_b.items(), key=lambda kv: -kv[1])},
         wall_ms=bake_wall_ms, wall_ms_profiled=bake_wall_profiled_ms,
         occupied_share=(dens["k4"] > th).float().mean().item(), threshold=th,
         probe_grid_resolution=grid.resolution,
         probe_grid_occupied_share=(grid.occupancy > th).float().mean().item(),
         max_sigma=scale, k4_vs_plain_max_rel=e_plain, k4_vs_plain_tol=K1_TOL,
         k4_vs_apply_nerf_f32_max_rel=e_f32, k4_vs_f32_tol=BAKE_F32_TOL,
         binary_flips_vs_f32=flips, occupied_cells_f32=occupied, flips_tol=BAKE_FLIPS,
         sigma_finite=bool(torch.isfinite(dens["k4"]).all()), nvidia_smi=smi)
    require(n_b.get(K4_KERNEL) == bake_launches, f"accel bake: {n_b.get(K4_KERNEL)} K4 launches")
    require(bool(torch.isfinite(dens["k4"]).all()), "accel bake: non-finite sigma")
    require(e_plain <= K1_TOL, f"accel bake: K4 vs its plain version {e_plain} > {K1_TOL}")
    require(e_f32 <= BAKE_F32_TOL and flips <= BAKE_FLIPS * occupied,
            f"accel bake: K4 vs float32 apply_nerf {e_f32}, {flips} flips of {occupied}")
    del dens

    # the depths kernel on the card against the plain version on the CPU, at
    # the first chunk of a frame (scanline order, as the engine's groups
    # are), each call one launch; every sample count, weight mode and stride
    # (the binary grid for the occupancy weights); the stochastic form
    # against the plain version on the card from the same generator state
    ro_f, rd_f = generate_rays(poses[1], W, H, focal, dev)
    ro_f, rd_f = ro_f.reshape(-1, 3)[:CHUNK].contiguous(), rd_f.reshape(-1, 3)[:CHUNK].contiguous()
    binary = grid._replace(occupancy=(grid.occupancy > th).float())
    on_cpu = lambda g: occupancy.OccupancyGrid(g.occupancy.cpu(), g.aabb_lo.cpu(),
                                               g.aabb_hi.cpu(), g.resolution)
    grid_cpu, binary_cpu = on_cpu(grid), on_cpu(binary)
    lib = occupancy.load()
    require(lib.occupancy_max_probes() == occupancy.MAX_PROBES
            and lib.occupancy_max_sorted() == occupancy.MAX_SORTED,
            "the depths kernel's limits differ from ops/occupancy.py's")
    z_err = {}

    def depths_err(zc, zp, key, n_launches):
        zc = zc.cpu()
        e = dict(max_abs=(zc - zp.cpu()).abs().max().item(),
                 share_equal=(zc == zp.cpu()).float().mean().item(),
                 sorted=bool((zc[:, 1:] >= zc[:, :-1]).all()), launches=n_launches)
        z_err[key] = e
        require(e["max_abs"] <= Z_TOL and e["sorted"] and n_launches == 1,
                f"accel depths {key}: kernel vs plain {e}")

    for spp in ACCEL_SPP:
        for mode in occupancy.WEIGHT_MODES:
            for stride in (1, 4):
                g_card, g_cpu = (binary, binary_cpu) if mode == "occupancy" else (grid, grid_cpu)
                kw = dict(n_probe=acc.n_probe, ray_stride=stride, weight_mode=mode)
                before = occupancy.launches
                zc = occupancy.grid_guided_z_vals(g_card, ro_f, rd_f, rcfg.near, rcfg.far, spp,
                                                  **kw)
                n_launches = occupancy.launches - before
                zp = occupancy.grid_guided_z_vals(g_cpu, ro_f.cpu(), rd_f.cpu(), rcfg.near,
                                                  rcfg.far, spp, **kw)
                depths_err(zc, zp, f"{spp} {mode} stride {stride}", n_launches)
                gen = lambda: torch.Generator(device=dev).manual_seed(spp * 10 + stride)
                before = occupancy.launches
                zc = occupancy.grid_guided_z_vals(g_card, ro_f, rd_f, rcfg.near, rcfg.far, spp,
                                                  generator=gen(), **kw)
                n_launches = occupancy.launches - before
                zp = occupancy.grid_guided_z_vals_plain(g_card, ro_f, rd_f, rcfg.near, rcfg.far,
                                                        spp, generator=gen(), **kw)
                depths_err(zc, zp, f"{spp} {mode} stride {stride} drawn", n_launches)
    # its time at the engine's settings and the frame's sample count (32, as
    # ref-accel32), against the least bytes it must move: the depths out, the
    # leader rays in, each grid cell the probes reach once
    kw = dict(n_probe=acc.n_probe, ray_stride=acc.probe_ray_stride, weight_mode=acc.weight_mode)
    spp = ACCEL_SPP[1]
    depths = lambda: occupancy.grid_guided_z_vals(grid, ro_f, rd_f, rcfg.near, rcfg.far, spp,
                                                  **kw)
    plain_card = lambda: occupancy.grid_guided_z_vals_plain(grid, ro_f, rd_f, rcfg.near,
                                                            rcfg.far, spp, **kw)
    step = acc.probe_ray_stride
    t_p = (torch.arange(acc.n_probe, device=dev, dtype=torch.float32) + 0.5) / acc.n_probe
    pts = (ro_f[::step, None, :] + rd_f[::step, None, :]
           * (rcfg.near + (rcfg.far - rcfg.near) * t_p)[None, :, None])
    cell = torch.floor((pts - grid.aabb_lo) / (grid.aabb_hi - grid.aabb_lo) * grid.resolution)
    inside = ((cell >= 0) & (cell < grid.resolution)).all(dim=-1)
    flat = ((cell[..., 0] * grid.resolution + cell[..., 1]) * grid.resolution
            + cell[..., 2])[inside]
    cells = int(torch.unique(flat).numel())
    depth_bytes = CHUNK * spp * 4 + ro_f[::step].numel() * 4 * 2 + cells * 4
    occ_bound = bound_ms(0, 0, depth_bytes)
    occ_times = dict(device_ms=profiled_ms(depths, OCC_KERNEL, 20), call_ms=call_ms(depths, 20),
                     plain_call_ms=call_ms(plain_card, 20), bytes=depth_bytes, cells_read=cells,
                     bound_ms=occ_bound[0], bound_by=occ_bound[1])
    _, us_p, n_p = profile_frame(plain_card)
    occ_times.update(plain_device_ms=sum(us_p.values()) / 1e3, plain_launches=sum(n_p.values()))
    emit("accel_depths", rays=CHUNK, n_probe=acc.n_probe, ray_stride=acc.probe_ray_stride,
         weight_mode=acc.weight_mode, kernel_vs_plain=z_err, tol=Z_TOL,
         times={"samples": spp, "shape": f"{CHUNK} rays, {acc.n_probe} probes, stride "
                f"{acc.probe_ray_stride}, {acc.weight_mode} weights, {spp} depths", **occ_times},
         nvidia_smi=smi)

    # the frames, the profile of each, and their quality against float32
    # truth at 256 uniform samples (the JAX suite's gt_quality_report): the
    # accel frame and the uniform cuda frame at the same sample count; and
    # the accel frame against the same engine's plain versions on the CPU,
    # on a copy of the card's grid
    truth = TorchEngine(SharedModel(f32(cfg_ref), dev).load(PARAMS),
                        chunk_rays=4096).render_image(poses[1], (qw, qh), TRUTH_SPP, focal=qfocal,
                                                      monitor=False).rgb
    acc_cpu = AccelEngine(SharedModel(cfg_ref, "cpu").load(PARAMS), chunk_rays=CHUNK)
    acc_cpu._grid = grid_cpu
    accel_res, accel_small = {}, {}
    for spp in ACCEL_SPP:
        r = drive(acc, "benchmark", f"accel_{spp}",
                  {"occupancy": 1, "render_zvals": 1, "composite": 1}, spp=spp,
                  weightless=1)
        per_launch, prof = frame_profile(acc, "benchmark",
                                         {WGMMA["render_zvals"]: 1, K2_KERNEL: 1, OCC_KERNEL: 1},
                                         spp)
        glue = {k: v for k, v in prof["device_ms_by_kernel"].items()
                if k not in (WGMMA["render_zvals"], K2_KERNEL, OCC_KERNEL)}
        r.update(profile=prof, k3_device_ms_per_launch=per_launch.get(WGMMA["render_zvals"]),
                 depths_device_ms_per_launch=per_launch.get(OCC_KERNEL),
                 glue_device_ms=sum(glue.values()), glue_device_ms_by_kernel=glue)
        device_ms[f"accel_{spp} render_zvals"] = per_launch.get(WGMMA["render_zvals"])
        u = drive(engine, "benchmark", f"uniform_{spp}",
                  {"render_samples": 1, "composite": 1}, spp=spp)
        small = {name: eng.render_image(poses[1], (qw, qh), spp, focal=qfocal,
                                        monitor=False).rgb
                 for name, eng in (("accel", acc), ("uniform", engine), ("plain", acc_cpu))}
        accel_small[spp] = small["accel"]
        r["psnr_db_vs_truth"], u["psnr_db_vs_truth"] = (psnr(small["accel"], truth),
                                                        psnr(small["uniform"], truth))
        r["psnr_db_vs_plain"] = psnr(small["accel"], small["plain"])
        r["max_abs_err_vs_plain"] = float(np.abs(small["accel"] - small["plain"]).max())
        r["uniform"] = {k: u[k] for k in ("ms_per_frame", "rays_per_s", "peak_device_mb",
                                          "psnr_db_vs_truth")}
        r["accel_minus_uniform_db"] = r["psnr_db_vs_truth"] - u["psnr_db_vs_truth"]
        accel_res[spp] = r
        require(r["psnr_db_vs_plain"] >= PSNR_MIN,
                f"accel at spp {spp}: {r['psnr_db_vs_plain']} dB against its plain versions")
        require(r["accel_minus_uniform_db"] >= -ACCEL_DB_MARGIN,
                f"accel at spp {spp}: {r['psnr_db_vs_truth']} dB against the truth, uniform "
                f"{u['psnr_db_vs_truth']} dB")
    accf = AccelEngine(shared, chunk_rays=CHUNK, fuse_composite=True)
    spp = ACCEL_SPP[-1]
    rf = drive(accf, "benchmark", f"accel_fused_{spp}",
               {"occupancy": 1, "render_zvals_composited": 1}, spp=spp)
    per_launch, rf["profile"] = frame_profile(
        accf, "benchmark", {WGMMA_COMPOSITED["render_zvals_composited"]: 1}, spp)
    rf["k3_composited_device_ms_per_launch"] = per_launch.get(
        WGMMA_COMPOSITED["render_zvals_composited"])
    small = accf.render_image(poses[1], (qw, qh), spp, focal=qfocal, monitor=False).rgb
    rf["psnr_db_vs_truth"] = psnr(small, truth)
    rf["psnr_db_vs_accel_raw"] = psnr(small, accel_small[spp])
    require(rf["psnr_db_vs_accel_raw"] >= PSNR_MIN,
            f"fused accel at spp {spp}: {rf['psnr_db_vs_accel_raw']} dB against the raw one")
    emit("accel_frames", scene="procedural sphere (final_params.npz)", truth_spp=TRUTH_SPP,
         psnr_resolution=[qw, qh], db_margin=ACCEL_DB_MARGIN, min_db_vs_plain=PSNR_MIN,
         grid_resolution=grid_res,
         probe_grid_resolution=grid.resolution, n_probe=acc.n_probe,
         ray_stride=acc.probe_ray_stride, weight_mode=acc.weight_mode, grid_store=acc.grid_store,
         frames=accel_res, fused=rf, nvidia_smi=smi)
    k3_bounds = {spp: bound_ms(k1_flops(mcfg, CHUNK, spp), 0,
                               CHUNK * (6 + spp) * 4 + nbytes(*[t for t in packed_f if t is not None])
                               + CHUNK * spp * 16)[0] for spp in ACCEL_SPP}
    del engine_u, engine, fused, ref_engine, eng16, shared_u, acc, accf, acc_cpu, grid, grid_cpu
    del binary, binary_cpu
    torch.cuda.empty_cache()

    # -- path 8: training (NeRFTrainer: K4 + K5 twice a step) ------------------
    train_hw = (200, 200)
    ds = make_procedural_dataset(n_views=8, img_wh=train_hw)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # TrainConfig's defaults but the seed: the density head is ReLU'd, and from
    # the default seed the fine network starts with a density of 0 on every
    # sample, where no gradient reaches it (the train_default_seed phase
    # records that run). About half of all seeds start a network so, in the
    # JAX package too (its own default seed starts with a dead coarse
    # network; tests/test_torch_train.py); from TRAIN_SEED both start alive
    tcfg = white(default_config())
    tcfg = dataclasses.replace(tcfg, checkpoint_dir=ckpt_dir,
                               train=dataclasses.replace(tcfg.train, seed=TRAIN_SEED))
    require(tcfg.train.n_rays == TRAIN_RAYS and tcfg.train.compute_dtype == "bfloat16"
            and tcfg.render.perturb and (tcfg.render.n_coarse, tcfg.render.n_fine) == (SPP, N_FINE),
            "the training phase assumes the default TrainConfig")

    def run_steps(trainer, n_steps):
        """``n_steps`` single steps, one image each in turn, timed between
        synchronize fences: (losses, seconds per step, (coarse loss, fine
        loss) per step)."""
        images, poses_d = trainer._device_dataset(ds)
        losses, secs, by_net = [], [], []
        for k in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.step_fn(trainer.state, images[k % len(ds)], poses_d[k % len(ds)],
                                float(ds.focal), trainer.generator)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            by_net.append((float(m["loss_coarse"]), float(m["loss_fine"])))
        return losses, secs, by_net

    trainer = NeRFTrainer(tcfg, train_hw)
    require(trainer.device.type == "cuda", "the trainer is not on the card")
    torch.cuda.reset_peak_memory_stats()
    at_reset_mb = torch.cuda.memory_allocated() / 2 ** 20    # the trainer's state and more
    reset_counts()
    losses, secs, _ = run_steps(trainer, TRAIN_STEPS - len(ds))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20    # over the eager steps
    epoch_loss = trainer.train_epoch(ds)             # the loop a user calls: 8 more steps
    counts = read_counts()
    paths["train"] = counts
    train_expect = {"mlp_forward": 2 * TRAIN_STEPS, "bwd_rows": K5_PASSES * TRAIN_STEPS,
                    "wgrad": K5_PASSES * TRAIN_STEPS}
    for k, n in counts.items():     # every render kernel among the zeros
        want = train_expect.get(k, 0)
        require(n == want, f"train: {k} launched {n} times in {TRAIN_STEPS} steps, expected {want}")
    require(trainer.state.step == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train: step count {trainer.state.step} or a non-finite loss")
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    step_ms = float(np.median(secs[5:])) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_t:
        _, prof_secs, _ = run_steps(trainer, 1)
    us, n_by = {}, {}
    for name, t in device_events(prof_t):
        us[name] = us.get(name, 0.0) + t
        n_by[name] = n_by.get(name, 0) + 1
    busy_ms = sum(us.values()) / 1e3
    top = sorted(us.items(), key=lambda kv: -kv[1])
    train_profile = dict(
        step_ms=prof_secs[0] * 1e3, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / (prof_secs[0] * 1e3),
        device_ms_by_kernel={k: v / 1e3 for k, v in top[:12]},
        device_ms_other=sum(v for _, v in top[12:]) / 1e3,
        launches_by_kernel={k: n_by[k] for k, _ in top[:12]}, device_kernels=sum(n_by.values()))

    plain_trainer = NeRFTrainer(tcfg, train_hw, apply_fn=apply_nerf)   # bf16 autograd, same seed
    reset_counts()
    plain_losses, plain_secs, _ = run_steps(plain_trainer, 24)
    # its train_epoch: a CUDA graph of apply_nerf's 8 steps, then a replay of it
    plain_epochs = [plain_trainer.train_epoch(ds) for _ in range(2)]
    require(sum(read_counts().values()) == 0, "the apply_nerf trainer launched a kernel")
    require(plain_trainer.state.step == 24 + 2 * len(ds) and all(np.isfinite(plain_epochs)),
            f"train: the apply_nerf trainer's epochs {plain_epochs} at step "
            f"{plain_trainer.state.step}")
    first_rel = abs(losses[0] - plain_losses[0]) / abs(plain_losses[0])

    def trained_loss(apply_fn):
        """The deterministic render of 2,048 fixed rays of a training view
        from the trained params, as a loss against mid-gray."""
        rays_o, rays_d = camera_rays(ds.poses[0], focal, dev, TRAIN_RAYS, seed=5)
        p = trainer.state.params
        with torch.no_grad():
            res = render_rays(p["coarse"], p["fine"], rays_o, rays_d, tcfg.model, tcfg.render,
                              compute_dtype=torch.bfloat16, apply_fn=apply_fn)
            return float(((res.coarse.rgb - 0.5) ** 2).mean() + ((res.fine.rgb - 0.5) ** 2).mean())

    loss_k, loss_p = trained_loss(trainer.apply_fn), trained_loss(apply_nerf)
    trained_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit("train_steps", dataset="make_procedural_dataset(n_views=8, img_wh=(200, 200))",
         steps=TRAIN_STEPS, rays_per_step=TRAIN_RAYS, samples=[SPP, N_FINE], compute="bfloat16",
         launches=counts, expected=train_expect,
         ms_per_step=step_ms, rays_per_s=TRAIN_RAYS / (step_ms / 1e3), peak_device_mb=peak_mb,
         device_mb_at_reset=at_reset_mb,
         first_loss=losses[0], last_loss=losses[-1], last_epoch_mean_loss=epoch_loss,
         mean_loss_first10=first10, mean_loss_last10=last10, required_ratio=LOSS_DROP,
         apply_nerf_bf16_ms_per_step=float(np.median(plain_secs[5:])) * 1e3,
         apply_nerf_first_loss=plain_losses[0], first_loss_rel_diff=first_rel,
         apply_nerf_graphed_epoch_losses=plain_epochs,
         trained_params_loss=loss_k, trained_params_loss_apply_nerf=loss_p,
         trained_params_loss_rel_diff=trained_rel, loss_tol=LOSS_TOL, seed=TRAIN_SEED,
         profile=train_profile, nvidia_smi=smi)
    require(last10 <= LOSS_DROP * first10,
            f"train: mean loss of the last 10 steps {last10} vs the first 10 {first10}")
    require(first_rel <= LOSS_TOL,
            f"train: first-step loss {losses[0]} vs {plain_losses[0]} through apply_nerf")
    require(trained_rel <= LOSS_TOL,
            f"train: trained params' loss {loss_k} vs {loss_p} through apply_nerf")
    del plain_trainer

    # -- train_resume: checkpoint -> fresh trainer -> one more step in both ----
    path = trainer.save_checkpoint("checkpoint_epoch_1.npz")
    resumed = NeRFTrainer(tcfg, train_hw)
    require(resumed.try_resume() == path, "train_resume: the checkpoint was not found")
    resumed.generator.set_state(trainer.generator.get_state())
    run_steps(trainer, 1)
    run_steps(resumed, 1)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(trainer.state.params),
                                                           tree_leaves(resumed.state.params)))
    same_opt = all(torch.equal(a, b) for a, b in zip(
        trainer.state.optimizer.mu + trainer.state.optimizer.nu,
        resumed.state.optimizer.mu + resumed.state.optimizer.nu))
    emit("train_resume", checkpoint_bytes=os.path.getsize(path), step=resumed.state.step,
         params_bit_equal=same, adam_moments_bit_equal=same_opt)
    require(same and same_opt and resumed.state.step == trainer.state.step == TRAIN_STEPS + 2,
            "train_resume: the resumed trainer's step differs from the original's")
    os.remove(path)
    os.rmdir(ckpt_dir)
    del resumed

    # -- train_graphed: the train loop as CUDA graphs (make_multi_train_step) ---
    t_graphed = time.perf_counter()
    train_focal = float(ds.focal)
    order = torch.tensor([k % len(ds) for k in range(2 * GRAPH_STEPS)], device=dev)

    def train_snapshot(t):
        opt = t.state.optimizer
        return {"params": [x.detach().clone() for x in t.state.leaves()],
                "mu": [x.clone() for x in opt.mu], "nu": [x.clone() for x in opt.nu],
                "counts": [opt.count, int(opt.device_count), t.state.step],
                "generator": t.generator.get_state()}

    def train_equal(a, b):
        """Group -> whether two snapshots are bit-equal in it."""
        out = {g: all(torch.equal(x, y) for x, y in zip(a[g], b[g]))
               for g in ("params", "mu", "nu")}
        out.update(counts=a["counts"] == b["counts"],
                   generator=torch.equal(a["generator"], b["generator"]))
        return out

    def eager_twenty():
        t = NeRFTrainer(tcfg, train_hw)
        im, po = t._device_dataset(ds)
        losses = [t.step_fn(t.state, im[i], po[i], train_focal, t.generator)["loss"]
                  for i in order.tolist()]
        return train_snapshot(t), torch.stack(losses)

    def steps_of(n):
        """The K4 / K5a / K5b launches of ``n`` train steps, by counter."""
        return {"mlp_forward": 2 * n, "bwd_rows": K5_PASSES * n, "wgrad": K5_PASSES * n}

    def traced(fn):
        """``(fn(), device us by kernel, launches by kernel, K4 / K5a / K5b
        launches by counter)`` of one call under the profiler. A graph's
        replays advance no counter (a wrapper counts a launch that ran, and
        a capture only records them), so their launches come from the trace."""
        res, us, n = profile_frame(fn)
        return res, us, n, {c: n.get(k, 0) for k, c in TRAIN_COUNTERS.items()}

    def check_launches(want, got, what):
        for k in set(want) | set(got):
            require(got.get(k, 0) == want.get(k, 0),
                    f"train_graphed: {k} launched {got.get(k, 0)} times in {what}, "
                    f"expected {want.get(k, 0)}")

    reset_counts()
    (snap_a, loss_a), (snap_b, loss_b) = eager_twenty(), eager_twenty()
    graphed = NeRFTrainer(tcfg, train_hw)
    im_g, po_g = graphed._device_dataset(ds)
    multi = graphed._multi_step_fn(GRAPH_STEPS)
    halves = (order[:GRAPH_STEPS], order[GRAPH_STEPS:])
    # the first call: eager on a side stream, then captured; the second a replay
    metrics_g = [multi(graphed.state, im_g[halves[0]], po_g[halves[0]], train_focal,
                       graphed.generator)]
    im_h, po_h = im_g[halves[1]], po_g[halves[1]]

    def replay_gate():
        out = multi(graphed.state, im_h, po_h, train_focal, graphed.generator)
        torch.cuda.synchronize()
        return out

    replayed, _, _, gate_traced = traced(replay_gate)
    metrics_g.append(replayed)
    loss_g = torch.cat([m["loss"] for m in metrics_g])
    snap_g = train_snapshot(graphed)
    gate_counts = read_counts()
    eager_vs_eager = {**train_equal(snap_a, snap_b), "losses": torch.equal(loss_a, loss_b)}
    graphed_vs_eager = {**train_equal(snap_a, snap_g), "losses": torch.equal(loss_a, loss_g)}
    del graphed, multi, im_h, po_h

    # (b) 200 steps as replays of one graph of 10, each call fenced
    looped = NeRFTrainer(tcfg, train_hw)
    im_l, po_l = looped._device_dataset(ds)
    multi = looped._multi_step_fn(GRAPH_STEPS)

    def chunk(c):
        """The images and poses of the ``c``-th 10 steps, each view in turn."""
        idx = torch.tensor([(c * GRAPH_STEPS + k) % len(ds) for k in range(GRAPH_STEPS)],
                           device=dev)
        return im_l[idx], po_l[idx]

    chunks = [chunk(c) for c in range(1, GRAPH_REPLAYS + 1)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graph_at_reset_mb = torch.cuda.memory_allocated() / 2 ** 20
    reserved_before_mb = torch.cuda.memory_reserved() / 2 ** 20
    reset_counts()
    graph_losses = [multi(looped.state, *chunk(0), train_focal, looped.generator)["loss"]]
    replay_s = []
    for im_c, po_c in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph_losses.append(multi(looped.state, im_c, po_c, train_focal, looped.generator)["loss"])
        torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t0)
    graph_counts = read_counts()         # the first call's eager steps; replays count nothing
    graph_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    graph_losses = torch.cat(graph_losses).tolist()
    n_graph_steps = (GRAPH_REPLAYS + 1) * GRAPH_STEPS
    graph_ms = float(np.median(replay_s)) * 1e3 / GRAPH_STEPS
    g_first10, g_last10 = float(np.mean(graph_losses[:10])), float(np.mean(graph_losses[-10:]))
    replayed_first10 = float(np.mean(graph_losses[GRAPH_STEPS:GRAPH_STEPS + 10]))

    # the same 20 replays again under the profiler, untimed by the table: their
    # launches by kernel name, the device's share of them. One trace a
    # replay: a trace of all 20 (58,000 kernels) dropped 3 of 1,600 K5a and
    # K5b records on the H100, and a trace of one replay has dropped a K5a
    # and a K5b record there too. A replay launches the same kernels
    # every time (its graph is fixed), so a trace that holds fewer is
    # reported and the replay traced again, at most RETRACES times: a graph
    # that lacks a launch still fails below
    def fenced_replay(im_c, po_c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(looped.state, im_c, po_c, train_focal, looped.generator)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prof_calls_ms, us_g, n_g, graph_traced, short_traces = [], {}, {}, {}, []
    for i, (im_c, po_c) in enumerate(chunks):
        for attempt in range(1 + RETRACES):
            ms, us, n, by_counter = traced(lambda: fenced_replay(im_c, po_c))
            if by_counter == steps_of(GRAPH_STEPS) or attempt == RETRACES:
                break
            short_traces.append({"replay": i, "traced": by_counter})
            emit("profiler_note", replay=i, traced=by_counter, expected=steps_of(GRAPH_STEPS),
                 note="a trace of one replay holds fewer kernel records than the graph "
                      "launches; the replay is traced again")
        prof_calls_ms.append(ms)
        for total, part in ((us_g, us), (n_g, n), (graph_traced, by_counter)):
            for k, v in part.items():
                total[k] = total.get(k, 0) + v
    traced_steps = GRAPH_REPLAYS * GRAPH_STEPS
    paths["train_graphed"] = {k: v + graph_traced.get(k, 0) for k, v in graph_counts.items()}
    busy_g = sum(us_g.values()) / 1e3
    top_g = sorted(us_g.items(), key=lambda kv: -kv[1])
    per_step_launches = {k: n_g.get(k, 0) / traced_steps for k in (K4_KERNEL, *K5_KERNELS)}
    graph_profile = dict(
        replays=GRAPH_REPLAYS, traces=len(prof_calls_ms),
        call_ms_median=float(np.median(prof_calls_ms)),
        device_busy_ms_per_step=busy_g / traced_steps,
        device_idle_share=1.0 - busy_g / sum(prof_calls_ms),
        device_kernels_per_step=sum(n_g.values()) / traced_steps,
        launches=graph_traced, launches_per_step=per_step_launches,
        short_traces_traced_again=short_traces,
        device_ms_per_step_by_kernel={k: v / 1e3 / traced_steps for k, v in top_g[:12]},
        device_ms_per_step_other=sum(v for _, v in top_g[12:]) / 1e3 / traced_steps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graph_pool_mb = torch.cuda.memory_reserved() / 2 ** 20 - reserved_before_mb

    # (c) train_epoch itself: one chunk of 8 a pass, eager then captured on the
    # first pass (counted; no capture runs under the profiler), a replay on
    # the second (traced); its graph shares the trainer's pool with the graph
    # of 10
    epochs = []
    for replay in (False, True):
        reset_counts()
        step0 = looped.state.step
        if replay:
            epoch_loss, _, _, epoch_traced = traced(lambda: looped.train_epoch(ds))
        else:
            epoch_loss, epoch_traced = looped.train_epoch(ds), None
        epochs.append({"loss": epoch_loss, "steps": looped.state.step - step0,
                       "launches_counted": {k: v for k, v in read_counts().items() if v},
                       "launches_traced": epoch_traced})
    torch.cuda.empty_cache()
    second_graph_pool_mb = (torch.cuda.memory_reserved() / 2 ** 20 - reserved_before_mb
                            - graph_pool_mb)
    del chunks, im_c, po_c
    emit("train_graphed", steps_per_graph=GRAPH_STEPS, replays=GRAPH_REPLAYS,
         eager_vs_eager_bit_equal=eager_vs_eager, graphed_vs_eager_bit_equal=graphed_vs_eager,
         gate_losses=loss_g.tolist(), gate_launches_counted=gate_counts,
         gate_launches_traced=gate_traced,
         ms_per_step=graph_ms, replay_ms=[t * 1e3 for t in replay_s],
         rays_per_s=TRAIN_RAYS / (graph_ms / 1e3), eager_ms_per_step=step_ms,
         eager_over_graphed=step_ms / graph_ms, peak_device_mb=graph_peak_mb,
         eager_peak_device_mb=peak_mb, device_mb_at_reset=graph_at_reset_mb,
         peak_over_reset_mb=graph_peak_mb - graph_at_reset_mb,
         eager_peak_over_reset_mb=peak_mb - at_reset_mb,
         reserved_growth_graph_of_10_mb=graph_pool_mb,
         reserved_growth_then_graph_of_8_mb=second_graph_pool_mb,
         launches_counted=graph_counts, launches_traced=graph_traced,
         launches=paths["train_graphed"],
         launches_note="counted: the first call's eager steps; traced: the 20 replays run "
                       "again under the profiler (a replay advances no counter)",
         steps=n_graph_steps, mean_loss_first10=g_first10, mean_loss_last10=g_last10,
         mean_loss_first10_replayed=replayed_first10, required_ratio=LOSS_DROP,
         profile=graph_profile, train_epoch=epochs,
         seed=TRAIN_SEED, seconds=time.perf_counter() - t_graphed, nvidia_smi=smi)
    require(all(eager_vs_eager.values()),
            f"train_graphed: two eager runs of 20 steps differ ({eager_vs_eager}): a kernel of "
            "the step is not deterministic")
    require(all(graphed_vs_eager.values()),
            f"train_graphed: two calls of a 10-step graph differ from 20 eager steps "
            f"({graphed_vs_eager})")
    check_launches(steps_of(5 * GRAPH_STEPS), gate_counts,
                   "the gate's counted 50 steps (2 x 20 eager, the graph's first call)")
    check_launches(steps_of(GRAPH_STEPS), gate_traced, "the gate's replay (traced)")
    check_launches(steps_of(GRAPH_STEPS), graph_counts, "the graph's first call")
    check_launches(steps_of(traced_steps), graph_traced, f"{GRAPH_REPLAYS} replays (traced)")
    check_launches(steps_of(len(ds)), epochs[0]["launches_counted"],
                   "the first epoch of 8 (eager, then captured)")
    check_launches({}, epochs[1]["launches_counted"], "the second epoch of 8 (a replay)")
    check_launches(steps_of(len(ds)), epochs[1]["launches_traced"],
                   "the second epoch of 8 (traced)")
    require(all(e["steps"] == len(ds) and np.isfinite(e["loss"]) for e in epochs)
            # the traced replays took as many steps again
            and looped.state.step == (n_graph_steps + traced_steps + 2 * len(ds)
                                      + GRAPH_STEPS * len(short_traces))
            and all(np.isfinite(graph_losses)),
            f"train_graphed: step count {looped.state.step} or a non-finite loss")
    require(g_last10 <= LOSS_DROP * g_first10,
            f"train_graphed: mean loss of the last 10 steps {g_last10} vs the first 10 {g_first10}")
    require(per_step_launches == {K4_KERNEL: 2, K5_KERNELS[0]: K5_PASSES, K5_KERNELS[1]: K5_PASSES},
            f"train_graphed: the traced replays launched {per_step_launches} per step")
    del looped, multi
    torch.cuda.empty_cache()

    # -- train_streaming: batches from the port's C++ producer (runtime) -------
    from nerf_tpu_torch import runtime

    t_stream = time.perf_counter()
    runtime.load_library()               # g++ builds it here, outside the timed steps
    runtime_build_s = time.perf_counter() - t_stream

    def timed_stream():
        """A fresh trainer's 200 streamed steps, the loss read once at the end:
        (trainer, last loss, wall ms a step, process CPU ms a step)."""
        t = NeRFTrainer(tcfg, train_hw)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        last = t.train_streaming(ds, TRAIN_STEPS, log_every=TRAIN_STEPS, log_fn=lambda m: None)
        torch.cuda.synchronize()
        return (t, last, (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS,
                (time.process_time() - c0) * 1e3 / TRAIN_STEPS)

    reset_counts()
    streamer, stream_last, stream_ms, stream_cpu_ms = timed_stream()
    stream_counts = read_counts()
    paths["train_streaming"] = stream_counts
    stream_blocked = streamer.sampler_blocked_s
    # the same run once more in this process: the spread of the unfenced step
    # within one call (runs of one commit read 8.7 to 13.6 ms between calls)
    again, again_last, again_ms, again_cpu_ms = timed_stream()
    again_equal = again_last == stream_last and all(
        torch.equal(x, y) for x, y in zip(streamer.state.leaves(), again.state.leaves()))
    del again
    # the same run again, its loss read at every step: the per-step losses, and
    # a run from one seed is bit-equal (the two pinned buffers in turn hold)
    logged = NeRFTrainer(tcfg, train_hw)
    lines = []
    t0 = time.perf_counter()
    logged_last = logged.train_streaming(ds, TRAIN_STEPS, log_every=1, log_fn=lines.append)
    logged_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    stream_losses = [float(line.rsplit("loss=", 1)[1]) for line in lines]
    s_first10, s_last10 = float(np.mean(stream_losses[:10])), float(np.mean(stream_losses[-10:]))
    stream_equal = stream_last == logged_last and all(
        torch.equal(x, y) for x, y in zip(streamer.state.leaves(), logged.state.leaves()))
    # assemble_tiles on one frame: the trained streamer's view 0 in 4,096-ray tiles
    rgb_view, _ = streamer.render_image(streamer.state.params, ds.poses[0], train_hw, train_focal)
    frame_np = rgb_view.reshape(-1, 3).cpu().numpy()
    offsets = list(range(0, frame_np.shape[0], 4096))
    tiles = [frame_np[o:o + 4096] for o in offsets]
    scatter = np.zeros_like(frame_np)
    for t, o in zip(tiles, offsets):
        scatter[o:o + len(t)] = t
    tiled = runtime.assemble_tiles(tiles, offsets, frame_np.shape[0], 3)
    tiles_equal = bool(np.array_equal(tiled, scatter) and np.array_equal(tiled, frame_np))
    stream_expect = {"mlp_forward": 2 * TRAIN_STEPS, "bwd_rows": K5_PASSES * TRAIN_STEPS,
                     "wgrad": K5_PASSES * TRAIN_STEPS}
    emit("train_streaming", steps=TRAIN_STEPS, rays_per_step=TRAIN_RAYS,
         ms_per_step=stream_ms, rays_per_s=TRAIN_RAYS / (stream_ms / 1e3),
         process_cpu_ms_per_step=stream_cpu_ms, ms_per_step_second_run=again_ms,
         process_cpu_ms_per_step_second_run=again_cpu_ms,
         next_batch_blocked_s=stream_blocked, ms_per_step_loss_read_each_step=logged_ms,
         next_batch_blocked_s_loss_read_each_step=logged.sampler_blocked_s,
         last_loss=stream_last, mean_loss_first10=s_first10, mean_loss_last10=s_last10,
         required_ratio=LOSS_DROP, two_runs_bit_equal=stream_equal,
         third_run_bit_equal=again_equal, launches=stream_counts,
         expected=stream_expect, assemble_tiles_bit_equal=tiles_equal, tiles=len(tiles),
         eager_ms_per_step=step_ms, seed=TRAIN_SEED, runtime_build_s=runtime_build_s,
         runtime_library=str(runtime.library_path().relative_to(ROOT)),
         seconds=time.perf_counter() - t_stream, nvidia_smi=smi)
    for k in set(stream_expect) | set(stream_counts):
        require(stream_counts.get(k, 0) == stream_expect.get(k, 0),
                f"train_streaming: {k} launched {stream_counts.get(k, 0)} times, expected "
                f"{stream_expect.get(k, 0)}")
    require(len(stream_losses) == TRAIN_STEPS and all(np.isfinite(stream_losses))
            and streamer.state.step == TRAIN_STEPS, "train_streaming: a step or a loss is missing")
    require(s_last10 <= LOSS_DROP * s_first10,
            f"train_streaming: mean loss of the last 10 steps {s_last10} vs the first 10 {s_first10}")
    require(stream_equal and again_equal, "train_streaming: two runs from one seed differ")
    require(tiles_equal, "train_streaming: assemble_tiles differs from the numpy scatter")
    del streamer, logged
    torch.cuda.empty_cache()

    # -- train_default_seed: the same steps from TrainConfig's own seed, a record
    #    of the reference's own behaviour at a dead start (not a fault of the port)
    def density_alive(t):
        """Share of 2,048 rays x 64 uniform depths of training view 0 on
        which each network's ReLU'd density is positive (bf16 apply_nerf)."""
        rays_o, rays_d = generate_rays(ds.poses[0], train_hw[1],
                                       train_hw[0], float(ds.focal), dev)
        idx = torch.randperm(train_hw[0] * train_hw[1],
                             generator=torch.Generator().manual_seed(11))[:TRAIN_RAYS].to(dev)
        rays_o, rays_d = rays_o.reshape(-1, 3)[idx], rays_d.reshape(-1, 3)[idx]
        z = torch.linspace(tcfg.render.near, tcfg.render.far, SPP, device=dev)
        pos = rays_o[:, None, :] + rays_d[:, None, :] * z[None, :, None]
        with torch.no_grad():
            return {net: float((apply_nerf(t.state.params[net], pos,
                                           rays_d[:, None, :].expand_as(pos), tcfg.model,
                                           compute_dtype=torch.bfloat16)[0] > 0).float().mean())
                    for net in ("coarse", "fine")}

    alive_smoke_seed = density_alive(trainer)
    dcfg = dataclasses.replace(tcfg, train=default_config().train)
    default_trainer = NeRFTrainer(dcfg, train_hw)
    alive_before = density_alive(default_trainer)
    d_losses, _, d_by_net = run_steps(default_trainer, TRAIN_STEPS)
    d_by_net = np.asarray(d_by_net)
    emit("train_default_seed", seed=dcfg.train.seed, steps=TRAIN_STEPS,
         density_positive_share_before=alive_before,
         density_positive_share_after=density_alive(default_trainer),
         loss_coarse_first10=float(d_by_net[:10, 0].mean()),
         loss_coarse_last10=float(d_by_net[-10:, 0].mean()),
         loss_fine_first10=float(d_by_net[:10, 1].mean()),
         loss_fine_last10=float(d_by_net[-10:, 1].mean()),
         mean_loss_first10=float(np.mean(d_losses[:10])),
         mean_loss_last10=float(np.mean(d_losses[-10:])),
         smoke_seed=TRAIN_SEED, smoke_seed_density_positive_share_after=alive_smoke_seed,
         note="a record, not a check: nothing is required of this run's loss")
    require(all(np.isfinite(d_losses)), "train_default_seed: a non-finite loss")
    del default_trainer
    torch.cuda.empty_cache()

    # -- path 9: the unified benchmark suite (every engine, one report) -------
    t_suite = time.perf_counter()
    suite_dir = tempfile.mkdtemp(prefix="nerf_suite_")
    suite = UnifiedBenchmarkSuite(cfg_ref, suite_dir, device=dev)
    suite.add_available_renderers()
    require(list(suite.engines) == list(ENGINE_CLASSES),
            f"suite: engines {list(suite.engines)} registered, expected {list(ENGINE_CLASSES)}")
    frames_seen = []      # (std, finite, rgb) of each frame the sweep renders, in its order
    for eng in suite.engines.values():
        def seen(*a, _render=eng.render_image, **k):
            out = _render(*a, **k)
            frames_seen.append((float(out.rgb.std()), bool(np.isfinite(out.rgb).all()
                                                            and np.isfinite(out.depth).all()),
                                out.rgb))
            return out
        eng.render_image = seen
    reset_counts()
    results = suite.run_benchmark(PARAMS, resolutions=SUITE_RES, samples=SUITE_SPP,
                                  n_views=SUITE_VIEWS)
    paths["suite"] = suite_counts = read_counts()
    for eng in suite.engines.values():
        del eng.render_image                  # the class's method again
    n_rows = len(ENGINE_CLASSES) * len(SUITE_RES) * len(SUITE_SPP) * SUITE_VIEWS
    failed = [(r.renderer_name, r.resolution, r.samples_per_ray, r.view_idx, r.error)
              for r in results if not r.success]
    require(not failed, f"suite: failed rows {failed}")
    require(len(results) == n_rows == len(frames_seen),
            f"suite: {len(results)} rows and {len(frames_seen)} frames, expected {n_rows}")
    for k, n in suite_counts.items():
        require(n == SUITE_LAUNCHES.get(k, 0),
                f"suite: {k} launched {n} times, expected {SUITE_LAUNCHES.get(k, 0)}")
    require(all(f[1] for f in frames_seen), "suite: a non-finite frame")
    view0_std = {f"{r.renderer_name} {r.resolution[0]}x{r.resolution[1]}@{r.samples_per_ray}":
                 f[0] for r, f in zip(results, frames_seen) if r.view_idx == 0}
    require(min(view0_std.values()) > 0.05, f"suite: a degenerate view-0 frame {view0_std}")
    sweep_s = time.perf_counter() - t_suite
    # a profiler trace of one cuda frame through the monitor's helper
    with profile_trace(os.path.join(suite_dir, "trace")) as prof_s:
        suite.engines["cuda"].render_image(orbit_poses(SUITE_VIEWS)[0], SUITE_RES[0], SPP,
                                           focal=BENCHMARK_FOCAL, monitor=False)
        torch.cuda.synchronize()
    with open(prof_s.trace_path) as f:
        trace_events = json.load(f)["traceEvents"]
    k1_events = sum(1 for e in trace_events if e.get("cat") == "kernel"
                    and WGMMA["render_samples"] in e.get("name", ""))
    require(k1_events > 0, f"suite: the trace holds no launch of {WGMMA['render_samples']}")
    # the gates, at 200 x 150 with the lego camera's focal
    gw, gh = SUITE_RES[0]
    gfocal = focal_from_angle(gw, CAMERA_ANGLE_X)
    quality = suite.quality_report(resolutions=[SUITE_RES[0]], spp=SPP, focal=gfocal,
                                   reference_engine="torch", n_views=4)
    gt = suite.gt_quality_report(resolution=SUITE_RES[0], gt_spp=TRUTH_SPP, spps=ACCEL_SPP,
                                 focal=gfocal, gt_engine="torch", n_views=4,
                                 engines=["cuda", "accel"])
    paths_written = suite.generate_report(chart=False)
    with open(paths_written["csv"]) as f:
        csv_rows = f.read().splitlines()[1:]
    with open(paths_written["json"]) as f:
        report = json.load(f)
    require(len(csv_rows) == len(report["results"]) == n_rows and report["quality"] == quality
            and set(report["gt_quality"]) == {"_meta", "cuda", "accel"},
            f"suite: {len(csv_rows)} CSV rows, {len(report['results'])} JSON rows, expected "
            f"{n_rows}; JSON keys {list(report)}")
    pngs = 0
    for r, (_, _, rgb) in zip(results, frames_seen):
        if r.view_idx:
            continue
        w_, h_ = r.resolution
        stem = os.path.join(suite_dir, "sample_renders", r.renderer_name,
                            f"view0_{w_}x{h_}_s{r.samples_per_ray}")
        img, dimg = decode_png(stem + "_rgb.png"), decode_png(stem + "_depth.png")
        require(np.array_equal(img, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
                and dimg.shape == (h_, w_), f"suite: {stem} PNGs differ from the frame")
        pngs += 2
    require(pngs == n_rows, f"suite: {pngs} PNGs, expected {n_rows}")
    for name, q in quality.items():
        require("error" not in q, f"suite quality: {name}: {q}")
        require(all(c["ssim"] <= 1.0 for c in q["cells"].values()),
                f"suite quality: {name}: an SSIM above 1")
        if name in SUITE_DB:
            require(q["psnr_db_min"] >= SUITE_DB[name],
                    f"suite quality: {name} {q['psnr_db_min']} dB < {SUITE_DB[name]}")
    require(set(quality) == set(ENGINE_CLASSES) - {"torch"}, f"suite quality: {list(quality)}")
    for spp in ACCEL_SPP:
        c, a = gt["cuda"][str(spp)], gt["accel"][str(spp)]
        require("error" not in c and "error" not in a, f"suite gt: {c}, {a}")
        require(c["ssim_vs_gt"] <= 1.0 and a["ssim_vs_gt"] <= 1.0, "suite gt: an SSIM above 1")
        require(a["psnr_db_vs_gt"] >= c["psnr_db_vs_gt"] - ACCEL_DB_MARGIN,
                f"suite gt at spp {spp}: accel {a['psnr_db_vs_gt']} dB, cuda {c['psnr_db_vs_gt']}")
    full = [r for r in results if r.resolution == SUITE_RES[-1] and r.samples_per_ray == SPP]
    summary = summarize(results)
    per_engine = {name: dict(
        rays_per_s_800x600_64=float(np.median([r.rays_per_second for r in full
                                                if r.renderer_name == name])),
        ms_800x600_64=[r.render_time_s * 1e3 for r in full if r.renderer_name == name],
        peak_device_mb=summary[name]["peak_device_mb"],
        peak_host_rss_mb=summary[name]["peak_host_rss_mb"]) for name in suite.engines}
    emit("suite", engines=list(suite.engines), rows=len(results), views=SUITE_VIEWS,
         resolutions=[list(r) for r in SUITE_RES], samples=list(SUITE_SPP),
         launches=suite_counts, expected=SUITE_LAUNCHES, per_engine=per_engine,
         view0_rgb_std=view0_std, pngs=pngs, csv_rows=len(csv_rows),
         report_files=sorted(paths_written), trace_k1_launches=k1_events,
         quality={k: {f: v[f] for f in ("psnr_db", "psnr_db_min", "ssim", "ssim_min",
                                         "cells_aggregated")} for k, v in quality.items()},
         quality_min_db=SUITE_DB, gt_quality=gt, gt_db_margin=ACCEL_DB_MARGIN,
         sweep_seconds=sweep_s, seconds=time.perf_counter() - t_suite, nvidia_smi=smi)
    del suite, frames_seen
    torch.cuda.empty_cache()

    # -- path 10: bench_cuda.py, the port's headline line ---------------------
    t_bench = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_cuda.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"bench_cuda.py exited {proc.returncode}: {proc.stderr[-3000:]}")
    out_lines = proc.stdout.splitlines()
    require(len(out_lines) == 1, f"bench_cuda.py printed {len(out_lines)} stdout lines")
    line = json.loads(out_lines[0])
    require(set(line) == {"metric", "value", "unit", "vs_baseline"}
            and line["metric"] == "rays_per_second" and line["unit"] == "rays/s"
            and line["value"] > 0, f"bench_cuda.py: {line}")
    bmild_line = [ln for ln in proc.stderr.splitlines() if ln.startswith("bmild frame")]
    require(len(bmild_line) == 1, f"bench_cuda.py: no bmild frame on stderr: {proc.stderr}")
    emit("bench_cuda", line=line, bmild_frame=bmild_line[0],
         stderr=[ln for ln in proc.stderr.splitlines() if ln.startswith(("device", "view"))],
         frame_phase_rays_per_s=frame_res["rays_per_s"],
         ratio_to_frame_phase=line["value"] / frame_res["rays_per_s"],
         seconds=time.perf_counter() - t_bench, nvidia_smi=smi)

    # -- paths 11-18: the command line (python -m nerf_tpu_torch.cli), in this
    #    process through cli.main, each with the launch counts set to 0 just
    #    before and read just after. cli_pipeline and cli_streaming train on
    #    the procedural scene (the command line's own stand-in for a missing
    #    Blender directory); cli_blender trains on a Blender directory of RGBA
    #    PNGs, read by the PNG decoder (runtime/png.cpp) that cli_decode
    #    builds and checks here
    from nerf_tpu_torch.cli import main as cli

    t_cli = time.perf_counter()
    cli_root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    no_dataset = os.path.join(cli_root, "no_blender_dataset")
    cli_cfg = default_config()                       # the command line's config for a .npz

    def run_cli(name, argv, expect):
        """``cli.main(argv)`` with its stdout kept, between fences, the
        launch counts set to 0 before and read after: (lines, seconds).
        Requires exit code 0 and ``expect[counter]`` launches of every
        counter (0 for those not named)."""
        buf = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
        except BaseException:
            print(buf.getvalue()[-4000:], flush=True)
            raise
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = paths[name] = read_counts()
        require(rc == 0, f"{name}: exit code {rc}: {buf.getvalue()[-3000:]}")
        for k in set(counts) | set(expect):
            require(counts.get(k, 0) == expect.get(k, 0),
                    f"{name}: {k} launched {counts.get(k, 0)} times, expected {expect.get(k, 0)}")
        return buf.getvalue().splitlines(), secs

    def eval_loss(params, ds_eval):
        """The trainer's loss (coarse + fine MSE) of 8,192 fixed rays of
        view 0, rendered without jitter through bf16 ``apply_nerf``."""
        rays_o, rays_d = generate_rays(ds_eval.poses[0], ds_eval.img_wh[0], ds_eval.img_wh[1],
                                       float(ds_eval.focal), dev)
        idx = torch.randperm(rays_o.shape[0] * rays_o.shape[1],
                             generator=torch.Generator().manual_seed(13))[:8192].to(dev)
        target = torch.as_tensor(ds_eval.images[0], device=dev).reshape(-1, 3)[idx]
        with torch.no_grad():
            res = render_rays(params["coarse"], params["fine"], rays_o.reshape(-1, 3)[idx],
                              rays_d.reshape(-1, 3)[idx], cli_cfg.model, cli_cfg.render,
                              compute_dtype=torch.bfloat16)
        return float(((res.coarse.rgb - target) ** 2).mean() + ((res.fine.rgb - target) ** 2).mean())

    train_views = make_procedural_dataset(n_views=20, img_wh=(200, 200), seed=0)
    init_params = NeRFTrainer(cli_cfg, (200, 200), device=dev).state.params     # the CLI's seed-0 start
    loss_init = eval_loss(init_params, train_views)
    del init_params

    # -- cli_pipeline: train 2 epochs at full width, then the benchmark of 4 engines
    ckpt_dir, bench_dir = os.path.join(cli_root, "ckpt"), os.path.join(cli_root, "bench")
    cli_views, train_chunk = 2, min(10, len(train_views))    # train_epoch's chunk of 10 images
    per_engine_frames = (cli_views + 1) * per_frame          # a warm frame, then the views
    bake = cli_cfg.accel.grid_resolution ** 3 // BAKE_CHUNK
    # the train loop's first chunk runs eagerly (counted), then its graph is
    # captured and replayed (not counted); the suite's rule as in `suite`
    pipeline_expect = {"render_samples": 3 * per_engine_frames, "dequant": per_engine_frames,
                       "dequant_stream": per_engine_frames,
                       "int8": per_engine_frames, "render_zvals": per_engine_frames,
                       "occupancy": per_engine_frames, "composite": 4 * per_engine_frames,
                       "mlp_forward": bake + 2 * train_chunk, "bwd_rows": K5_PASSES * train_chunk,
                       "wgrad": K5_PASSES * train_chunk}
    cli_engines = ["cuda", "compressed", "int8", "accel"]
    lines, secs = run_cli("cli_pipeline", [
        "pipeline", "--device", "cuda", "--data_dir", no_dataset, "--image_size", "200",
        "--epochs", "2", "--n_rays", "2048", "--no_resume", "--checkpoint_dir", ckpt_dir,
        "--output_dir", bench_dir, "--resolutions", "800x600", "--samples", "64",
        "--views", str(cli_views), "--engines", *cli_engines], pipeline_expect)
    final_npz = os.path.join(ckpt_dir, "final_model.npz")
    require(os.path.exists(final_npz), f"cli_pipeline: no {final_npz}")
    final_state, final_meta = restore_checkpoint(final_npz)
    epoch_losses = final_meta["train_losses"]
    loss_pipeline = eval_loss(params_from_numpy(final_state["params"], dev), train_views)
    with open(os.path.join(bench_dir, "benchmark_results.json")) as f:
        rows = json.load(f)["results"]
    require(sorted(r["renderer_name"] for r in rows) == sorted(cli_engines * cli_views)
            and all(r["success"] and r["resolution"] == [800, 600] and r["samples_per_ray"] == 64
                    for r in rows), f"cli_pipeline: benchmark rows {rows}")
    cli_ms = {name: float(np.median([r["render_time_s"] * 1e3 for r in rows
                                     if r["renderer_name"] == name])) for name in cli_engines}
    suite_ms = {name: float(np.median(per_engine[name]["ms_800x600_64"])) for name in cli_engines}
    emit("cli_pipeline", argv="pipeline --data_dir (none: the procedural scene) --image_size 200 "
         "--epochs 2 --n_rays 2048 --resolutions 800x600 --samples 64 --views 2 --engines "
         + " ".join(cli_engines), launches=paths["cli_pipeline"], expected=pipeline_expect,
         epoch_losses=epoch_losses, step=final_state["step"], eval_loss_before=loss_init,
         eval_loss_after=loss_pipeline, ms_per_frame_800x600_64=cli_ms,
         suite_phase_ms_per_frame_800x600_64=suite_ms,
         ratio_to_suite_phase={k: cli_ms[k] / suite_ms[k] for k in cli_engines},
         stdout_tail=lines[-8:], seconds=secs, nvidia_smi=smi)
    require(final_state["step"] == 2 * len(train_views) and len(epoch_losses) == 2
            and all(np.isfinite(epoch_losses)), f"cli_pipeline: {final_state['step']} steps, "
            f"epoch losses {epoch_losses}")
    require(epoch_losses[1] < epoch_losses[0],
            f"cli_pipeline: the loss did not fall over the epochs: {epoch_losses}")

    # -- cli_render: render --engine cuda at 800x600@64 in both modes, traced,
    #    and the benchmark mode once more untraced for its time
    cli_pose = spherical_pose(30.0, -30.0, 4.0)              # render's default camera
    cli_focal = focal_from_angle(W, CAMERA_ANGLE_X)
    in_process = CudaEngine(SharedModel(cli_cfg, dev).load(PARAMS), chunk_rays=CHUNK)
    render_res = {}
    for mode, traced in (("benchmark", True), ("hierarchical", True), ("benchmark", False)):
        out_dir = os.path.join(cli_root, f"render_{mode}_{'traced' if traced else 'untraced'}")
        per = {"render_samples": 1, "composite": 1} if mode == "benchmark" \
            else {"render_samples": 1, "composite": 2, "render_zvals": 1}
        lines, secs = run_cli(f"cli_render_{mode}" + ("" if traced else "_untraced"), [
            "render", "--device", "cuda", "--weights", PARAMS, "--engine", "cuda", "--width",
            str(W), "--height", str(H), "--samples", str(SPP), "--mode", mode, "--out", out_dir,
            *(["--trace", os.path.join(out_dir, "trace")] if traced else [])],
            {k: 2 * per_frame * v for k, v in per.items()})     # the warm frame and the frame
        line = next(ln for ln in lines if ln.startswith("rendered "))
        frame_ms = float(line.split(" in ")[1].split("s ")[0]) * 1e3
        ref = in_process.render_image(cli_pose, (W, H), SPP, focal=cli_focal, mode=mode,
                                      monitor=False)
        rgb_png = decode_png(os.path.join(out_dir, "rgb.png"))
        depth_png = decode_png(os.path.join(out_dir, "depth.png"))
        d = ref.depth
        depth_u8 = ((d - d.min()) / max(float(d.max() - d.min()), 1e-9) * 255).astype(np.uint8)
        require(np.array_equal(rgb_png, (np.clip(ref.rgb, 0, 1) * 255).astype(np.uint8))
                and np.array_equal(depth_png, depth_u8),
                f"cli_render {mode}: rgb.png / depth.png differ from the in-process frame")
        entry = dict(frame_ms_printed=frame_ms, rgb_std=float(ref.rgb.std()), seconds=secs)
        if traced:
            traces = [os.path.join(out_dir, "trace", f) for f in os.listdir(os.path.join(out_dir,
                                                                                         "trace"))]
            require(len(traces) == 1, f"cli_render {mode}: traces {traces}")
            with open(traces[0]) as f:
                names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "kernel"]
            kernels = {k: sum(1 for n in names if k in n) for k in WGMMA.values()}
            want = [WGMMA["render_samples"]] + ([WGMMA["render_zvals"]]
                                                if mode == "hierarchical" else [])
            require(all(kernels[k] > 0 for k in want),
                    f"cli_render {mode}: the trace names {kernels}, expected {want}")
            entry.update(trace_kernel_events=kernels, trace_kernel_events_all=len(names))
        render_res[f"{mode}{'' if traced else '_untraced'}"] = entry
    emit("cli_render", argv=f"render --weights final_params.npz --engine cuda --width {W} "
         f"--height {H} --samples {SPP} --mode benchmark|hierarchical --trace",
         launches={k: paths[k] for k in paths if k.startswith("cli_render")}, runs=render_res,
         frame_phase_ms=frame_res["ms_per_frame"],
         ratio_untraced_to_frame_phase=render_res["benchmark_untraced"]["frame_ms_printed"]
         / frame_res["ms_per_frame"], pngs_equal_in_process_frame=True, nvidia_smi=smi)
    del in_process

    # -- cli_export: the pipeline's checkpoint as a .pth, read back by SharedModel
    pth = os.path.join(cli_root, "final_model.pth")
    lines, secs = run_cli("cli_export", ["export", "--device", "cuda", "--checkpoint", final_npz,
                                         "--out", pth], {})
    from_pth = SharedModel(cli_cfg, dev).load(pth)
    from_npz = SharedModel(cli_cfg, dev).load(final_npz)
    leaves = {net: (tree_leaves(from_pth.params[net]), tree_leaves(from_npz.params[net]))
              for net in ("coarse", "fine")}
    params_equal = all(len(a) == len(b) and all(pa == pb and torch.equal(x, y)
                                                for (pa, x), (pb, y) in zip(a, b))
                       for a, b in leaves.values())
    frames_equal = {}
    for mode in ("benchmark", "hierarchical"):
        fa, fb = (CudaEngine(s, chunk_rays=CHUNK).render_image(
            poses[1], (qw, qh), SPP, focal=qfocal, mode=mode, monitor=False)
            for s in (from_pth, from_npz))
        frames_equal[mode] = bool(np.array_equal(fa.rgb, fb.rgb)
                                  and np.array_equal(fa.depth, fb.depth))
    emit("cli_export", checkpoint="the cli_pipeline final_model.npz", pth_bytes=os.path.getsize(pth),
         leaves=sum(len(a) for a, _ in leaves.values()), params_bit_equal=params_equal,
         frames_bit_equal=frames_equal, frame=[qw, qh], launches=paths["cli_export"],
         seconds=secs, stdout=lines)
    require(params_equal, "cli_export: the .pth's params differ from the .npz's")
    require(all(frames_equal.values()), f"cli_export: frames differ {frames_equal}")
    del from_pth, from_npz

    # -- cli_compare: every engine at 128x128@32 on the trained weights, one grid
    cmp_size, cmp_spp = 128, 32
    cmp_dir = os.path.join(cli_root, "compare")
    one = math.ceil(cmp_size * cmp_size / CHUNK)            # chunks a frame (1)
    cmp_expect = {"render_samples": 6 * one, "dequant": 2 * one,
                  "dequant_stream": 2 * one,
                  "int8": 2 * one, "render_zvals": 2 * one, "occupancy": 2 * one,
                  "composite": 8 * one, "mlp_forward": bake}
    lines, secs = run_cli("cli_compare", [
        "compare", "--device", "cuda", "--checkpoint", PARAMS, "--size", str(cmp_size),
        "--samples", str(cmp_spp), "--output_dir", cmp_dir], cmp_expect)
    grid = decode_png(os.path.join(cmp_dir, "renderer_comparison.png"))
    require(grid.shape == (2 * cmp_size, cmp_size * len(ENGINE_CLASSES), 3),
            f"cli_compare: grid {grid.shape}")
    status = {ln.split(":")[0]: ln.split(": ", 1)[1] for ln in lines
              if ln.split(":")[0] in ENGINE_CLASSES}
    require(list(status) == list(ENGINE_CLASSES) and not any("BLACK" in s for s in status.values()),
            f"cli_compare: engine lines {status}")
    cmp_shared = SharedModel(cli_cfg, dev).load(PARAMS)
    tiles_equal = {}
    for col, (name, cls) in enumerate(ENGINE_CLASSES.items()):
        res = cls(cmp_shared).render_image(spherical_pose(40.0, -30.0, 4.0), (cmp_size, cmp_size),
                                           cmp_spp, focal=focal_from_angle(cmp_size, CAMERA_ANGLE_X))
        d = res.depth
        dn = ((d - d.min()) / max(float(d.max() - d.min()), 1e-9) * 255).astype(np.uint8)
        tile = grid[:, col * cmp_size:(col + 1) * cmp_size]
        tiles_equal[name] = bool(
            np.array_equal(tile[:cmp_size], (np.clip(res.rgb, 0, 1) * 255).astype(np.uint8))
            and np.array_equal(tile[cmp_size:], np.repeat(dn[..., None], 3, axis=-1)))
    emit("cli_compare", argv=f"compare --checkpoint final_params.npz --size {cmp_size} "
         f"--samples {cmp_spp}", grid_shape=list(grid.shape), engines=status,
         tiles_equal_in_process_frames=tiles_equal, launches=paths["cli_compare"],
         expected=cmp_expect, seconds=secs, nvidia_smi=smi)
    require(all(tiles_equal.values()), f"cli_compare: tiles differ from the frames {tiles_equal}")
    del cmp_shared
    torch.cuda.empty_cache()

    # -- cli_streaming: train 200 steps from the C++ ray producer
    stream_dir = os.path.join(cli_root, "stream")
    stream_expect = {"mlp_forward": 2 * TRAIN_STEPS, "bwd_rows": K5_PASSES * TRAIN_STEPS,
                     "wgrad": K5_PASSES * TRAIN_STEPS}
    lines, secs = run_cli("cli_streaming", [
        "train", "--device", "cuda", "--data_dir", no_dataset, "--image_size", "200",
        "--streaming_steps", str(TRAIN_STEPS), "--no_resume", "--checkpoint_dir", stream_dir,
        "--output_dir", stream_dir], stream_expect)
    logged = [float(ln.rsplit("loss=", 1)[1]) for ln in lines if ln.startswith("step ")]
    stream_state, _ = restore_checkpoint(os.path.join(stream_dir, "final_model.npz"))
    loss_stream = eval_loss(params_from_numpy(stream_state["params"], dev), train_views)
    emit("cli_streaming", argv=f"train --data_dir (none: the procedural scene) --image_size 200 "
         f"--streaming_steps {TRAIN_STEPS} --no_resume", step=stream_state["step"],
         logged_losses=logged, eval_loss_before=loss_init, eval_loss_after=loss_stream,
         launches=paths["cli_streaming"], expected=stream_expect,
         ms_per_step_with_setup=secs * 1e3 / TRAIN_STEPS, seconds=secs, nvidia_smi=smi)
    require(stream_state["step"] == TRAIN_STEPS and len(logged) == TRAIN_STEPS // 100,
            f"cli_streaming: step {stream_state['step']}, logged {logged}")
    require(loss_stream < loss_init,
            f"cli_streaming: the loss did not fall: {loss_init} -> {loss_stream}")

    # -- cli_smoke: the module entry in a child process (its own card context)
    t_smoke = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nerf_tpu_torch.cli", "smoke"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    emit("cli_smoke", returncode=proc.returncode, stdout_tail=proc.stdout.splitlines()[-3:],
         seconds=time.perf_counter() - t_smoke)
    require(proc.returncode == 0 and "smoke test passed" in proc.stdout,
            f"cli_smoke: exit code {proc.returncode}: {proc.stdout[-2000:]}{proc.stderr[-3000:]}")

    # -- cli_decode, cli_blender: the real-data path, the PNG decoder built
    #    here from its source, then a Blender directory trained at its size
    decode_phase(smi, cli_root)
    blender_phase(smi, paths, run_cli, cli_root,
                  {"mlp_forward": 2 * train_chunk, "bwd_rows": K5_PASSES * train_chunk,
                   "wgrad": K5_PASSES * train_chunk})
    emit("cli", seconds=time.perf_counter() - t_cli, nvidia_smi=smi)

    # -- path 19: convergence, 2,000 steps of the convergence run's recipe ------
    convergence_phase(smi, paths, cli_root, train_chunk)

    # -- paths 20-25: multi-GPU on torch.distributed, on this one card ----------
    multi_gpu_phases(dev, smi, paths, run_cli, cli_root)

    # -- summary -------------------------------------------------------------
    no_library = "no single PyTorch call computes this function"
    mlp = "sample generation + encoding + the 10-layer MLP"
    # max_abs_err: the largest of the 1,001-ray checks and the chunk check
    rw = "nerf_tpu_torch/csrc/ray_wgmma.cu"
    summary = (
        ("render_samples", "render_samples", rw, "nerf_tpu/ops/render_kernel.py:203", "benchmark",
         max(*k1_err.values(), chunk_abs["render_samples"]),
         f"{CHUNK} rays x {SPP} samples, bf16, raw out", mlp),
        ("composite", "composite", "nerf_tpu_torch/csrc/composite.cu",
         "nerf_tpu/ops/composite_kernel.py:90", "hierarchical",
         max(k2_err, chunk_abs["composite"], chunk_abs["composite_192"]),
         f"{CHUNK} rays x {SPP} samples, f32", "the log-space transmittance scan and its sums"),
        ("render_zvals", "render_zvals", rw, "nerf_tpu/ops/render_kernel.py:455", "hierarchical",
         max(*k3_err.values(), chunk_abs["render_zvals"]),
         f"{CHUNK} rays x {S3} per-ray depths, bf16, raw out", mlp),
        ("render_samples_composited", "render_samples_composited", rw,
         "nerf_tpu/ops/render_kernel.py:152", "fused_hierarchical",
         max(b9_err["render_samples_composited"], chunk_abs["render_samples_composited"]),
         f"{CHUNK} rays x {SPP} samples, bf16, composited with weights", mlp + " + compositing"),
        ("render_zvals_composited", "render_zvals_composited", rw,
         "nerf_tpu/ops/render_kernel.py:152", "fused_hierarchical",
         max(b9_err["render_zvals_composited"], chunk_abs["render_zvals_composited"]),
         f"{CHUNK} rays x {S3} per-ray depths, bf16, composited", mlp + " + compositing"),
    )
    kernels = []
    for name, counter, source, replaces, path, err, shape, what in summary:
        ms = device_ms.get(name)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "status": "ported", "launches": paths[path][counter], "launches_path": path,
            "launches_by_path": {p: c[counter] for p, c in paths.items()},
            "max_abs_err": err, "ms": ms if ms is not None else t_call[name],
            "ms_from": "profiler" if ms is not None else "events", "call_ms": t_call[name],
            "plain_ms": t_plain[name], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None, "library_note": f"{no_library} ({what})", "shape": shape})
        if name in WGMMA:
            kernels[-1].update(
                cuda_kernel=WGMMA[name],
                design="warpgroup wgmma m64n256k16 / m64n128k16, activations in registers "
                       "(RS form), a producer warp streaming the weights by cp.async.bulk "
                       "into an mbarrier ring, persistent blocks (grid = SMs)",
                l2_probe_bytes_per_s=l2_probe["bytes_per_s"])
        if name in WGMMA_COMPOSITED:
            ck = WGMMA_COMPOSITED[name]
            in_frame = {"bf16": device_ms.get(f"fused_hierarchical {ck}"),
                        "int8": device_ms.get(f"compressed_frames fused {ck}"),
                        "int16": None, "int8_compute": device_ms.get(f"int8_frames fused {ck}")}
            routes = {}
            for r, ms_frame in in_frame.items():
                t = quant_times[f"{name} {r}"]
                routes[r] = {f: t[f] for f in ("device_ms", "call_ms", "plain_ms")}
                routes[r].update(bound_ms=t["bound"][0], device_ms_in_fused_frame=ms_frame)
            kernels[-1].update(cuda_kernel=ck, design=B9_DESIGN, routes=routes,
                               max_abs_err_quantized_routes=quant_err["b9"])
    kernels[1]["at_192"] = {"call_ms": t_call["composite_192"],
                            "plain_ms": t_plain["composite_192"],
                            "bound_ms": bounds["composite_192"][0]}
    # K2's bodies, and every case timed
    k2_summary = lambda res: {k: {f: v[f] for f in ("ms", "bound_ms", "bound_share", "chunks")}
                              for k, v in res.items()}
    kernels[1].update(
        cuda_kernel=K2_KERNEL, design=K2_DESIGN,
        shape=f"{CHUNK} rays x {SPP} samples, f32, without weights (the benchmark frame)",
        launch_floor_ms=k2_floor,
        cases={"f32": k2_summary(k2_f32), "bf16": k2_summary(k2_bf16),
               "order": "two turns; device ms by the profiler"})
    # the accel engine's paths (its K3 at the accel frames' sample counts,
    # K2 after it, K4 in its bake), and K3 at one depth per ray
    accel_paths = lambda counter: {p: c[counter] for p, c in paths.items()
                                   if p.startswith("accel")}
    kernels[1]["launches_accel"] = accel_paths("composite")
    kernels[4].update(launches_accel=accel_paths("render_zvals_composited"),
                      at_accel={ACCEL_SPP[-1]: {"samples": ACCEL_SPP[-1],
                                                "ms": rf["k3_composited_device_ms_per_launch"],
                                                "ms_from": "profiler, in the fused accel frame"}})
    kernels[2].update(
        launches_accel=accel_paths("render_zvals"),
        at_accel={spp: {"samples": spp, "ms": device_ms.get(f"accel_{spp} render_zvals"),
                        "ms_from": "profiler, in the accel frame", "bound_ms": k3_bounds[spp],
                        "launches": paths[f"accel_{spp}"]["render_zvals"]} for spp in ACCEL_SPP},
        one_depth_per_ray={"entry": f"{K4_KERNEL} of the route's build, then {K2_KERNEL}",
                           "routes": ["bf16", *(r for r, _, _ in ROUTES)],
                           "forms": ["raw", "bf16 raw", "planar", "composited"],
                           "max_abs_err": c1_err})
    kernels[2]["differentiable"] = {
        "function": "render_kernel.fused_render_zvals: forward K3; backward K5 (reference "
                    "variant) or autograd of apply_nerf (bmild)",
        "path": "render_zvals", "rays_x_samples": f"{ZV_RAYS} x {S3}",
        "launches": {k: paths["render_zvals"][k] for k in ("render_zvals", "bwd_rows", "wgrad")},
        **{v: {k: zv_res[v][k] for k in ("fwd_bwd_ms", "plain_autograd_fwd_bwd_ms", "forward_ms",
                                         "bound_ms", "device_busy_ms", "device_ms_by_kernel")}
           for v in ("reference", "bmild")}}
    # the kernels of the training slice, at the train step's fine pass
    # (393,216 samples) and at a 16,384 x 128 chunk of the uniform fine pass
    new_summary = (
        ("mlp_forward", rw, "nerf_tpu/ops/mlp_kernel.py:410",
         "train", k4_err, N_FINE_TRAIN, f"{N_FINE_TRAIN} samples, bf16",
         f"{no_library} (encoding + the 10-layer MLP per sample)"),
        ("mlp_backward", "nerf_tpu_torch/csrc/mlp_backward_wgmma.cu",
         "nerf_tpu/ops/train_kernel.py:53",
         "train", k5_err, N_FINE_TRAIN, f"{N_FINE_TRAIN} samples, bf16, reference variant",
         "library_ms is the backward of bf16 autograd through apply_nerf on the same "
         "samples: a chain of library products, not one call, and without the forward "
         "recompute the kernel includes"),
        ("composite_planar", "nerf_tpu_torch/csrc/composite.cu",
         "nerf_tpu/ops/composite_kernel.py:45", "uniform_hierarchical", k6_err, CHUNK * N_FINE,
         f"{CHUNK} rays x {N_FINE} samples, f32, rgb [N,S,3]",
         f"{no_library} (the log-space transmittance scan and its sums)"),
    )
    for name, source, replaces, path, err, n, shape, note in new_summary:
        t = new_times[name][n]
        ms = t["device_ms"]
        counter = "bwd_rows" if name == "mlp_backward" else name   # K5: launches of K5a
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "status": "ported", "launches": paths[path][counter], "launches_path": path,
            "launches_by_path": {p: c[counter] for p, c in paths.items()},
            "max_abs_err": err, "ms": ms if ms is not None else t["call_ms"],
            "ms_from": "profiler" if ms is not None else "events", "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t.get("library_ms"), "library_note": note, "shape": shape}
        if name != "composite_planar":
            c = new_times[name][N_COARSE_TRAIN]
            row["at_coarse_pass"] = {"samples": N_COARSE_TRAIN, "ms": c["device_ms"],
                                     "call_ms": c["call_ms"],
                                     "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
                                     **({"library_ms": c["library_ms"]} if "library_ms" in c
                                        else {})}
        if name == "composite_planar":
            row["retimed_beside_k2"] = {"ms": k6_times["ms"], "turns": k6_times["turns"],
                                        "bound_ms": k6_times["bound"][0],
                                        "from": "kernel_times, the profiler in one trace"}
        if name == "mlp_forward":
            row["launches_accel"] = accel_paths("mlp_forward")
            row["accel_bake"] = {"points": grid_res ** 3, "launches": first["mlp_forward"],
                                 "k4_device_ms": us_b.get(K4_KERNEL, 0.0) / 1e3}
            chunk = {f"{CHUNK}x{S}": {k: quant_times[f"mlp_forward bf16 x{S}"][k] for k in
                                      ("device_ms", "call_ms", "plain_ms")}
                     | {"bound_ms": quant_times[f"mlp_forward bf16 x{S}"]["bound"][0]}
                     for S in (SPP, N_FINE)}
            row.update(cuda_kernel=K4_KERNEL, library=ray_wgmma.LIBRARY, design=K4_DESIGN, at_uniform_chunks=chunk,
                       device_ms_in_uniform_frame=device_ms.get("uniform mlp_forward"),
                       weight_stream="in a train step the prefix of K5's stream, gathered once "
                                     "per network in the forward")
        if name == "mlp_backward":
            row.update(
                cuda_kernels={k: {"launches": paths[path][cnt],
                                  "device_ms_per_call": None if t["device_ms_by_kernel"] is None
                                  else t["device_ms_by_kernel"][k]}
                              for k, cnt in zip(K5_KERNELS, ("bwd_rows", "wgrad"))},
                design="K5a: warpgroup wgmma over the forward recompute and the input "
                       "gradients (pre-transposed weight images), a producer warp "
                       "streaming by cp.async.bulk, persistent blocks, a bf16 scratch; "
                       "K5b: split-K wgmma X^T dY per output tile, fixed-order partials")
            require(paths[path]["wgrad"] > 0, f"wgrad_wgmma_kernel was launched no time on {path}")
        kernels.append(row)
    # the kernels and routes of the compressed slice, at the 16,384-ray chunk
    # (times: kernel_times_quant; launches: the path named)
    quant_summary = (
        ("mlp_quant", rw, "nerf_tpu/ops/quant.py:420",
         "compressed_frames_uniform_hierarchical", "mlp_quant", quant_err["mlp_quant"],
         f"mlp_quant int8 x{N_FINE}", f"{CHUNK} x {N_FINE} samples, int8 weights dequantized "
         "once a call (dequant_stream), bf16 compute"),
        ("int8_mm", rw, "nerf_tpu/ops/quant.py:339",
         "int8_frames_hierarchical", "int8", quant_err["int8"], "render_samples int8_compute",
         f"the s8 x s8 -> s32 trunk inside K1 at {CHUNK} rays x {SPP} samples (also in K3, "
         f"and in K7: at_k7)"),
        ("render_samples_int8_weights", rw, "nerf_tpu/ops/render_kernel.py:50",
         "compressed_frames_hierarchical", "render_samples", quant_err["ray_dequant"],
         "render_samples int8", f"{CHUNK} rays x {SPP} samples, int8 weights dequantized once "
         "a call (dequant_stream)"),
        ("render_zvals_int8_weights", rw, "nerf_tpu/ops/render_kernel.py:50",
         "compressed_frames_hierarchical", "render_zvals", quant_err["ray_dequant"],
         "render_zvals int8", f"{CHUNK} rays x {S3} per-ray depths, int8 weights dequantized "
         "once a call (dequant_stream)"),
        ("render_samples_int16_weights", rw, "nerf_tpu/ops/render_kernel.py:50",
         "compressed16_benchmark", "dequant", quant_err["ray_dequant"], "render_samples int16",
         f"{CHUNK} rays x {SPP} samples, int16 weights dequantized once a call"),
        ("dequant_stream", "nerf_tpu_torch/csrc/dequant_stream.cu", "nerf_tpu/ops/quant.py:273",
         "compressed_frames_hierarchical", "dequant_stream", 0.0, "dequant_stream int8",
         "the reference network's int8 ray stream to bf16, and wsig, wc1, wdir (bit-equal)"),
        ("render_planar", rw, "nerf_tpu/ops/render_kernel.py:74", "planar_hierarchical",
         "planar", quant_err["planar"], "render_zvals planar",
         f"{CHUNK} rays x {S3} per-ray depths, four [R, S] planes out (K1 too)"),
        ("render_raw_bf16", rw, "nerf_tpu/ops/render_kernel.py:402", "raw_bf16_hierarchical",
         "raw_bf16", quant_err["raw_bf16"], "render_zvals raw_bf16",
         f"{CHUNK} rays x {S3} per-ray depths, bf16 raw out (K1 too)"),
        ("composite_raw_bf16", "nerf_tpu_torch/csrc/composite.cu",
         "nerf_tpu/ops/composite_kernel.py:108", "raw_bf16_hierarchical", "composite_bf16",
         quant_err["raw_bf16"], "composite raw_bf16 x192",
         f"{CHUNK} rays x {S3} samples, bf16 raw in, f32 compute"),
    )
    for name, source, replaces, path, counter, err, key, shape in quant_summary:
        t = quant_times[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "status": "ported", "launches": paths[path][counter], "launches_path": path,
            "launches_by_path": {p: c[counter] for p, c in paths.items()},
            "max_abs_err": err,
            "ms": t["device_ms"] if t["device_ms"] is not None else t["call_ms"],
            "ms_from": "profiler" if t["device_ms"] is not None else "events",
            "call_ms": t["call_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None, "library_note": f"{no_library} (the transmittance scan)"
            if "composite" in name else f"{no_library} (encoding + the 10-layer MLP per sample)"
            if name == "mlp_quant" else f"{no_library} (a chunked image and its scales)"
            if name == "dequant_stream" else f"{no_library} ({mlp})",
            "shape": shape, "times_key": key})
        if "library" in t:
            kernels[-1].update(cuda_kernel=t["cuda_kernel"], library=t["library"])
        if name == "mlp_quant":
            kernels[-1].update(design=K4_DESIGN, routes={
                k: {f: quant_times[k][f] for f in ("device_ms", "call_ms", "plain_ms", "library")}
                | {"bound_ms": quant_times[k]["bound"][0]}
                for k in quant_times if k.startswith("mlp_quant")},
                device_ms_in_uniform_frame=device_ms.get(
                    f"compressed_frames uniform {K4_KERNEL}"))
        if name == "int8_mm":
            k7 = quant_times[f"mlp_quant int8_compute x{N_FINE}"]
            kernels[-1]["at_k7"] = {
                "shape": f"{CHUNK} x {N_FINE} samples", "cuda_kernel": K4_KERNEL,
                "library": k7["library"], "ms": k7["device_ms"], "call_ms": k7["call_ms"],
                "bound_ms": k7["bound"][0],
                "launches": paths["int8_frames_uniform_hierarchical"]["mlp_quant_int8"],
                "device_ms_in_uniform_frame": device_ms.get(f"int8_frames uniform {K4_KERNEL}")}
    # the accel engine's depths: no TPU kernel (the JAX package's is jnp)
    kernels.append({
        "name": "occupancy_z_vals", "route": "cuda", "source": "nerf_tpu_torch/csrc/occupancy.cu",
        "replaces": "none: nerf_tpu/ops/occupancy.py grid_guided_z_vals is jnp (about 70 ATen "
                    "launches a chunk in eager PyTorch)",
        "status": "new", "cuda_kernel": OCC_KERNEL, "launches": paths["accel_32"]["occupancy"],
        "launches_path": "accel_32",
        "launches_by_path": {p: c["occupancy"] for p, c in paths.items()},
        "max_abs_err": max(e["max_abs"] for e in z_err.values()),
        "ms": occ_times["device_ms"] if occ_times["device_ms"] is not None
        else occ_times["call_ms"],
        "ms_from": "profiler" if occ_times["device_ms"] is not None else "events",
        "call_ms": occ_times["call_ms"], "plain_ms": occ_times["plain_call_ms"],
        "plain_device_ms": occ_times["plain_device_ms"], "bound_ms": occ_times["bound_ms"],
        "bound_by": occ_times["bound_by"], "library_ms": None,
        "library_note": f"{no_library} (probes, weights, a CDF and its inverse a group)",
        "design": "a warp a stride group: a lane a run of probes, warp scans for the CDF in "
                  "shared memory, a binary search a draw, the depth to each row of the group",
        "shape": f"{CHUNK} rays, stride 4, {ACCEL_SPP[1]} depths"})
    for row in kernels:
        require(row["launches"] > 0, f"{row['name']} was launched no time on {row['launches_path']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    # last, so that its full-size plain versions and frames leave nothing
    # behind for the phases above
    mip360_phase(dev, smi)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        child_main(sys.argv[2:])
    else:
        main()
