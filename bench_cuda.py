#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: 800x600 @ 64 samples/ray
through ``CudaEngine`` (K1 -> K2) on one CUDA device.

    python3 bench_cuda.py [--weights PATH]

Prints ONE JSON line on stdout:
  {"metric": "rays_per_second", "value": N, "unit": "rays/s",
   "vs_baseline": N / 21238}

The counterpart of ``bench.py``, with its baseline (the reference's best
backend, PyTorch MPS on M3 Pro, 22.6 s a frame at the same configuration),
its weights rule (the bmild network on the original-NeRF lego weights where
that file exists, else the reference network on random weights from seed 0),
its poses (``spherical_pose(30 + 17 i, -30, 4)``, i = 0..3, focal from the
lego camera angle) and its value (the median of views 1..3 after the warm
view 0). The lego weights are looked for at
``data/lego_example_weights/model_fine_200000.npy`` in the repository, or
at ``--weights``. Progress goes to stderr, and with it one frame of the
bmild network on seeded random weights (its stream carries a bottleneck
layer more than the reference network's), so that a frame of either
package's bmild network can be set beside it. Without a CUDA device it
raises: it never renders on the CPU.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_RAYS_PER_S = 800 * 600 / 22.6   # the reference's MPS full frame
LEGO = os.path.join(ROOT, "data", "lego_example_weights", "model_fine_200000.npy")
CAMERA_ANGLE_X = 0.6911112070083618      # the lego scene's camera


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(device="cuda", width=800, height=600, spp=64, weights=LEGO) -> dict:
    """The headline on ``device`` at ``width x height @ spp``: the JSON
    line's dict. Logs each view and the bmild frame to stderr."""
    from nerf_tpu_torch.config import bmild_config, default_config
    from nerf_tpu_torch.render.engines import CudaEngine, SharedModel
    from nerf_tpu_torch.utils.cameras import focal_from_angle, spherical_pose
    from nerf_tpu_torch.utils.monitor import device_info_string

    if os.path.exists(weights):
        cfg, ckpt = bmild_config(), weights
    else:
        cfg, ckpt = default_config(), None
    shared = SharedModel(cfg, device).load(ckpt)
    engine = CudaEngine(shared, chunk_rays=16384)
    focal = focal_from_angle(width, CAMERA_ANGLE_X)
    poses = [spherical_pose(30.0 + 17.0 * i, -30.0, 4.0) for i in range(4)]
    res = (width, height)

    log(f"device: {device_info_string(shared.device)}  config: {width}x{height}@{spp}  "
        f"network: {cfg.model.variant} on {ckpt or 'random weights (seed 0)'}")
    t0 = time.perf_counter()
    # the warm view: the first frame of each shape loads the kernels, and
    # the monitor renders it once untimed before its timed frame
    engine.render_image(poses[0], res, spp, focal=focal)
    log(f"warm view 0 (load + first render): {time.perf_counter() - t0:.1f}s")

    times = []
    for i, pose in enumerate(poses[1:], 1):
        out = engine.render_image(pose, res, spp, focal=focal)
        t = out.stats.wall_time_s
        times.append(t)
        log(f"view {i}: {t * 1e3:.2f} ms ({width * height / t:,.0f} rays/s) "
            f"rgb mean {out.rgb.mean():.3f}")

    bmild = CudaEngine(SharedModel(bmild_config(), device).load(None), chunk_rays=16384)
    out = bmild.render_image(poses[1], res, spp, focal=focal)
    t = out.stats.wall_time_s
    log(f"bmild frame (seeded random weights): {t * 1e3:.2f} ms "
        f"({width * height / t:,.0f} rays/s)")

    rays_per_s = width * height / float(np.median(times))
    return {
        "metric": "rays_per_second",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 2),
    }


def main(argv=None) -> int:
    from nerf_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--weights", default=LEGO,
                        help="bmild-format lego weights (.npy); random weights where absent")
    args = parser.parse_args(argv)
    resolve_device("cuda")     # raises without a CUDA device
    print(json.dumps(run("cuda", weights=args.weights)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
