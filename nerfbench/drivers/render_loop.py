"""Closed-loop frames: one viewer asks for the next frame when the last is
on the host.

Set-up loads the configuration's weights, builds the engine the workload
names, and renders ``warm_frames`` frames
(the first builds and loads the kernels, and the accel engine bakes its
grid). The window then calls ``Engine.render_image`` on the seed's poses
until ``seconds`` have passed, timing each frame from the call until its
image is on the host. A seeded reservoir keeps ``check.frames`` of the
window's frames; after the window, with the engine freed, the plain
reference renders them again and the worst frame's gaps are held against
the workload's limits. The reference rounds each product's operands to the
configuration's ``compute_dtype`` and sums in float32, as the configuration
states.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from nerfbench import flops, harness, traffic, trace
from nerfbench.reference import nerf as ref_nerf
from nerfbench.reference import quant as ref_quant
from nerfbench.reference import render as ref_render


def frame_kind(workload: dict) -> str:
    if workload["mode"] == "hierarchical":
        return "hierarchical"
    return "accel" if workload["engine"] == "accel" else "uniform"


def reference_nets(workload: dict, config: dict, nets: dict, bits=None):
    """The networks the reference renders with: the compressed engine's
    pruned, quantized weights where the workload runs it (``bits``: another
    width, the control's)."""
    q = workload.get("engine_args") if workload["engine"] == "compressed" else None
    if q is None and bits is None:
        return nets
    q = {"bits": 8, "prune_fraction": 0.0, **(q or {})}
    if bits is not None:
        q["bits"] = bits
    return ref_quant.compressed(nets, config["model"], q["bits"], q["prune_fraction"])


def reference_frames(workload: dict, config: dict, nets: dict, frames, rnd="config",
                     bits=None):
    """The reference's ``(rgb, depth)`` of each pose in ``frames``, its
    products on operands rounded as the configuration states (``rnd``:
    another rounding, the control's)."""
    if rnd == "config":
        rnd = ref_nerf.rounding_of(config)
    ref_nerf.disable_tf32()
    torch.set_float32_matmul_precision("highest")
    w, h = traffic.resolution(workload)
    focal = traffic.focal_from_angle(w, workload["camera_angle_x"])
    kind = frame_kind(workload)
    nets = reference_nets(workload, config, nets, bits)
    grid = None
    if kind == "accel":
        with torch.no_grad():
            grid = ref_render.bake_grid(nets["fine"], config["model"], config["accel"], rnd)
    out = []
    for pose in frames:
        rgb, depth = ref_render.frame(kind, nets, pose, w, h, focal, config["model"],
                                      config["render"], workload["samples_per_ray"], rnd,
                                      grid, config.get("accel"))
        out.append((rgb.cpu().numpy(), depth.cpu().numpy()))
    return out


def gaps(frames, refs) -> dict:
    """The worst checked frame's gaps to the reference: ``rgb_p999_abs``, the
    99.9th percentile of the absolute rgb error over the frame's pixels and
    channels (the number the limit holds; a few pixels where a thin feature
    falls between two samples differ by aliasing at any precision, which
    would set an RMS or a largest error), and, recorded beside it, the rgb
    RMS, the largest rgb error and the depth RMS relative to the reference's
    mean depth."""
    out = {"rgb_p999_abs": 0.0, "rgb_rmse": 0.0, "rgb_max_abs": 0.0, "depth_rel_rmse": 0.0}
    for (rgb, depth), (r_rgb, r_depth) in zip(frames, refs):
        e = np.abs(rgb.astype(np.float64) - r_rgb).reshape(-1)
        d = depth.astype(np.float64) - r_depth
        out["rgb_p999_abs"] = max(out["rgb_p999_abs"], float(np.quantile(e, 0.999)))
        out["rgb_rmse"] = max(out["rgb_rmse"], float(np.sqrt(np.mean(e * e))))
        out["rgb_max_abs"] = max(out["rgb_max_abs"], float(e.max()))
        out["depth_rel_rmse"] = max(out["depth_rel_rmse"], float(
            np.sqrt(np.mean(d * d)) / max(float(np.abs(r_depth).mean()), 1e-12)))
    return out


class Reservoir:
    """A uniform sample of ``k`` of the frames offered, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, np.random.default_rng(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


def run(workload: dict, config: dict, seed: int, seconds: float, trace_on: bool, device,
        t_start: float) -> harness.Outcome:
    from nerf_tpu_torch.render.engines import ENGINE_CLASSES, SharedModel

    dev = torch.device(device)
    cfg = harness.program_config(config, seed)
    nets = harness.weights(config, dev, seed)
    shared = SharedModel(cfg, device=dev)
    shared.params = nets
    engine = ENGINE_CLASSES[workload["engine"]](shared, **workload.get("engine_args", {}))
    w, h = traffic.resolution(workload)
    focal = traffic.focal_from_angle(w, workload["camera_angle_x"])
    spp, mode = workload["samples_per_ray"], workload["mode"]
    seq = traffic.poses(seed, workload["max_frames"], workload)

    def render(k):
        with record_function("Engine.render_image"):
            res = engine.render_image(seq[k % len(seq)], (w, h), spp, focal, mode,
                                      monitor=False)
        return res.rgb, res.depth

    for k in range(workload["warm_frames"]):
        render(k)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # the window
    kept = Reservoir(workload["check"]["frames"], seed)
    lat = []
    t_begin = time.perf_counter()
    setup_s = time.time() - t_start
    while True:
        t0 = time.perf_counter()
        rgb, depth = render(len(lat))
        t1 = time.perf_counter()
        kept.offer((len(lat), rgb, depth))
        lat.append(t1 - t0)
        if t1 - t_begin >= seconds:
            break
    window_s = t1 - t_begin

    traced = None
    if trace_on:
        n = workload["trace_frames"]
        _, tr, _ = trace.traced(lambda: [render(len(lat) + k) for k in range(n)],
                                trace.port_kernels(harness.PACKAGE))
        per_frame = flops.frame_flops(config["model"], frame_kind(workload), w * h, spp,
                                      config["render"])
        traced = harness.Traced(tr, n, {**per_frame, "total": sum(per_frame.values())})

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, shared
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    sample = sorted(kept.items, key=lambda it: it[0])
    t_check = time.perf_counter()
    refs = reference_frames(workload, config, nets, [seq[k % len(seq)] for k, _, _ in sample])
    values = gaps([(rgb, depth) for _, rgb, depth in sample], refs)
    return harness.Outcome(
        metrics={"render_rays_per_s": len(lat) * w * h / window_s,
                 "frame_ms_p90": float(np.percentile(np.asarray(lat) * 1e3, 90)),
                 "setup_s": setup_s},
        attempted=len(lat), failed=0,
        checks=harness.checks(values, workload["check"]["limits"]),
        memory_peak_bytes=int(peak), traced=traced,
        notes={"frames": len(lat), "window_s": window_s, "checked_frames": [k for k, _, _ in sample],
               "gaps": values, "check_s": time.perf_counter() - t_check,
               "rgb_std_first_checked": float(sample[0][1].std())})
