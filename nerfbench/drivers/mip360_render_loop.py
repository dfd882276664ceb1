"""Closed-loop Mip-NeRF 360 frames: ``render_loop``'s window, reservoir and
metric names (``render_rays_per_s``, ``frame_ms_p90``, ``setup_s``) on the
mip360 variant, held against ``reference/mip360.py``.

Set-up checks that the port has the mip360 path (a port without it exits
non-zero at once) and that the workload names no ``samples_per_ray`` (each
level's intervals are the configuration's ``n_coarse`` and ``n_fine``), builds the three libraries the path runs at once, draws
both networks from the run's seed (``reference.mip360.seeded_weights``:
the proposal network as ``coarse``, the NeRF network as ``fine``), builds
the engine the workload names and renders ``warm_frames`` frames. The
window calls ``Engine.render_image`` in the hierarchical mode on the seed's
poses (``traffic.poses``) until ``seconds`` have passed, timing each frame
from the call until its image is on the host. The traced part's
operations are ``flops_mip360.frame_flops``. After the window the engine
runs its levels again (``CudaEngine.mip360_passes``) on ``check.probe_rays``
rays drawn from each checked frame, keeping the last proposal level's
weights, the NeRF level's normalized edges and its raw outputs. With the
engine freed, the reference renders the reservoir's frames again (products
on operands rounded as the configuration states, float32 sums) and the
probe rays' levels, the NeRF level at the program's own edges; the worst
frame's gaps (``render_loop.gaps``' ``rgb_p999_abs`` and ``probe_gaps``)
are held against the workload's limits. On seeded weights the image alone
barely shows the levels before the last: the probe sees the proposal
network through its weights, the sampler through the edges, and the NeRF
pass at the edges it is given.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from nerfbench import flops_mip360, harness, traffic, trace
from nerfbench.reference import mip360 as ref_360
from nerfbench.reference import nerf as ref_nerf
from nerfbench.reference.mip import radius as ref_radius
from nerfbench.reference.render import camera_rays

LIBRARIES = ("ray_wgmma", "composite", "mip360_wgmma")


def require_mip360_path():
    """Raise ``SystemExit`` unless the port renders the mip360 variant."""
    try:
        from nerf_tpu_torch.config import mip360_config  # noqa: F401
        from nerf_tpu_torch.render.engines import CudaEngine
    except ImportError as e:
        raise SystemExit(f"nerfbench: the port has no mip360 path ({e})")
    if not hasattr(CudaEngine, "mip360_passes"):
        raise SystemExit("nerfbench: the port's CudaEngine has no mip360 path")


def nets_of(config: dict, seed: int, device) -> dict:
    """The reference's networks ``{'prop', 'nerf'}`` from the seed."""
    spec = config["weights"]
    if spec["kind"] != "seeded" or spec["recipe"] != "he_uniform":
        raise SystemExit(f"no mip360 weights of kind {spec['kind']!r}")
    return ref_360.seeded_weights(config["model"], seed, device)


def reference_frames(workload: dict, config: dict, nets: dict, frames, rnd="config"):
    """The reference's ``(rgb, depth)`` of each pose in ``frames``, its
    products on operands rounded as the configuration states (``rnd``:
    another rounding, the control's; None: float32 products)."""
    if rnd == "config":
        rnd = ref_nerf.rounding_of(config)
    ref_nerf.disable_tf32()
    torch.set_float32_matmul_precision("highest")
    w, h = traffic.resolution(workload)
    focal = traffic.focal_from_angle(w, workload["camera_angle_x"])
    out = []
    for pose in frames:
        rgb, depth = ref_360.frame(nets, pose, w, h, focal, config["model"], config["render"],
                                   rnd)
        out.append((rgb.cpu().numpy(), depth.cpu().numpy()))
    return out


def probe_rays(workload: dict, pose, seed: int, device):
    """``check.probe_rays`` of the frame's rays (``ro, rd [N, 3]``), drawn
    from ``seed``."""
    w, h = traffic.resolution(workload)
    ro, rd = camera_rays(pose, w, h, traffic.focal_from_angle(w, workload["camera_angle_x"]),
                         device)
    g = torch.Generator().manual_seed(seed)
    pick = torch.randperm(ro.shape[0], generator=g)[:workload["check"]["probe_rays"]]
    return ro[pick.to(ro.device)].contiguous(), rd[pick.to(ro.device)].contiguous()


def reference_probe(workload: dict, config: dict, nets: dict, ro, rd, rnd="config", at=None):
    """The reference's levels on the rays: ``(w [N, n_coarse], s [N, n_fine
    + 1], raw [N, n_fine, 4])``, the last proposal level's weights, its own
    NeRF-level normalized edges and the NeRF level's ``(density, r, g, b)``
    at the normalized edges ``at`` (its own where None)."""
    if rnd == "config":
        rnd = ref_nerf.rounding_of(config)
    w, _ = traffic.resolution(workload)
    focal = traffic.focal_from_angle(w, workload["camera_angle_x"])
    return ref_360.probe(nets, ro, rd, ref_radius(focal), config["model"], config["render"], rnd,
                         at_s=at)


def probe_gaps(probes, refs) -> dict:
    """The worst checked frame's probe gaps, each the 99.9th percentile of an
    absolute error: ``prop_weights_p999_abs`` of the last proposal level's
    weights, ``edges_p999_abs`` of the NeRF level's normalized edges (the
    unit interval of disparity), ``nerf_raw_p999_abs`` of the NeRF level's
    raw ``(density, r, g, b)`` against the reference's network at the
    program's own edges. ``probes``: the program's ``(w, s, raw [N, 4S])``;
    ``refs``: ``reference_probe``'s, the raw at the program's edges."""
    keys = ("prop_weights_p999_abs", "edges_p999_abs", "nerf_raw_p999_abs")
    out = dict.fromkeys(keys, 0.0)
    for prog, ref in zip(probes, refs):
        for key, a, b in zip(keys, prog, ref):
            e = (a.double().reshape(-1) - b.double().reshape(-1)).abs().cpu().numpy()
            out[key] = max(out[key], float(np.quantile(e, 0.999)))
    return out


def run(workload: dict, config: dict, seed: int, seconds: float, trace_on: bool, device,
        t_start: float) -> harness.Outcome:
    require_mip360_path()
    if "samples_per_ray" in workload:
        raise SystemExit("mip360_render_loop: each level's intervals are the configuration's "
                         "n_coarse and n_fine; the workload names no samples_per_ray")
    from nerf_tpu_torch.ops import _ext
    from nerf_tpu_torch.render.engines import ENGINE_CLASSES, SharedModel
    from nerf_tpu_torch.utils.cameras import pixel_radius

    loop = harness.driver("render_loop")
    dev = torch.device(device)
    if dev.type == "cuda":
        _ext.build(LIBRARIES)
    cfg = harness.program_config(config, seed)
    nets = nets_of(config, seed, dev)
    shared = SharedModel(cfg, device=dev)
    shared.params = {"coarse": nets["prop"], "fine": nets["nerf"]}
    engine = ENGINE_CLASSES[workload["engine"]](shared, **workload.get("engine_args", {}))
    w, h = traffic.resolution(workload)
    focal = traffic.focal_from_angle(w, workload["camera_angle_x"])
    spp, mode = cfg.render.n_coarse, workload["mode"]
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
    kept = loop.Reservoir(workload["check"]["frames"], seed)
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
        traced = harness.Traced(tr, n, flops_mip360.frame_flops(config["model"], w * h,
                                                                config["render"]))

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    sample = sorted(kept.items, key=lambda it: it[0])
    t_check = time.perf_counter()
    probes = []
    with torch.no_grad():
        for k, _, _ in sample:
            ro, rd = probe_rays(workload, seq[k % len(seq)], seed + k, dev)
            _, s, raw, wts = engine.mip360_passes(engine.engine_params(), ro, rd, cfg.render,
                                                  pixel_radius(focal))
            probes.append((ro, rd, (wts.float(), s.float(), raw.float())))
    del engine, shared
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    refs = reference_frames(workload, config, nets, [seq[k % len(seq)] for k, _, _ in sample])
    values = loop.gaps([(rgb, depth) for _, rgb, depth in sample], refs)
    values.update(probe_gaps(
        [prog for _, _, prog in probes],
        [reference_probe(workload, config, nets, ro, rd, at=prog[1]) for ro, rd, prog in probes]))
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
