"""Closed-loop Mip-NeRF frames: ``render_loop``'s window, reservoir and
metric names (``render_rays_per_s``, ``frame_ms_p90``, ``setup_s``) on the
mip variant, held against ``reference/mip.py``.

Set-up checks that the port has the mip path (a port without it exits
non-zero at once), draws the one network from the run's seed
(``reference.mip.seeded_weights``: coarse and fine share it), builds the
engine the workload names and renders ``warm_frames`` frames. The window
calls ``Engine.render_image`` in the hierarchical mode on the seed's poses
(``traffic.poses``) until ``seconds`` have passed, timing each frame from
the call until its image is on the host. The traced part's operations are
``flops_mip.frame_flops``. After the window the engine runs its passes
again (``CudaEngine.mip_passes``) on ``check.probe_rays`` rays drawn from
each checked frame, keeping the fine edges and the fine pass's raw
outputs. With the engine freed, the reference renders the reservoir's
frames again (products on operands rounded as the configuration states,
float32 sums) and the probe rays' fine pass; the worst frame's gaps
(``render_loop.gaps`` and ``probe_gaps``) are held against the workload's
limits. The probe sees the fine pass, which the image alone barely shows
on seeded weights (a nearly uniform density): the resampler's edges, and
K3-mip at the edges it is given.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from nerfbench import flops_mip, harness, traffic, trace
from nerfbench.reference import mip as ref_mip
from nerfbench.reference import nerf as ref_nerf
from nerfbench.reference.render import camera_rays


def require_mip_path():
    """Raise ``SystemExit`` unless the port renders the mip variant."""
    try:
        from nerf_tpu_torch.config import ModelConfig
        from nerf_tpu_torch.ops.render_kernel import fused_render_edges_mip_raw  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"nerfbench: the port has no mip path ({e})")
    if "ipe_max_deg" not in ModelConfig.__dataclass_fields__:
        raise SystemExit("nerfbench: the port's ModelConfig has no mip variant")


def nets_of(config: dict, seed: int, device) -> dict:
    spec = config["weights"]
    if spec["kind"] != "seeded" or spec["recipe"] != "glorot_uniform":
        raise SystemExit(f"no mip weights of kind {spec['kind']!r}")
    net = ref_mip.seeded_weights(config["model"], seed, device)
    return {"coarse": net, "fine": net}


def reference_frames(workload: dict, config: dict, net: dict, frames, rnd="config"):
    """The reference's ``(rgb, depth)`` of each pose in ``frames``, its
    products on operands rounded as the configuration states (``rnd``:
    another rounding, the control's; None: float32 products)."""
    if rnd == "config":
        rnd = ref_nerf.rounding_of(config)
    ref_nerf.disable_tf32()
    torch.set_float32_matmul_precision("highest")
    w, h = traffic.resolution(workload)
    focal = traffic.focal_from_angle(w, workload["camera_angle_x"])
    n = None if workload["mode"] == "hierarchical" else workload["samples_per_ray"]
    out = []
    for pose in frames:
        rgb, depth = ref_mip.frame(net, pose, w, h, focal, config["model"], config["render"],
                                   rnd, n)
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
    return ro[pick.to(ro.device)], rd[pick.to(ro.device)]


def reference_probe(workload: dict, config: dict, net: dict, ro, rd, rnd="config", at=None):
    """The reference's fine pass of the rays: ``(edges [N, S + 1], raw [N,
    S, 4])``, its own fine edges and its ``(density, r, g, b)`` at the edges
    ``at`` (its own where None)."""
    if rnd == "config":
        rnd = ref_nerf.rounding_of(config)
    ref_nerf.disable_tf32()
    w, _ = traffic.resolution(workload)
    focal = traffic.focal_from_angle(w, workload["camera_angle_x"])
    with torch.no_grad():
        edges, density, rgb = ref_mip.fine_pass(net, ro, rd, ref_mip.radius(focal),
                                                config["model"], config["render"], rnd, at)
    return edges, torch.cat([density[..., None], rgb], dim=-1)


def probe_gaps(probes, refs) -> dict:
    """The worst checked frame's probe gaps: ``edges_p999_abs``, the 99.9th
    percentile of the fine edges' absolute error (scene units along the
    ray), and ``fine_raw_p999_abs``, of the fine pass's raw ``(density, r,
    g, b)`` against the reference's network at the program's own fine
    edges. ``probes``: the program's ``(edges [N, S + 1], raw [N, 4S])``;
    ``refs``: ``reference_probe``'s, at those edges."""
    out = {"edges_p999_abs": 0.0, "fine_raw_p999_abs": 0.0}
    for (edges, raw), (r_edges, r_raw) in zip(probes, refs):
        for key, a, b in (("edges_p999_abs", edges, r_edges), ("fine_raw_p999_abs", raw, r_raw)):
            e = (a.double().reshape(-1) - b.double().reshape(-1)).abs().cpu().numpy()
            out[key] = max(out[key], float(np.quantile(e, 0.999)))
    return out


def run(workload: dict, config: dict, seed: int, seconds: float, trace_on: bool, device,
        t_start: float) -> harness.Outcome:
    require_mip_path()
    from nerf_tpu_torch.render.engines import ENGINE_CLASSES, SharedModel
    from nerf_tpu_torch.utils.cameras import pixel_radius

    loop = harness.driver("render_loop")
    dev = torch.device(device)
    cfg = harness.program_config(config, seed)
    nets = nets_of(config, seed, dev)
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
        traced = harness.Traced(tr, n, flops_mip.frame_flops(config["model"], w * h,
                                                             config["render"]))

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    sample = sorted(kept.items, key=lambda it: it[0])
    t_check = time.perf_counter()
    probes = []
    with torch.no_grad():
        for k, _, _ in sample:
            ro, rd = probe_rays(workload, seq[k % len(seq)], seed + k, dev)
            _, edges, raw = engine.mip_passes(engine.engine_params()["fine"], ro, rd, spp,
                                              cfg.render, mode, pixel_radius(focal))
            probes.append((ro, rd, edges.float(), raw.float()))
    del engine, shared
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    refs = reference_frames(workload, config, nets["fine"],
                            [seq[k % len(seq)] for k, _, _ in sample])
    values = loop.gaps([(rgb, depth) for _, rgb, depth in sample], refs)
    values.update(probe_gaps(
        [(edges, raw) for _, _, edges, raw in probes],
        [reference_probe(workload, config, nets["fine"], ro, rd, at=edges)
         for ro, rd, edges, _ in probes]))
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
