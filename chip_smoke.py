#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nerf_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``nerf_tpu_torch/csrc`` (into ``build/``),
holds each kernel against its plain PyTorch version at the main path's
shapes, renders the benchmark frame (800x600 @ 64 samples, trained weights
from ``results/convergence/final_params.npz``) through ``CudaEngine``,
checks that every chunk went through both kernels, and compares the frame
with the plain PyTorch engine. Each phase prints one JSON line. The last
three lines are the per-kernel summary, the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": ...}``. Any failed
check exits non-zero before that last line. Needs a CUDA device and
``nvcc`` (sm_90a); it has no CPU path.
"""

import dataclasses
import json
import math
import os
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, "results", "convergence", "final_params.npz")
W, H, SPP, CHUNK = 800, 600, 64, 16384
CAMERA_ANGLE_X = 0.6911112070083618
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 rate
K1_TOL = 2e-2                 # rgb abs; sigma relative to max|sigma|
K2_TOL = 1e-5                 # rgb/acc abs; depth relative to max|depth|
PSNR_MIN = 40.0


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


def bound_ms(flops, nbytes_, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def camera_rays(pose, focal, dev, n, seed):
    from nerf_tpu_torch.utils.cameras import generate_rays

    ro, rd = generate_rays(pose, W, H, focal, dev)
    idx = torch.randperm(W * H, generator=torch.Generator().manual_seed(seed))[:n]
    return ro.reshape(-1, 3)[idx.to(dev)].contiguous(), rd.reshape(-1, 3)[idx.to(dev)].contiguous()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    from nerf_tpu_torch.config import default_config, bmild_config
    from nerf_tpu_torch.models.nerf import init_nerf_params, params_from_numpy
    from nerf_tpu_torch.ops import _ext, composite_kernel, render_kernel
    from nerf_tpu_torch.ops.mlp_kernel import pack_params
    from nerf_tpu_torch.render.engines import CudaEngine, SharedModel, TorchEngine
    from nerf_tpu_torch.train.checkpoint import restore_bare_params
    from nerf_tpu_torch.utils.cameras import focal_from_angle, spherical_pose

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ---------------------------------------------------------------
    secs = _ext.build()
    ptxas = {n: [ln.strip() for ln in _ext.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in _ext.SOURCES}
    emit("build", seconds=secs, sources=list(_ext.SOURCES), ptxas=ptxas)

    white = lambda c: dataclasses.replace(
        c, render=dataclasses.replace(c.render, white_background=True))
    f32 = lambda c: dataclasses.replace(
        c, train=dataclasses.replace(c.train, compute_dtype="float32"))
    cfg_ref = white(default_config())
    fine = params_from_numpy(restore_bare_params(PARAMS)["fine"], dev)
    focal = focal_from_angle(W, CAMERA_ANGLE_X)
    poses = [spherical_pose(30.0 + 17.0 * i, -30.0, 4.0) for i in range(4)]
    rcfg = cfg_ref.render

    # -- K1: kernel vs plain, both variants --------------------------------
    k1_err = {}
    cfg_bm = bmild_config()
    variants = (
        ("reference", cfg_ref.model, fine),
        ("bmild", cfg_bm.model,
         init_nerf_params(torch.Generator().manual_seed(1), cfg_bm.model, dev)),
    )
    n_check = 1001                    # 1001 * 64 samples: last tile partial
    for name, mcfg, params in variants:
        packed = pack_params(params, mcfg, torch.bfloat16)
        ro, rd = camera_rays(poses[0], focal, dev, n_check - 3, seed=0)
        ro = torch.cat([ro, torch.zeros(3, 3, device=dev)])     # padding rays
        rd = torch.cat([rd, torch.ones(3, 3, device=dev)])
        raw_k, _ = render_kernel.fused_render_samples(packed, ro, rd, 2.0, 6.0, SPP, mcfg, raw=True)
        raw_p = render_kernel.fused_render_samples_plain(packed, ro, rd, 2.0, 6.0, SPP, mcfg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(raw_k).all()), f"K1 {name}: non-finite output")
        sk, sp = raw_k[:, 0::4], raw_p[:, 0::4]
        rgb_err = (raw_k.reshape(-1, 4)[:, 1:] - raw_p.reshape(-1, 4)[:, 1:]).abs().max().item()
        sig_scale = sp.abs().max().item()
        sig_err = (sk - sp).abs().max().item() / max(sig_scale, 1e-6)
        k1_err[name] = rgb_err
        emit("k1_check", variant=name, rays=n_check, samples=SPP, rgb_max_abs_err=rgb_err,
             sigma_max_rel_err=sig_err, max_abs_sigma=sig_scale, tol=K1_TOL)
        require(rgb_err <= K1_TOL and sig_err <= K1_TOL,
                f"K1 {name}: rgb err {rgb_err}, sigma rel err {sig_err} > {K1_TOL}")

    # -- K2: kernel vs plain -------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(2)
    n2 = CHUNK
    sigma = torch.rand(n2, SPP, device=dev, generator=g) * 50.0
    sigma[:, ::7] = 0.0
    sigma[::5, SPP // 2] = 1e6                                   # opaque samples
    rgb = torch.rand(n2, SPP, 3, device=dev, generator=g)
    raw2 = torch.cat([sigma[..., None], rgb], -1).reshape(n2, 4 * SPP).contiguous()
    z2 = torch.sort(2.0 + 4.0 * torch.rand(n2, SPP, device=dev, generator=g), dim=-1).values
    d2 = torch.randn(n2, 3, device=dev, generator=g)
    k2_err = 0.0
    for zz in (z2, torch.linspace(2.0, 6.0, SPP, device=dev).expand(n2, SPP)):
        out_k, w_k = composite_kernel._launch(raw2, zz, d2, rcfg.dist_sentinel, rcfg.transmittance_eps)
        out_p, w_p = composite_kernel.fused_volume_render_interleaved_plain(
            raw2, zz, d2, rcfg.dist_sentinel, rcfg.transmittance_eps)
        torch.cuda.synchronize()
        e_rgb_acc = (out_k[:, [0, 1, 2, 4]] - out_p[:, [0, 1, 2, 4]]).abs().max().item()
        e_depth = ((out_k[:, 3] - out_p[:, 3]).abs().max() / out_p[:, 3].abs().max()).item()
        e_w = (w_k - w_p).abs().max().item()
        k2_err = max(k2_err, e_rgb_acc)
        emit("k2_check", rays=n2, samples=SPP, z="broadcast" if zz.stride(0) == 0 else "per-ray",
             rgb_acc_max_abs_err=e_rgb_acc, depth_max_rel_err=e_depth, w_max_abs_err=e_w, tol=K2_TOL)
        require(e_rgb_acc <= K2_TOL and e_depth <= K2_TOL and e_w <= K2_TOL,
                f"K2: errors {e_rgb_acc}, {e_depth}, {e_w} > {K2_TOL}")

    # -- kernel times at the main path's chunk shape -----------------------
    packed = pack_params(fine, cfg_ref.model, torch.bfloat16)
    ro, rd = camera_rays(poses[1], focal, dev, CHUNK, seed=1)
    mcfg = cfg_ref.model
    raw, z = render_kernel.fused_render_samples(packed, ro, rd, 2.0, 6.0, SPP, mcfg, raw=True)
    k1 = lambda: render_kernel._launch(packed, ro, rd, 2.0, 6.0, SPP, mcfg)
    k1_plain = lambda: render_kernel.fused_render_samples_plain(packed, ro, rd, 2.0, 6.0, SPP, mcfg)
    k2 = lambda: composite_kernel._launch(raw, z, rd, 1e10, 1e-10)
    k2_plain = lambda: composite_kernel.fused_volume_render_interleaved_plain(raw, z, rd, 1e10, 1e-10)
    k1_call_ms, k1_plain_ms = call_ms(k1, 10), call_ms(k1_plain, 3)
    k2_call_ms, k2_plain_ms = call_ms(k2, 30), call_ms(k2_plain, 10)
    k1_bound, k1_by = bound_ms(k1_flops(mcfg, CHUNK, SPP),
                               nbytes(ro, rd, *packed) + CHUNK * SPP * 16)
    out8 = torch.empty(CHUNK, 8, device=dev)
    w8 = torch.empty(CHUNK, SPP, device=dev)
    # ~20 float operations per sample (dist, alpha, log, scan, exp, sums)
    k2_bound, k2_by = bound_ms(20 * CHUNK * SPP, nbytes(raw, z, rd, out8, w8),
                               PEAK_F32_FLOPS)
    emit("kernel_times", shape=f"{CHUNK} rays x {SPP} samples", k1_call_ms=k1_call_ms,
         k1_plain_ms=k1_plain_ms, k1_bound_ms=k1_bound, k2_call_ms=k2_call_ms,
         k2_plain_ms=k2_plain_ms, k2_bound_ms=k2_bound)

    # -- the main path: the benchmark frame through CudaEngine --------------
    engine = CudaEngine(SharedModel(cfg_ref, dev).load(PARAMS), chunk_rays=CHUNK)
    engine.render_image(poses[0], (W, H), SPP, focal=focal, monitor=True)   # warm
    render_kernel.launches = 0
    composite_kernel.launches = 0
    frames = [engine.render_image(p, (W, H), SPP, focal=focal, monitor=True) for p in poses[1:]]
    launches = {"render_samples": render_kernel.launches,
                "composite": composite_kernel.launches}
    per_frame = math.ceil(W * H / CHUNK)
    wall = float(np.median([f.stats.wall_time_s for f in frames]))
    img = frames[0].rgb
    corners = np.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    emit("frame", resolution=[W, H], samples=SPP, views=len(frames), ms_per_frame=wall * 1e3,
         rays_per_s=W * H / wall, peak_device_mb=max(f.stats.peak_device_mb for f in frames),
         launches=launches, expected_per_frame=per_frame, rgb_mean=float(img.mean()),
         rgb_std=float(img.std()), corner_min=float(corners.min()), nvidia_smi=smi)
    for name, n in launches.items():
        require(n == per_frame * len(frames), f"{name}: {n} launches, expected "
                f"{per_frame} per frame x {len(frames)} frames")
    require(all(np.isfinite(f.rgb).all() for f in frames), "frame: non-finite rgb")
    require(corners.min() > 0.99 and img.std() > 0.05,
            f"frame looks degenerate: corners {corners.min()}, std {img.std()}")

    # -- where one frame's device time goes (torch.profiler); each kernel's
    #    device time per launch is its total over its launches in this frame
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = engine.render_image(poses[2], (W, H), SPP, focal=focal, monitor=True)
    kernels_us, kernels_n = {}, {}
    for name, us in device_events(prof):
        kernels_us[name] = kernels_us.get(name, 0.0) + us
        kernels_n[name] = kernels_n.get(name, 0) + 1

    def launch_ms(kernel, fallback):
        """Device ms per launch from the profiled frame, or the event-timed
        call when the profiler did not record every launch."""
        if kernels_n.get(kernel) == per_frame:
            return kernels_us[kernel] / per_frame / 1e3, "profiler"
        return fallback, "events"

    k1_ms, k1_from = launch_ms("ray_kernel", k1_call_ms)
    k2_ms, k2_from = launch_ms("composite_kernel", k2_call_ms)
    busy_ms = sum(kernels_us.values()) / 1e3
    frame_ms = traced.stats.wall_time_s * 1e3
    emit("frame_profile", frame_ms=frame_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / frame_ms,
         device_ms_by_kernel={k: v / 1e3 for k, v in
                              sorted(kernels_us.items(), key=lambda kv: -kv[1])},
         launches_by_kernel=kernels_n, k1_ms_per_launch=k1_ms, k1_ms_from=k1_from,
         k1_bound_ms_per_launch=k1_bound, k2_ms_per_launch=k2_ms, k2_ms_from=k2_from,
         k2_bound_ms_per_launch=k2_bound)

    # -- the frame against the plain engine in float32 ----------------------
    qw, qh = 200, 150
    qfocal = focal_from_angle(qw, CAMERA_ANGLE_X)
    ref_engine = TorchEngine(SharedModel(f32(cfg_ref), dev).load(PARAMS), chunk_rays=CHUNK)
    a = engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal, monitor=False).rgb
    b = ref_engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal, monitor=False).rgb
    psnr = float(-10.0 * np.log10(np.mean((a - b) ** 2)))
    emit("frame_vs_torch_f32", resolution=[qw, qh], samples=SPP, psnr_db=psnr, min_db=PSNR_MIN,
         max_abs_err=float(np.abs(a - b).max()))
    require(psnr >= PSNR_MIN, f"frame PSNR {psnr} dB against the float32 torch engine")

    # -- summary -------------------------------------------------------------
    no_library = "no single PyTorch call computes this function"
    print(json.dumps({"kernels": [
        {"name": "render_samples", "route": "cuda",
         "source": "nerf_tpu_torch/csrc/render_samples.cu",
         "replaces": "nerf_tpu/ops/render_kernel.py:203", "status": "ported",
         "launches": launches["render_samples"], "max_abs_err": max(k1_err.values()),
         "ms": k1_ms, "ms_from": k1_from, "call_ms": k1_call_ms,
         "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "library_note": no_library,
         "shape": f"{CHUNK} rays x {SPP} samples, bf16"},
        {"name": "composite", "route": "cuda",
         "source": "nerf_tpu_torch/csrc/composite.cu",
         "replaces": "nerf_tpu/ops/composite_kernel.py:90", "status": "ported",
         "launches": launches["composite"], "max_abs_err": k2_err,
         "ms": k2_ms, "ms_from": k2_from, "call_ms": k2_call_ms,
         "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "library_note": no_library,
         "shape": f"{CHUNK} rays x {SPP} samples, f32"},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
