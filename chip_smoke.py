#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nerf_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``nerf_tpu_torch/csrc`` (into ``build/``),
holds each kernel against its plain PyTorch version at the main paths'
shapes (K1 uniform ray kernel, K2 compositor, K3 per-ray-depth ray kernel,
and the composited modes of K1 and K3), then drives each path of
``CudaEngine`` with trained weights from
``results/convergence/final_params.npz`` at 800x600:

- ``frame``: the benchmark render, 64 uniform samples (K1 -> K2);
- ``hier_frame``: the hierarchical render, 64 coarse + 128 importance
  samples (K1 -> K2 -> sample_pdf -> sort -> K3 at 192 depths -> K2);
- ``fused_frames``: both modes with ``fuse_composite=True`` (composited K1,
  composited K3, no K2).

Each path runs with every launch count set to 0 just before it and read
just after, and fails unless every kernel of the path ran its expected
number of times. Each frame is compared with the float32 plain PyTorch
engine (>= 40 dB). Each phase prints one JSON line. The last three lines
are the per-kernel summary, the card's name and power limit as
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
B9_TOL = 1e-5                 # composited vs plain on the kernel's own raw: rgb/acc/w abs
PSNR_MIN = 40.0
N_FINE = 128                  # the hierarchical fine pass: 64 coarse + 128 drawn depths
S3 = SPP + N_FINE             # depths per ray of the fine pass


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


def bound_ms(bf16_flops, f32_flops, nbytes_):
    """(ms, what binds): max(bytes / HBM rate, bf16 MMA operations /
    tensor-core rate + float32 operations / float32 rate)."""
    t_ops = bf16_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS
    t_bytes = nbytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def psnr(a, b):
    return float(-10.0 * np.log10(np.mean((a - b) ** 2)))


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
    from nerf_tpu_torch.utils.rendering import sample_pdf

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ---------------------------------------------------------------
    secs = _ext.build()
    ptxas = {n: [ln.strip() for ln in _ext.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln or "Function properties" in ln]
             for n in _ext.SOURCES}
    emit("build", seconds=secs, sources=list(_ext.SOURCES), ptxas=ptxas)

    def reset_counts():
        for k in render_kernel.launches:
            render_kernel.launches[k] = 0
        composite_kernel.launches = 0

    def read_counts():
        return {**render_kernel.launches, "composite": composite_kernel.launches}

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
            raw_k, _ = render_kernel.fused_render_samples(packed_f, ro_chk, rd_chk, 2.0, 6.0, SPP,
                                                          mcfg, raw=True)
            raw_p = render_kernel.fused_render_samples_plain(packed_f, ro_chk, rd_chk, 2.0, 6.0,
                                                             SPP, mcfg)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(raw_k).all()), f"K1 {name}: non-finite output")
            rgb_err, sig_err, sig_scale = rgb_sigma_err(raw_k, raw_p)
            k1_err[name] = rgb_err
            emit("k1_check", variant=name, rays=n_check, samples=SPP, rgb_max_abs_err=rgb_err,
                 sigma_max_rel_err=sig_err, max_abs_sigma=sig_scale, tol=K1_TOL)
            require(rgb_err <= K1_TOL and sig_err <= K1_TOL,
                    f"K1 {name}: rgb err {rgb_err}, sigma rel err {sig_err} > {K1_TOL}")

            z_f = hier_depths(render_kernel, composite_kernel, sample_pdf, packed_c, ro_chk,
                              rd_chk, mcfg, rcfg)
            require(bool(torch.isfinite(z_f).all()) and bool((z_f[:, 1:] >= z_f[:, :-1]).all()),
                    f"K3 {name}: fine depths not finite and sorted")
            raw3_k = render_kernel.fused_render_zvals_raw(packed_f, ro_chk, rd_chk, z_f, mcfg)
            raw3_p = render_kernel.fused_render_zvals_plain(packed_f, ro_chk, rd_chk, z_f, mcfg)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(raw3_k).all()), f"K3 {name}: non-finite output")
            rgb_err, sig_err, sig_scale = rgb_sigma_err(raw3_k, raw3_p)
            k3_err[name] = rgb_err
            emit("k3_check", variant=name, rays=n_check, samples=S3,
                 depths="coarse pass + sample_pdf", rgb_max_abs_err=rgb_err,
                 sigma_max_rel_err=sig_err, max_abs_sigma=sig_scale, tol=K1_TOL)
            require(rgb_err <= K1_TOL and sig_err <= K1_TOL,
                    f"K3 {name}: rgb err {rgb_err}, sigma rel err {sig_err} > {K1_TOL}")
            checked[name] = (mcfg, packed_f, raw_k, z_f, raw3_k)

        # -- B9: the composited modes vs the plain compositing of the kernels'
        #    own raw output (the MLP's error is held above; this isolates the
        #    in-kernel compositing)
        b9_err = {"render_samples_composited": 0.0, "render_zvals_composited": 0.0}
        for name, (mcfg, packed_f, raw_k, z_f, raw3_k) in checked.items():
            sent, eps = rcfg.dist_sentinel, rcfg.transmittance_eps
            out1, w1, z1 = render_kernel.fused_render_samples_composited(
                packed_f, ro_chk, rd_chk, 2.0, 6.0, SPP, mcfg, with_weights=True,
                sentinel=sent, eps=eps)
            ref1 = composite_kernel.fused_volume_render_interleaved_plain(
                raw_k, z1, rd_chk, sent, eps, dz=(6.0 - 2.0) / (SPP - 1))
            out3, w3 = render_kernel.fused_render_zvals_composited(
                packed_f, ro_chk, rd_chk, z_f, mcfg, with_weights=True, sentinel=sent, eps=eps)
            ref3 = composite_kernel.fused_volume_render_interleaved_plain(raw3_k, z_f, rd_chk,
                                                                          sent, eps)
            torch.cuda.synchronize()
            for kname, S, got, ref in (("render_samples_composited", SPP, (out1, w1), ref1),
                                       ("render_zvals_composited", S3, (out3, w3), ref3)):
                require(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
                        f"{kname} {name}: non-finite output")
                e_rgb_acc, e_depth, e_w = composited_err(*got, *ref)
                b9_err[kname] = max(b9_err[kname], e_rgb_acc, e_w)
                emit("b9_check", kernel=kname, variant=name, rays=n_check, samples=S,
                     rgb_acc_max_abs_err=e_rgb_acc, depth_max_rel_err=e_depth, w_max_abs_err=e_w,
                     tol=B9_TOL, reference="plain compositing of the raw kernel's output")
                require(e_rgb_acc <= B9_TOL and e_depth <= B9_TOL and e_w <= B9_TOL,
                        f"{kname} {name}: errors {e_rgb_acc}, {e_depth}, {e_w} > {B9_TOL}")

        # -- K2: kernel vs plain, at both passes' sample counts ------------------
        g = torch.Generator(device=dev).manual_seed(2)
        n2 = CHUNK
        k2_err = 0.0
        for S2 in (SPP, SPP + N_FINE):
            sigma = torch.rand(n2, S2, device=dev, generator=g) * 50.0
            sigma[:, ::7] = 0.0
            sigma[::5, S2 // 2] = 1e6                                   # opaque samples
            rgb = torch.rand(n2, S2, 3, device=dev, generator=g)
            raw2 = torch.cat([sigma[..., None], rgb], -1).reshape(n2, 4 * S2).contiguous()
            z2 = torch.sort(2.0 + 4.0 * torch.rand(n2, S2, device=dev, generator=g), dim=-1).values
            d2 = torch.randn(n2, 3, device=dev, generator=g)
            zs = (z2,) if S2 != SPP else (z2, torch.linspace(2.0, 6.0, SPP, device=dev).expand(n2, SPP))
            for zz in zs:
                out_k, w_k = composite_kernel._launch(raw2, zz, d2, rcfg.dist_sentinel,
                                                      rcfg.transmittance_eps)
                out_p, w_p = composite_kernel.fused_volume_render_interleaved_plain(
                    raw2, zz, d2, rcfg.dist_sentinel, rcfg.transmittance_eps)
                torch.cuda.synchronize()
                e_rgb_acc, e_depth, e_w = composited_err(out_k, w_k, out_p, w_p)
                k2_err = max(k2_err, e_rgb_acc)
                emit("k2_check", rays=n2, samples=S2,
                     z="broadcast" if zz.stride(0) == 0 else "per-ray",
                     rgb_acc_max_abs_err=e_rgb_acc, depth_max_rel_err=e_depth, w_max_abs_err=e_w,
                     tol=K2_TOL)
                require(e_rgb_acc <= K2_TOL and e_depth <= K2_TOL and e_w <= K2_TOL,
                        f"K2: errors {e_rgb_acc}, {e_depth}, {e_w} > {K2_TOL}")
        return k1_err, k3_err, b9_err, k2_err

    k1_err, k3_err, b9_err, k2_err = check_kernels()

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
            "composite": (
                lambda: composite_kernel._launch(raw, z, rd, sent, eps),
                lambda: plain_composite(raw, z, rd, sent, eps),
                30, 10, lambda: plain_composite(raw, z, rd, sent, eps), K2_TOL),
            "composite_192": (
                lambda: composite_kernel._launch(raw3, z3, rd, sent, eps),
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
        t_call, t_plain, chunk_err, chunk_abs = {}, {}, {}, {}
        for name, (kern, plain, reps, plain_reps, ref, tol) in calls.items():
            t_call[name] = call_ms(kern, reps)
            t_plain[name] = call_ms(plain, plain_reps)
            got, want = kern(), ref()
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):            # raw: (rgb abs, sigma rel)
                require(bool(torch.isfinite(got).all()), f"{name} chunk: non-finite output")
                e = rgb_sigma_err(got, want)[:2]
                chunk_abs[name] = e[0]
            else:                                        # composited: (rgb/acc abs, depth rel, w abs)
                require(all(bool(torch.isfinite(t).all()) for t in got if t is not None),
                        f"{name} chunk: non-finite output")
                e = composited_err(*got, *want)
                chunk_abs[name] = max(e[0], e[2])
            chunk_err[name] = e
            require(max(e) <= tol, f"{name} at {CHUNK} rays: errors {e} > {tol}")
            del got, want
            torch.cuda.empty_cache()
        emit("chunk_check", rays=CHUNK, errors=chunk_err,
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
            "composite": bound_ms(0, comp_ops * CHUNK * SPP, nbytes(raw, z, rd, out8, w64)),
            "composite_192": bound_ms(0, comp_ops * CHUNK * S3, nbytes(raw3, z3, rd, out8, w192)),
            "render_zvals": bound_ms(k1_flops(mcfg, CHUNK, S3), 0,
                                     nbytes(ro, rd, z3) + weights_bytes + CHUNK * S3 * 16),
            "render_samples_composited": bound_ms(k1_flops(mcfg, CHUNK, SPP),
                                                  comp_ops * CHUNK * SPP,
                                                  nbytes(ro, rd, out8, w64) + weights_bytes),
            "render_zvals_composited": bound_ms(k1_flops(mcfg, CHUNK, S3), comp_ops * CHUNK * S3,
                                                nbytes(ro, rd, z3, out8) + weights_bytes),
        }
        emit("kernel_times", rays=CHUNK, samples={"render_samples": SPP, "composite": SPP,
                                                  "composite_192": S3, "render_zvals": S3,
                                                  "render_samples_composited": SPP,
                                                  "render_zvals_composited": S3},
             call_ms=t_call, plain_ms=t_plain,
             bound_ms={k: v[0] for k, v in bounds.items()},
             bound_by={k: v[1] for k, v in bounds.items()}, nvidia_smi=smi)
        return t_call, t_plain, bounds, chunk_abs

    # each phase's tensors are freed before the frames, so a frame's peak
    # device memory is the weights and the frame's own
    t_call, t_plain, bounds, chunk_abs = time_kernels()
    torch.cuda.empty_cache()

    per_frame = math.ceil(W * H / CHUNK)
    shared = SharedModel(cfg_ref, dev).load(PARAMS)
    ref_engine = TorchEngine(SharedModel(f32(cfg_ref), dev).load(PARAMS), chunk_rays=CHUNK)
    qw, qh = 200, 150
    qfocal = focal_from_angle(qw, CAMERA_ANGLE_X)
    paths = {}            # path -> launches by kernel over its timed frames

    def drive(engine, mode, name, expect):
        """One warm frame, then the path: counts set to 0, three views, counts
        read. Requires ``expect[kernel]`` launches per chunk of every kernel
        (0 for the kernels the path must not run)."""
        engine.render_image(poses[0], (W, H), SPP, focal=focal, mode=mode, monitor=True)
        reset_counts()
        frames = [engine.render_image(p, (W, H), SPP, focal=focal, mode=mode, monitor=True)
                  for p in poses[1:]]
        counts = read_counts()
        paths[name] = counts
        for k, n in counts.items():
            want = expect.get(k, 0) * per_frame * len(frames)
            require(n == want, f"{name}: {k} launched {n} times, expected {want} "
                    f"({expect.get(k, 0) * per_frame} per frame x {len(frames)} frames)")
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

    def frame_profile(engine, mode, expect):
        """Where one frame's device time goes; each kernel's device ms per
        launch is its total over the frame's launches (``expect``: launches
        per chunk by CUDA kernel name)."""
        traced, us, n = profile_frame(lambda: engine.render_image(
            poses[2], (W, H), SPP, focal=focal, mode=mode, monitor=True))
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
    emit("frame", mode="benchmark", samples=SPP, **drive(
        engine, "benchmark", "benchmark", {"render_samples": 1, "composite": 1}))
    per_launch, prof = frame_profile(engine, "benchmark",
                                     {"ray_kernel": 1, "composite_kernel": 1})
    emit("frame_profile", mode="benchmark", **prof)
    device_ms["render_samples"] = per_launch.get("ray_kernel")
    device_ms["composite"] = per_launch.get("composite_kernel")
    ref_bench = ref_engine.render_image(poses[1], (qw, qh), SPP, focal=qfocal,
                                        monitor=False).rgb
    p_db, p_err = against_torch(engine, "benchmark", ref_bench)
    emit("frame_vs_torch_f32", resolution=[qw, qh], samples=SPP, psnr_db=p_db, min_db=PSNR_MIN,
         max_abs_err=p_err)
    require(p_db >= PSNR_MIN, f"frame PSNR {p_db} dB against the float32 torch engine")

    # -- path 2: the hierarchical frame (K1 -> K2 -> sample_pdf -> K3 -> K2) ---
    emit("hier_frame", mode="hierarchical", samples=[SPP, N_FINE], **drive(
        engine, "hierarchical", "hierarchical",
        {"render_samples": 1, "composite": 2, "render_zvals": 1}))
    per_launch, prof = frame_profile(engine, "hierarchical",
                                     {"ray_kernel": 1, "composite_kernel": 2, "ray_z_kernel": 1})
    emit("hier_frame_profile", mode="hierarchical", **prof)
    device_ms["render_zvals"] = per_launch.get("ray_z_kernel")
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
         min_db=PSNR_MIN, max_abs_err=p_err, **extra)
    require(p_db >= PSNR_MIN, f"hierarchical PSNR {p_db} dB against the float32 torch engine")

    # -- path 3: fuse_composite=True in both modes ----------------------------
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
        fused_res[mode] = res
    per_launch, prof = frame_profile(fused, "hierarchical",
                                     {"ray_composite_kernel": 1, "ray_z_composite_kernel": 1})
    emit("fused_frames", min_db=PSNR_MIN, psnr_resolution=[qw, qh], **fused_res,
         hierarchical_profile=prof)
    device_ms["render_samples_composited"] = per_launch.get("ray_composite_kernel")
    device_ms["render_zvals_composited"] = per_launch.get("ray_z_composite_kernel")

    # -- summary -------------------------------------------------------------
    no_library = "no single PyTorch call computes this function"
    mlp = "sample generation + encoding + the 10-layer MLP"
    # max_abs_err: the largest of the 1,001-ray checks and the chunk check
    summary = (
        ("render_samples", "render_samples", "nerf_tpu_torch/csrc/render_samples.cu",
         "nerf_tpu/ops/render_kernel.py:203", "benchmark",
         max(*k1_err.values(), chunk_abs["render_samples"]),
         f"{CHUNK} rays x {SPP} samples, bf16, raw out", mlp),
        ("composite", "composite", "nerf_tpu_torch/csrc/composite.cu",
         "nerf_tpu/ops/composite_kernel.py:90", "hierarchical",
         max(k2_err, chunk_abs["composite"], chunk_abs["composite_192"]),
         f"{CHUNK} rays x {SPP} samples, f32", "the log-space transmittance scan and its sums"),
        ("render_zvals", "render_zvals", "nerf_tpu_torch/csrc/render_samples.cu",
         "nerf_tpu/ops/render_kernel.py:455", "hierarchical",
         max(*k3_err.values(), chunk_abs["render_zvals"]),
         f"{CHUNK} rays x {S3} per-ray depths, bf16, raw out", mlp),
        ("render_samples_composited", "render_samples_composited",
         "nerf_tpu_torch/csrc/render_samples.cu", "nerf_tpu/ops/render_kernel.py:152",
         "fused_hierarchical",
         max(b9_err["render_samples_composited"], chunk_abs["render_samples_composited"]),
         f"{CHUNK} rays x {SPP} samples, bf16, composited with weights", mlp + " + compositing"),
        ("render_zvals_composited", "render_zvals_composited",
         "nerf_tpu_torch/csrc/render_samples.cu", "nerf_tpu/ops/render_kernel.py:152",
         "fused_hierarchical",
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
    kernels[1]["at_192"] = {"call_ms": t_call["composite_192"],
                            "plain_ms": t_plain["composite_192"],
                            "bound_ms": bounds["composite_192"][0]}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
