"""The mip variant (Mip-NeRF, ``models/mip.py``) on the CPU: its frustum
moments and integrated positional encoding against Monte-Carlo estimates,
the resampler on a worked case, the engines' mip paths (``TorchEngine`` and
``CudaEngine``'s plain versions of the mip kernels) and K2's edges form
against the benchmark's reference (``nerfbench/reference/mip.py``, which
imports nothing of the port), the weight stream of the mip kernels, and
the engines and the trainer that refuse the variant."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from nerf_tpu_torch.config import mip_config
from nerf_tpu_torch.models.encoding import (
    cast_intervals,
    conical_frustum_to_gaussian,
    integrated_pos_enc,
)
from nerf_tpu_torch.ops import composite_kernel, mlp_kernel, ray_wgmma, render_kernel
from nerf_tpu_torch.render.engines import (
    AccelEngine,
    CompressedEngine,
    CudaEngine,
    Int8ComputeEngine,
    SharedModel,
    TorchEngine,
)
from nerf_tpu_torch.utils.cameras import focal_from_angle, pixel_radius, spherical_pose
from nerf_tpu_torch.utils.rendering import composite_intervals, mip_resample, uniform_edges
from nerfbench.reference import mip as ref
from nerfbench.reference.nerf import bf16_rounding, fp8_rounding

W, H, N = 8, 6, 16
CAMERA_ANGLE_X = 0.6911112070083618


def small_config(dtype="float32"):
    cfg = mip_config()
    return dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, n_coarse=N, n_fine=N),
        train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def as_dicts(cfg):
    return dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.render)


@pytest.fixture(scope="module")
def net():
    return ref.seeded_weights(as_dicts(mip_config())[0], 3, torch.device("cpu"))


def test_frustum_moments_match_monte_carlo():
    # points uniform in the volume of a cone frustum (apex at the origin,
    # axis d not normalized, radius r t at parameter t, t in [t0, t1]): the
    # density of t is t^2, a cross-section a disk. Mean and per-axis
    # variance of 2,000,000 points; tolerance 1e-3 of the coordinates' scale
    # on the mean (the estimate's standard error is ~1e-4 of it) and 2% on
    # the variances (~0.2% standard error)
    g = np.random.default_rng(0)
    d = np.array([0.3, -0.5, 1.2])
    o = np.array([0.1, 0.2, -0.3])
    r, t0, t1, n = 0.05, 2.0, 3.0, 2_000_000
    t = np.cbrt(t0 ** 3 + g.random(n) * (t1 ** 3 - t0 ** 3))
    e1 = np.cross(d, [1.0, 0.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d / np.linalg.norm(d), e1)
    rho, phi = r * t * np.sqrt(g.random(n)), 2 * np.pi * g.random(n)
    pts = o + t[:, None] * d + (rho * np.cos(phi))[:, None] * e1 + (rho * np.sin(phi))[:, None] * e2
    t_mean, t_var, r_var = conical_frustum_to_gaussian(
        torch.tensor([t0], dtype=torch.float64), torch.tensor([t1], dtype=torch.float64),
        torch.tensor([r], dtype=torch.float64))
    assert float(t_mean) == pytest.approx(t.mean(), rel=1e-4)
    assert float(t_var) == pytest.approx(t.var(), rel=2e-2)
    assert float(r_var) == pytest.approx(np.mean((r * t) ** 2) / 4, rel=2e-2)
    mean, cov = cast_intervals(torch.tensor(o[None]), torch.tensor(d[None]),
                               torch.tensor([r], dtype=torch.float64),
                               torch.tensor([[t0, t1]], dtype=torch.float64))
    np.testing.assert_allclose(mean[0, 0].numpy(), pts.mean(0), atol=1e-3 * np.abs(pts).max())
    np.testing.assert_allclose(cov[0, 0].numpy(), pts.var(0), rtol=2e-2)


def test_ipe_is_the_expected_sine_of_a_gaussian():
    # E[sin(2^l x)] and E[sin(2^l x + pi / 2)] for x ~ N(mean, diag(cov)) at
    # degrees 0..3, from 1,000,000 draws: standard error below 1e-3, so 5e-3
    g = np.random.default_rng(1)
    mean = np.array([0.4, -1.3, 2.2])
    cov = np.array([0.02, 0.3, 0.08])
    x = mean + np.sqrt(cov) * g.standard_normal((1_000_000, 3))
    got = integrated_pos_enc(torch.tensor(mean), torch.tensor(cov), 0, 4).numpy()
    y = np.concatenate([x * 2.0 ** l for l in range(4)], axis=1)
    want = np.concatenate([np.sin(y).mean(0), np.sin(y + math.pi / 2).mean(0)])
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_resampler_on_a_worked_case():
    # edges 0..4, weights (0, 1, 0, 0): padded (0, 0, 1, 0, 0, 0), max-pooled
    # (0, 1, 1, 0, 0), averaged (0.5, 1, 0.5, 0), + 0.01, normalized by 2.04;
    # the CDF's knots and the draws linspace(0, 1 - eps, 5) by hand
    edges = torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0]])
    w = torch.tensor([[0.0, 1.0, 0.0, 0.0]])
    got = mip_resample(edges, w, 0.01)[0].double().numpy()
    pdf = np.array([0.51, 1.01, 0.51, 0.01]) / 2.04
    cdf = np.concatenate([[0.0], np.cumsum(pdf[:-1]), [1.0]])
    u = np.linspace(0.0, 1.0 - 2.0 ** -23, 5)
    want = []
    for ui in u:
        k = np.searchsorted(cdf, ui, side="right") - 1
        want.append(k + (ui - cdf[k]) / (cdf[k + 1] - cdf[k]))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[0] == 0.0
    # and at the cell's 128 intervals: 129 sorted edges from the first
    e = uniform_edges(2.0, 6.0, 129, "cpu").expand(3, 129)
    wr = torch.rand(3, 128, generator=torch.Generator().manual_seed(0)) ** 4
    fine = mip_resample(e, wr, 0.01)
    assert fine.shape == (3, 129) and bool((fine[:, 1:] >= fine[:, :-1]).all())
    assert bool((fine[:, 0] == 2.0).all()) and bool((fine <= 6.0).all())
    # the reference's mask search gives the same edges
    assert torch.equal(fine, ref.resample_along_rays(e, wr, 0.01))


def test_edges_form_of_k2_matches_the_reference_compositor():
    g = torch.Generator().manual_seed(4)
    n, s = 7, 12
    raw = torch.rand(n, 4 * s, generator=g)
    raw[:, 0::4] *= 3.0
    edges = torch.sort(2.0 + 4.0 * torch.rand(n, s + 1, generator=g), dim=-1).values
    rd = torch.randn(n, 3, generator=g)
    out, w = composite_kernel.composite_edges_plain(raw, edges, rd)
    rgb = torch.stack([raw[:, 1::4], raw[:, 2::4], raw[:, 3::4]], -1)
    r_rgb, r_depth, r_acc, r_w = ref.volumetric_rendering(rgb, raw[:, 0::4], edges, rd, False)
    torch.testing.assert_close(out[:, :3], r_rgb, rtol=0, atol=1e-6)
    torch.testing.assert_close(out[:, 3], r_depth, rtol=0, atol=1e-6)
    torch.testing.assert_close(out[:, 4], r_acc, rtol=0, atol=1e-6)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-6)
    # the white background goes on in the wrapper; an empty ray's depth reads
    # the first edge
    cfg = mip_config().render
    res = composite_kernel.composite_edges(raw, edges, rd, cfg, with_weights=False)
    assert res.weights is None
    torch.testing.assert_close(res.rgb, out[:, :3] + (1 - out[:, 4:5]))
    empty = torch.zeros(1, 4 * s)
    o, _ = composite_kernel.composite_edges_plain(empty, edges[:1], rd[:1])
    assert float(o[0, 3]) == float(edges[0, 0]) and float(o[0, 4]) == 0.0
    assert torch.equal(composite_intervals(raw[:, 0::4], rgb, edges, rd, True).rgb,
                       res.rgb)


def _frames(net, dtype, rnd):
    cfg = small_config(dtype)
    model, render = as_dicts(cfg)
    focal = focal_from_angle(W, CAMERA_ANGLE_X)
    pose = spherical_pose(30.0, -30.0, 4.0)
    shared = SharedModel(cfg, device="cpu")
    shared.params = {"coarse": net, "fine": net}
    r_rgb, r_depth = ref.frame(net, pose, W, H, focal, model, render, rnd)
    got = {}
    for engine in (TorchEngine(shared), CudaEngine(shared)):
        res = engine.render_image(pose, (W, H), 64, focal, "hierarchical", monitor=False)
        got[engine.name] = (res.rgb, res.depth)
    f_rgb, _ = ref.frame(net, pose, W, H, focal, model, render, fp8_rounding)
    return r_rgb.numpy(), r_depth.numpy(), got, f_rgb.numpy()


def test_engines_match_the_reference_in_float32(net):
    # the same float32 arithmetic but for the products' blocking (the kernels'
    # encoding is padded to 128 rows, the direction term is its own product)
    # and d * rsqrt(|d|^2 + 1e-12) for the unit view directions: 1e-5
    r_rgb, r_depth, got, _ = _frames(net, "float32", None)
    for name, (rgb, depth) in got.items():
        np.testing.assert_allclose(rgb, r_rgb, rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(depth, r_depth, rtol=0, atol=1e-5 * 6.0, err_msg=name)


def test_engines_match_the_reference_in_bf16_where_fp8_does_not(net):
    # bf16 operands, float32 sums, as the reference rounds them: the engines
    # differ only where a sum's order flips a bf16 rounding (the kernels'
    # plain versions keep the direction term apart); 1e-3 on rgb, which the
    # reference with fp8 operands, one precision step lower, exceeds
    tol = 1e-3
    r_rgb, _, got, f_rgb = _frames(net, "bfloat16", bf16_rounding)
    for name, (rgb, _) in got.items():
        assert np.abs(rgb - r_rgb).max() <= tol, name
    assert np.abs(f_rgb - r_rgb).max() > tol


def test_one_network_serves_both_passes():
    cfg = small_config()
    shared = SharedModel(cfg, device="cpu").load(None, seed=1)
    assert shared.params["coarse"] is shared.params["fine"]
    assert shared.params["fine"]["trunk"][0]["w"].shape == (96, 256)
    assert shared.params["fine"]["trunk"][5]["w"].shape == (256 + 96, 256)
    engine = CudaEngine(shared)
    packed = engine.engine_params()
    assert packed["coarse"] is packed["fine"]
    assert packed["fine"].w0.shape == (128, 256) and packed["fine"].wskip.shape == (128, 256)


def test_the_mip_stream_carries_the_ipe_rows_in_two_chunks():
    cfg = mip_config().model
    g = torch.Generator().manual_seed(2)
    from nerf_tpu_torch.models.nerf import init_nerf_params

    packed = mlp_kernel.pack_params(init_nerf_params(g, cfg, "cpu"), cfg, torch.bfloat16)
    sched = ray_wgmma.chunk_schedule(cfg)
    assert len(sched) == 40 and [(c.name, c.k0) for c in sched[:2]] == [("w0", 0), ("w0", 64)]
    assert [(c.name, c.k0) for c in sched if c.name == "wskip"] == [("wskip", 0), ("wskip", 64)]
    assert sched[2 + 5 * 4 - 1].layer == 4 and sched[2 + 5 * 4].name == "wskip"
    got = ray_wgmma.unpack_stream(ray_wgmma.pack_stream(packed, cfg), cfg)
    for name in ("w0", "wskip", "wbn", "wc0"):
        assert torch.equal(got[name], getattr(packed, name)), name
    assert torch.equal(got["wt"], packed.wt)
    # the IPE's padding rows are zero, so K 96..127 may be left out
    assert not packed.w0[96:].any() and not packed.wskip[96:].any()


def test_the_mip_path_records_its_spans():
    from torch.profiler import ProfilerActivity, profile

    cfg = small_config()
    shared = SharedModel(cfg, device="cpu").load(None, seed=1)
    engine = CudaEngine(shared)
    focal = focal_from_angle(W, CAMERA_ANGLE_X)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.render_image(spherical_pose(10.0, -20.0, 4.0), (W, H), 64, focal,
                            "hierarchical", monitor=False)
    names = [e.name for e in prof.events()]
    for span in ("kernel.k1", "kernel.k2", "mip.resample", "kernel.k3"):
        assert span in names, span
    assert names.count("kernel.k2") == 2 and names.count("engine.chunk") == 1


def test_benchmark_mode_is_the_coarse_pass_alone(net):
    cfg = small_config()
    model, render = as_dicts(cfg)
    focal = focal_from_angle(W, CAMERA_ANGLE_X)
    pose = spherical_pose(50.0, -40.0, 4.0)
    shared = SharedModel(cfg, device="cpu")
    shared.params = {"coarse": net, "fine": net}
    r_rgb, _ = ref.frame(net, pose, W, H, focal, model, render, None, n_samples=24)
    for engine in (TorchEngine(shared), CudaEngine(shared)):
        rgb = engine.render_image(pose, (W, H), 24, focal, "benchmark", monitor=False).rgb
        np.testing.assert_allclose(rgb, r_rgb.numpy(), rtol=0, atol=1e-5)


def test_the_other_engines_and_the_trainer_refuse_mip():
    from nerf_tpu_torch.train.trainer import NeRFTrainer

    shared = SharedModel(small_config(), device="cpu").load(None, seed=1)
    for cls in (CompressedEngine, Int8ComputeEngine, AccelEngine):
        with pytest.raises(ValueError, match="mip"):
            cls(shared)
    for kw in ({"planar": True}, {"fuse_composite": True}):
        with pytest.raises(ValueError, match="mip"):
            CudaEngine(shared, **kw)
    with pytest.raises(ValueError, match="mip"):
        NeRFTrainer(small_config(), (8, 8), device="cpu")


def test_pixel_radius_is_the_published_base_radius():
    focal = focal_from_angle(800, CAMERA_ANGLE_X)
    assert pixel_radius(focal) == ref.radius(focal)
    assert pixel_radius(focal) == pytest.approx(2.0 / math.sqrt(12.0) / focal, rel=1e-7)


def run_mip_cell(seed=12345678901):
    """The ``mip-hier`` cell on the CPU at its own 128 + 128 intervals, 8 x 8
    pixels and 64 probe rays a checked frame, under its own limits."""
    from nerfbench import harness, run

    check = harness.cell("mip-hier")[1]["check"]
    line, _ = run.execute("mip-hier", seed, 0.5, False, device="cpu", workload_overrides={
        "resolution": [8, 8], "warm_frames": 1, "max_frames": 16,
        "check": {**check, "probe_rays": 64}})
    return line


def test_the_mip_cell_is_correct_on_the_unbroken_port():
    line = run_mip_cell()
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", ["coarse_edges", "no_blur", "no_padding", "k3_uniform",
                                   "k3_density_dropped"])
def test_the_mip_cell_sees_a_broken_fine_pass(monkeypatch, fault):
    """Each fault of the fine pass that ``tools/readings_mip.py`` plants comes
    out not correct. On seeded weights the image alone misses the
    resampler's faults (here ``rgb_p999_abs`` reads 4e-5 to 1.1e-4 under
    them, against its limit of 1e-3); the probe's fine edges and raw
    outputs see them."""
    from nerf_tpu_torch.render import engines
    from nerfbench import harness
    from nerfbench.tools import readings_mip

    config = harness.cell("mip-hier")[2]
    monkeypatch.setattr(engines, *readings_mip.broken(fault, config))
    line = run_mip_cell()
    assert line["correct"] is False, line["checks"]
