"""The mip360 variant (Mip-NeRF 360, ``models/mip360.py``) on the CPU: the
engines' paths (``TorchEngine`` and ``CudaEngine``'s plain versions of the
proposal entry, the NeRF pass and K2's opaque edges form) against the
benchmark's reference (``nerfbench/reference/mip360.py``, which imports
nothing of the port), each plain version against the reference's piece,
the contraction's Jacobian, the basis, the dilation against a loop, the
sampler, the fp8 control, the published widths, the weight streams, and
the refusals."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from nerf_tpu_torch.config import mip360_config
from nerf_tpu_torch.models import mip360
from nerf_tpu_torch.models.encoding import (
    BASIS_SUBDIVISIONS,
    N_BASIS,
    contract_jacobian,
    encode_intervals_360,
    generate_basis,
)
from nerf_tpu_torch.models.mip import apply_mip
from nerf_tpu_torch.models.mip360 import apply_prop, render_mip360_rays, resample_360
from nerf_tpu_torch.ops import composite_kernel, mip360_kernel, ray_wgmma, render_kernel
from nerf_tpu_torch.render.engines import (
    AccelEngine,
    CompressedEngine,
    CudaEngine,
    SharedModel,
    TorchEngine,
)
from nerf_tpu_torch.utils.cameras import spherical_pose
from nerf_tpu_torch.utils.rendering import (
    composite_intervals,
    first_level_360,
    max_dilate_weights,
    s_to_t,
    sample_intervals,
)
from nerfbench.harness import ROOT as BENCH_ROOT
from nerfbench.reference import mip360 as ref
from nerfbench.reference.mip import radius as ref_radius
from nerfbench.reference.nerf import bf16_rounding, fp8_rounding
from nerfbench.reference.render import camera_rays

W, H = 8, 8                    # 64 rays
FOCAL = 0.5 * W / math.tan(0.5 * 1.10)
RGB_TOL = 2e-3                 # bf16 products: the kernels' plain versions split the color
                               # layer's sum (the bottleneck's rows, then the direction term),
                               # which flips a bf16 rounding of c now and then


def small_config(dtype="bfloat16", published=False):
    cfg = mip360_config()
    model = cfg.model if published else dataclasses.replace(
        cfg.model, hidden_dim=64, prop_hidden_dim=32, bottleneck_dim=32, color_hidden_dim=16)
    render = cfg.render if published else dataclasses.replace(cfg.render, n_coarse=8, n_fine=4)
    return dataclasses.replace(cfg, model=model, render=render,
                               train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def as_dicts(cfg):
    return dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.render)


@pytest.fixture(scope="module")
def nets():
    return ref.seeded_weights(as_dicts(small_config())[0], 3, torch.device("cpu"))


def shared_of(cfg, nets):
    shared = SharedModel(cfg, device="cpu")
    shared.params = {"coarse": nets["prop"], "fine": nets["nerf"]}
    return shared


def rays(n=W * H, seed=0):
    g = torch.Generator().manual_seed(seed)
    ro = torch.randn(n, 3, generator=g) * 0.4
    rd = torch.randn(n, 3, generator=g)
    return ro, rd


POSE = spherical_pose(30.0, -15.0, 1.0)


# depth: the last interval is opaque and reaches far (1e6), so its weight moves
# the depth by its midpoint's half million: a flipped bf16 rounding of the
# kernels' plain versions moves one pixel's depth by up to ~0.5% of the
# frame's largest
@pytest.mark.parametrize("engine,dtype,tol,depth_tol", [(TorchEngine, "float32", 1e-5, 1e-5),
                                                        (TorchEngine, "bfloat16", 1e-5, 1e-5),
                                                        (CudaEngine, "bfloat16", RGB_TOL, 2e-2)])
def test_engines_match_the_reference_frame(nets, engine, dtype, tol, depth_tol):
    cfg = small_config(dtype)
    model, render = as_dicts(cfg)
    rnd = None if dtype == "float32" else bf16_rounding
    rgb, depth = ref.frame(nets, POSE, W, H, FOCAL, model, render, rnd)
    got = engine(shared_of(cfg, nets)).render_image(POSE, (W, H), 64, FOCAL, "hierarchical",
                                                     monitor=False)
    np.testing.assert_allclose(got.rgb, rgb.numpy(), atol=tol)
    err = np.abs(got.depth - depth.numpy()).max() / np.abs(depth.numpy()).max()
    assert float(err) < depth_tol


def test_the_fp8_control_fails_the_tolerance(nets):
    # the reference with every product's operands in float8 e4m3 is no
    # rendering of the configuration at bf16's tolerance
    cfg = small_config()
    model, render = as_dicts(cfg)
    rgb, _ = ref.frame(nets, POSE, W, H, FOCAL, model, render, bf16_rounding)
    ctl, _ = ref.frame(nets, POSE, W, H, FOCAL, model, render, fp8_rounding)
    assert float((ctl - rgb).abs().max()) > 5 * RGB_TOL


def test_plain_versions_match_the_reference_pieces(nets):
    cfg = small_config()
    mcfg, rcfg = cfg.model, cfg.render
    model, _ = as_dicts(cfg)
    ro, rd = rays()
    radius = ref_radius(FOCAL)
    s = first_level_360(rcfg.n_coarse, ro.shape[0], "cpu")
    assert torch.equal(s, ref.sample_intervals(torch.tensor([0.0, 1.0]).expand(ro.shape[0], 2),
                                               torch.ones(ro.shape[0], 1), rcfg.n_coarse, 0.0))
    t = s_to_t(s, rcfg.near, rcfg.far)
    # the encoding: the same operations in the same order
    r = torch.full((ro.shape[0],), radius)
    enc = encode_intervals_360(ro, rd, r, t, mcfg.ipe_min_deg, mcfg.ipe_max_deg)
    mean, cov = ref.contract(*ref.gaussians(ro, rd, radius, t))
    want = ref.encode(mean, cov, torch.from_numpy(ref.generate_basis()), 0, 12)
    assert torch.equal(enc, want)
    # the proposal entry's plain version against the reference's network
    packed = mip360_kernel.pack_mip360({"coarse": nets["prop"], "fine": nets["nerf"]}, mcfg)
    dens = render_kernel.fused_render_prop_mip360_plain(packed["coarse"], ro, rd, radius, t, mcfg)
    np.testing.assert_allclose(dens, ref.prop_mlp(nets["prop"], want, model, bf16_rounding),
                               rtol=1e-5, atol=1e-6)
    # K2's opaque edges form (weights) against the reference's weights
    w = composite_kernel.composite_weights_360(dens, t, rd)
    np.testing.assert_allclose(w, ref.alpha_weights(dens, t, rd), atol=1e-6)
    # the next level's edges: the dilation and the draw, as the reference's
    dil = ref.DILATION_BIAS + ref.DILATION_MULTIPLIER / rcfg.n_coarse
    assert torch.equal(resample_360(s, w, rcfg.n_fine, rcfg.n_coarse, rcfg),
                       ref.sample_intervals(*ref.max_dilate_weights(s, w, dil), rcfg.n_fine, 0.0))
    # the NeRF pass's plain version against the reference's network
    raw = mip360_kernel.nerf_mip360_plain(packed["fine"], ro, rd, radius, t, mcfg)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    d_want, rgb_want = ref.nerf_mlp(nets["nerf"], want, vd, model, bf16_rounding)
    raw = raw.reshape(ro.shape[0], -1, 4)
    np.testing.assert_allclose(raw[..., 0], d_want, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(raw[..., 1:], rgb_want, atol=RGB_TOL)
    # K2's opaque edges form (raw) against the reference's compositing
    out = composite_kernel.composite_edges_360(raw.reshape(ro.shape[0], -1), t, rd, rcfg)
    comp, depth = ref.composite(raw[..., 1:], ref.alpha_weights(raw[..., 0], t, rd), t)
    np.testing.assert_allclose(out.rgb, comp, atol=1e-6)
    np.testing.assert_allclose(out.depth, depth, rtol=1e-6)


def test_the_published_settings_are_the_ports_and_the_references():
    # 360.gin's level count, dilation, basis and opaque last interval are
    # fixed in the port and in the reference; the configuration file states them
    config = json.loads((BENCH_ROOT / "nerfbench/configs/mipnerf360-outdoor.json").read_text())
    pub = config["published"]
    assert pub["n_prop_levels"] == mip360.N_PROP_LEVELS == ref.N_PROP_LEVELS
    assert pub["dilation_bias"] == mip360.DILATION_BIAS == ref.DILATION_BIAS
    assert pub["dilation_multiplier"] == mip360.DILATION_MULTIPLIER == ref.DILATION_MULTIPLIER
    assert pub["basis_subdivisions"] == BASIS_SUBDIVISIONS == ref.BASIS_SUBDIVISIONS
    assert pub["basis"] == "icosahedron" and pub["opaque_background"] is True
    assert mip360.level_sizes(mip360_config().render) == [64, 64, 32]


def test_the_contraction_jacobian_is_autograds():
    g = torch.Generator().manual_seed(4)
    pts = torch.cat([torch.randn(6, 3, generator=g, dtype=torch.float64) * 3,
                     torch.randn(4, 3, generator=g, dtype=torch.float64) * 0.2])

    def contract(x):
        m = torch.clamp((x * x).sum(), min=float(np.finfo(np.float32).eps))
        return x if m <= 1 else ((2 * torch.sqrt(m) - 1) / m) * x

    for x in pts:
        want = torch.autograd.functional.jacobian(contract, x)
        got_x, got_j = contract_jacobian(x)
        np.testing.assert_allclose(got_j, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got_x, contract(x), rtol=1e-12)
        assert float(got_x.norm()) < 2.0


def test_the_basis_is_21_unit_vectors_without_an_antipodal_pair():
    b = generate_basis()
    assert b.shape == (3, 21) == (3, N_BASIS) and b.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(b, axis=0), 1.0, atol=1e-6)
    d = np.linalg.norm(b[:, :, None] + b[:, None, :], axis=0)
    assert d.min() > 0.1
    np.testing.assert_array_equal(b, ref.generate_basis())


def test_max_dilate_weights_matches_a_loop():
    g = torch.Generator().manual_seed(0)
    R, n = 5, 16
    s = torch.sort(torch.rand(R, n + 1, generator=g), -1).values
    s[:, 0], s[:, -1] = 0.0, 1.0
    s[0, 4:7] = s[0, 4]              # empty intervals
    w = torch.rand(R, n, generator=g) ** 3
    w = w / w.sum(-1, keepdim=True)
    dil = 0.0025 + 0.5 / 16
    e, wd = max_dilate_weights(s, w, dil)
    assert e.shape == (R, 3 * n - 1) and wd.shape == (R, 3 * n - 2)
    eps2 = float(np.finfo(np.float32).eps) ** 2
    for r in range(R):
        sr, wr = s[r].tolist(), w[r].tolist()
        p = [wr[j] / max(eps2, float(np.float32(sr[j + 1]) - np.float32(sr[j]))) for j in range(n)]
        t0 = [float(np.float32(sr[j]) - np.float32(dil)) for j in range(n)]
        t1 = [float(np.float32(sr[j + 1]) + np.float32(dil)) for j in range(n)]
        ed = np.clip(np.sort(np.array(sr + t0 + t1, np.float32)), 0, 1)
        pd = [max([p[j] for j in range(n) if t0[j] <= ed[k] < t1[j]], default=0.0)
              for k in range(len(ed) - 1)]
        wdr = np.array(pd, np.float64) * np.diff(ed.astype(np.float64))
        wdr = wdr / max(eps2, wdr.sum())
        np.testing.assert_array_equal(e[r].numpy(), ed[1:-1])
        np.testing.assert_allclose(wd[r].numpy(), wdr[1:-1], rtol=1e-5, atol=1e-9)
    # and the reference's mask form, bit for bit
    re, rw = ref.max_dilate_weights(s, w, dil)
    assert torch.equal(e, re) and torch.equal(wd, rw)


def test_sample_intervals_gives_sorted_edges_in_the_unit_interval():
    g = torch.Generator().manual_seed(1)
    s = torch.sort(torch.rand(7, 33, generator=g), -1).values
    s[:, 0], s[:, -1] = 0.0, 1.0
    w = torch.rand(7, 32, generator=g) ** 4
    w[2, 5:9] = 0.0
    for n in (4, 32, 64):
        e = sample_intervals(s, w, n)
        assert e.shape == (7, n + 1)
        assert bool((e[:, 1:] >= e[:, :-1]).all()) and bool((e >= 0).all() & (e <= 1).all())
        assert torch.equal(e, ref.sample_intervals(s, w, n, 0.0))
    # the first level: one interval of weight 1, centres at the draws
    e0 = sample_intervals(torch.tensor([[0.0, 1.0]]), torch.ones(1, 1), 8)
    np.testing.assert_allclose(0.5 * (e0[0, 1:] + e0[0, :-1])[1:-1],
                               np.linspace(1 / 16, 1 - 1 / 16, 8)[1:-1], atol=1e-6)


def test_the_last_interval_is_opaque():
    dens = torch.zeros(3, 5)
    t = torch.linspace(1.0, 6.0, 6).expand(3, 6)
    out = composite_intervals(dens, torch.rand(3, 5, 3), t, torch.ones(3, 3), True, opaque=True)
    np.testing.assert_allclose(out.weights[:, -1], 1.0)
    np.testing.assert_allclose(out.acc, 1.0)
    w = composite_kernel.composite_weights_360(dens, t, torch.ones(3, 3))
    np.testing.assert_allclose(w[:, -1], 1.0)


def test_published_widths_on_eight_rays():
    cfg = small_config(published=True)
    model, render = as_dicts(cfg)
    nets = ref.seeded_weights(model, 11, torch.device("cpu"))
    assert [len(nets["nerf"]["trunk"]), nets["nerf"]["trunk"][5]["w"].shape[0]] == [8, 1024 + 504]
    ro, rd = camera_rays(POSE, W, H, FOCAL, "cpu")
    ro, rd = ro[::8].contiguous(), rd[::8].contiguous()
    radius = ref_radius(FOCAL)
    w1, s2, raw = ref.probe(nets, ro, rd, radius, model, render, bf16_rounding)
    engine = CudaEngine(shared_of(cfg, nets))
    out, s, raw_k, w_k = engine.mip360_passes(engine.engine_params(), ro, rd, cfg.render, radius)
    assert s.shape == (8, 33) and raw_k.shape == (8, 128) and w_k.shape == (8, 64)
    np.testing.assert_allclose(w_k, w1, atol=1e-3)
    np.testing.assert_allclose(s, s2, atol=1e-4)
    raw_at = mip360_kernel.nerf_mip360_plain(engine.engine_params()["fine"], ro, rd, radius,
                                            s_to_t(s2, render["near"], render["far"]), cfg.model)
    np.testing.assert_allclose(raw_at.reshape(8, 32, 4)[..., 1:], raw[..., 1:], atol=RGB_TOL)
    np.testing.assert_allclose(raw_at.reshape(8, 32, 4)[..., 0], raw[..., 0], rtol=1e-2,
                               atol=1e-4)


def test_weight_streams_unpack_to_the_matrices():
    cfg = small_config(published=True)
    params = ref.seeded_weights(as_dicts(cfg)[0], 2, torch.device("cpu"))
    packed = mip360_kernel.pack_mip360({"coarse": params["prop"], "fine": params["nerf"]},
                                       cfg.model)
    prop, nerf = packed["coarse"], packed["fine"]
    order = mip360_kernel.enc_order(cfg.model)
    assert prop.stream.numel() == (8 + 3 * 4) * 64 * 256
    slab = prop.stream[64 * 256 * 3:64 * 256 * 4]         # w0's fourth slab, in the kernels' order
    np.testing.assert_array_equal(ray_wgmma._unswizzled(slab, 256).float(),
                                  prop.w0[order[192:256]].float())
    slab = prop.stream[64 * 256 * 9:64 * 256 * 10]        # wt[0]'s second slab
    np.testing.assert_array_equal(ray_wgmma._unswizzled(slab, 256).float(),
                                  prop.wt[0][64:128].float())
    assert prop.bt[3:].abs().sum() == 0 and prop.basis[63:].abs().sum() == 0
    np.testing.assert_array_equal(prop.basis[:63].reshape(3, 21), generate_basis())
    # the skip layer: 24 K steps a column tile, the encoding's rows after h's
    skip = nerf.streams[5].reshape(4, 24, 64 * 256)
    assert nerf.w[5].shape == (1536, 1024)
    rows = torch.cat([torch.arange(1024), 1024 + order])
    for nt, kc in ((0, 0), (3, 15), (1, 16), (2, 23)):
        np.testing.assert_array_equal(
            ray_wgmma._unswizzled(skip[nt, kc], 256).float(),
            nerf.w[5][rows[64 * kc:64 * kc + 64], 256 * nt:256 * nt + 256].float())
    np.testing.assert_array_equal(nerf.w[5][1024 + 504:].float(), 0.0)
    sig = ray_wgmma._unswizzled(nerf.sig_stream[:512], 8).float()
    np.testing.assert_array_equal(sig[:, 0], nerf.wsig[:64].float())
    np.testing.assert_array_equal(sig[:, 1:], 0.0)
    c0 = nerf.c0_stream.reshape(4, 64 * 128)
    np.testing.assert_array_equal(ray_wgmma._unswizzled(c0[2], 128).float(),
                                  nerf.wc0[128:192].float())


def test_the_kernels_pair_order_is_enc_order():
    # the kernels write pair q = k n_deg + l as (att sin(y), att sin(y + pi / 2))
    # of direction k at degree l (csrc/mip360.cuh); enc_order maps each of
    # their positions to the published order's feature
    cfg = small_config(published=True).model
    ro, rd = rays(5)
    t = torch.tensor([[0.3, 0.9, 4.0, 1e3]]).expand(5, 4)
    r = torch.full((5,), 1e-3)
    enc = encode_intervals_360(ro, rd, r, t, 0, 12)
    mean, cov = ref.contract(*ref.gaussians(ro, rd, 1e-3, t))
    b = torch.from_numpy(generate_basis())
    m = (mean[..., 0:1] * b[0] + mean[..., 1:2] * b[1]) + mean[..., 2:3] * b[2]
    cb = [(cov[..., i, 0:1] * b[0] + cov[..., i, 1:2] * b[1]) + cov[..., i, 2:3] * b[2]
          for i in range(3)]
    var = (b[0] * cb[0] + b[1] * cb[1]) + b[2] * cb[2]
    pairs = []
    for k in range(21):
        for l in range(12):
            y, yv = m[..., k] * 2.0 ** l, var[..., k] * 4.0 ** l
            att = torch.exp(-0.5 * yv)
            pairs += [att * torch.sin(y), att * torch.sin(y + 0.5 * math.pi)]
    kernel_order = torch.stack(pairs, dim=-1)
    order = mip360_kernel.enc_order(cfg)
    assert torch.equal(kernel_order, enc[..., order[:504]])
    assert order[504:].tolist() == list(range(504, 512))


def test_spans_of_a_chunk():
    from torch.profiler import ProfilerActivity, profile

    cfg = small_config()
    engine = CudaEngine(shared_of(cfg, ref.seeded_weights(as_dicts(cfg)[0], 3,
                                                          torch.device("cpu"))))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.render_image(POSE, (W, H), 64, FOCAL, "hierarchical", monitor=False)
    names = [e.name for e in prof.events()]
    assert names.count("mip360.resample") == 3 and names.count("kernel.prop") == 2
    assert names.count("kernel.nerf") == 1 and names.count("kernel.k2") == 3


def test_engines_and_modes_that_refuse_the_variant(nets):
    cfg = small_config()
    shared = shared_of(cfg, nets)
    for cls in (CompressedEngine, AccelEngine):
        with pytest.raises(ValueError, match="mip360"):
            cls(shared)
    with pytest.raises(ValueError, match="mip360"):
        CudaEngine(shared, fuse_composite=True)
    with pytest.raises(ValueError, match="hierarchical"):
        TorchEngine(shared).render_image(POSE, (W, H), 64, FOCAL, "benchmark", monitor=False)
    from nerf_tpu_torch.train.trainer import NeRFTrainer

    with pytest.raises(ValueError, match="mip360"):
        NeRFTrainer(cfg, (8, 8), device="cpu")
    # the kernels refuse widths they do not compute
    packed = mip360_kernel.pack_mip360(shared.params, cfg.model)
    assert packed["coarse"].stream.numel() == 0 and packed["fine"].streams == []
    assert not mip360_kernel.nerf_fits(cfg.model) and mip360_kernel.nerf_fits(mip360_config().model)


def test_seeded_load_and_networks_of_the_port():
    cfg = small_config("float32")
    shared = SharedModel(cfg, device="cpu").load(None, seed=4)
    assert shared.params["coarse"] is not shared.params["fine"]
    assert len(shared.params["coarse"]["trunk"]) == 4 and len(shared.params["fine"]["trunk"]) == 8
    enc = torch.randn(3, 5, cfg.model.pos_dim)
    assert apply_prop(shared.params["coarse"], enc, cfg.model).shape == (3, 5)
    d, rgb = apply_mip(shared.params["fine"], enc, torch.randn(3, 3), cfg.model)
    assert d.shape == (3, 5) and rgb.shape == (3, 5, 3) and bool((d >= 0).all())
    ro, rd = rays(6)
    res = render_mip360_rays(shared.params, ro, rd, 1e-3, cfg.model, cfg.render)
    assert [x.shape[1] for x in res.s_edges] == [9, 9, 5] and len(res.weights) == 2
