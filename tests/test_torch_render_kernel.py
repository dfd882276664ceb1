"""The fused ray kernels' plain versions (the wrappers on CPU tensors) vs
the JAX Pallas kernels in interpret mode, and vs the port's own
``apply_nerf``: K1 (uniform depths), K3 (per-ray depths) and the composited
modes of both. The CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig, RenderConfig as JRenderConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops import render_kernel as jrk
from nerf_tpu.ops.render_kernel import fused_render_samples as jfrs
from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.models.nerf import apply_nerf, params_from_numpy
from nerf_tpu_torch.ops import render_kernel
from nerf_tpu_torch.ops.mlp_kernel import pack_params
from nerf_tpu_torch.ops.render_kernel import (
    composited_to_outputs,
    fused_render_samples,
    fused_render_samples_composited,
    fused_render_zvals_composited,
    fused_render_zvals_raw,
)
from nerf_tpu_torch.utils.rendering import sample_pdf, sample_points_on_rays, volume_render


def _cfgs(variant):
    jc = JModelConfig() if variant == "reference" else jbmild().model
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    return ro, rd


@pytest.mark.parametrize("variant", ["reference", "bmild"])
@pytest.mark.parametrize("S", [16, 64])
def test_plain_matches_pallas_interpret(variant, S):
    # f32 compute in both; rtol/atol 1e-4 as tests/test_render_kernel.py.
    # 41 rays: the Pallas kernel pads them to its ray block
    jc, tc = _cfgs(variant)
    p = jax.device_get(jinit(jax.random.PRNGKey(S), jc))
    ro, rd = _rays(41, S)
    raw_j, z_j = jfrs(p, jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0, S, jc,
                      dtype=jnp.float32, interpret=True, raw=True)
    raw, z = fused_render_samples(params_from_numpy(p, "cpu"), torch.tensor(ro),
                                  torch.tensor(rd), 2.0, 6.0, S, tc, raw=True,
                                  dtype=torch.float32)
    assert raw.shape == (41, 4 * S) and z.shape == (41, S)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-6)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["reference", "bmild"])
def test_plain_matches_apply_nerf(variant):
    # the packed layout evaluates the same network as apply_nerf; the only
    # differences are the z formula (ulps) and the normalization's rsqrt
    _, tc = _cfgs(variant)
    p = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(5), _cfgs(variant)[0])), "cpu")
    ro, rd = (torch.tensor(a) for a in _rays(13, 2))
    sigma, rgb, z = fused_render_samples(p, ro, rd, 2.0, 6.0, 8, tc, dtype=torch.float32)
    pts, z_ref = sample_points_on_rays(ro, rd, 2.0, 6.0, 8)
    s_ref, c_ref = apply_nerf(p, pts, rd[:, None].expand(pts.shape), tc)
    np.testing.assert_allclose(z.numpy(), z_ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), c_ref.numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_plain_close_to_f32():
    # bf16 activations against f32: the error the kernel's dtype costs,
    # bounded loosely (5e-2 on rgb) to catch a wrong rounding point
    _, tc = _cfgs("reference")
    p = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(6), JModelConfig())), "cpu")
    ro, rd = (torch.tensor(a) for a in _rays(9, 3))
    _, c32, _ = fused_render_samples(p, ro, rd, 2.0, 6.0, 16, tc, dtype=torch.float32)
    _, c16, _ = fused_render_samples(p, ro, rd, 2.0, 6.0, 16, tc)
    assert (c16 - c32).abs().max() < 5e-2


def test_padding_rays_are_finite_and_cpu_does_not_count_launches():
    _, tc = _cfgs("bmild")
    p = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(7), jbmild().model)), "cpu")
    packed = pack_params(p, tc)
    ro = torch.zeros(5, 3)
    rd = torch.ones(5, 3)
    before = dict(render_kernel.launches)
    raw, z = fused_render_samples(packed, ro, rd, 2.0, 6.0, 64, tc, raw=True)
    assert torch.isfinite(raw).all()
    # and through the hierarchical fine pass: sample_pdf on their weights,
    # then K3 at the merged depths
    w = torch.rand(5, 64, generator=torch.Generator().manual_seed(0))
    z_f = torch.sort(torch.cat([z, sample_pdf(z, w, 128, deterministic=True)], -1), -1).values
    assert torch.isfinite(z_f).all()
    assert torch.isfinite(fused_render_zvals_raw(packed, ro, rd, z_f, tc)).all()
    out = fused_render_zvals_composited(packed, ro, rd, z_f, tc)
    assert torch.isfinite(out).all()
    assert render_kernel.launches == before


def test_pack_params_layout():
    _, tc = _cfgs("bmild")
    p = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(8), jbmild().model)), "cpu")
    packed = pack_params(p, tc)
    assert packed.w0.shape == (64, 256) and packed.w0.dtype == torch.bfloat16
    assert packed.wt.shape == (7, 256, 256) and packed.bt.dtype == torch.float32
    assert packed.wdir.shape == (32, 128) and packed.wbn.shape == (256, 256)
    assert (packed.w0[63] == 0).all() and (packed.wdir[27:] == 0).all()
    # bmild's skip layer (5) sees [enc, h]: its enc rows go to wskip
    torch.testing.assert_close(packed.wskip[:63].float(),
                               p["trunk"][5]["w"][:63].bfloat16().float())
    narrow = dataclasses.replace(tc, hidden_dim=64)
    with pytest.raises(ValueError):
        pack_params(p, narrow)


def test_kernel_path_refuses_what_it_cannot_compute():
    # validated before any pointer reaches the CUDA library
    _, tc = _cfgs("reference")
    p = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(9), JModelConfig())), "cpu")
    ro, rd = (torch.tensor(a) for a in _rays(3, 4))
    with pytest.raises(ValueError, match="bfloat16"):
        render_kernel._launch(pack_params(p, tc, torch.float32), ro, rd, 2.0, 6.0, 8, tc)
    with pytest.raises(ValueError, match="rays_d"):
        render_kernel._launch(pack_params(p, tc), ro, rd[:2], 2.0, 6.0, 8, tc)
    with pytest.raises(ValueError, match="variant"):
        render_kernel._launch(pack_params(p, tc), ro, rd, 2.0, 6.0, 8, _cfgs("bmild")[1])
    with pytest.raises(ValueError, match="z_vals"):
        render_kernel._launch(pack_params(p, tc), ro, rd, 0.0, 0.0, 8, tc,
                              z_vals=torch.ones(3, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="z_vals"):
        render_kernel._launch(pack_params(p, tc), ro, rd, 0.0, 0.0, 8, tc,
                              z_vals=torch.ones(8, 3).t())


def _sorted_depths(n, s, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(2.0, 6.0, (n, s)), axis=1).astype(np.float32)


@pytest.mark.parametrize("variant", ["reference", "bmild"])
@pytest.mark.parametrize("S", [192, 96])
def test_zvals_plain_matches_pallas_interpret(variant, S):
    # K3: f32 compute in both, rtol/atol 1e-4 as the K1 test. 13 rays is not
    # a multiple of the Pallas kernel's 8- or 16-ray block, so it pads
    jc, tc = _cfgs(variant)
    p = jax.device_get(jinit(jax.random.PRNGKey(S + 1), jc))
    ro, rd = _rays(13, S)
    z = _sorted_depths(13, S, S)
    ref = jrk.fused_render_zvals_raw(p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jc,
                                     dtype=jnp.float32, interpret=True)
    raw = fused_render_zvals_raw(params_from_numpy(p, "cpu"), torch.tensor(ro),
                                 torch.tensor(rd), torch.tensor(z), tc, dtype=torch.float32)
    assert raw.shape == (13, 4 * S)
    np.testing.assert_allclose(raw.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_zvals_plain_matches_apply_nerf_and_strided_depths():
    # the per-ray-depth twin evaluates apply_nerf's network at o + d z, and
    # reads a z with a row stride (a view into a wider tensor) like a
    # contiguous one
    _, tc = _cfgs("reference")
    p = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(11), JModelConfig())), "cpu")
    ro, rd = (torch.tensor(a) for a in _rays(9, 12))
    wide = torch.tensor(_sorted_depths(9, 40, 13))
    z = wide[:, ::2][:, :20].contiguous()
    raw = fused_render_zvals_raw(p, ro, rd, z, tc, dtype=torch.float32).reshape(9, 20, 4)
    pts = ro[:, None] + rd[:, None] * z[..., None]
    s_ref, c_ref = apply_nerf(p, pts, rd[:, None].expand(pts.shape), tc)
    np.testing.assert_allclose(raw[..., 0].numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(raw[..., 1:].numpy(), c_ref.numpy(), rtol=1e-4, atol=1e-4)
    strided = torch.cat([z, z], dim=1)[:, :20]
    assert strided.stride(0) == 40
    torch.testing.assert_close(fused_render_zvals_raw(p, ro, rd, strided, tc,
                                                      dtype=torch.float32),
                               raw.reshape(9, 80), rtol=0, atol=0)


@pytest.fixture(scope="module")
def composited_setup():
    # the setup of tests/test_fused_composite.py: 100 rays, random weights
    jc = JModelConfig()
    p = jax.device_get(jinit(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    ro = (rng.normal(size=(100, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(100, 3)).astype(np.float32)
    return jc, ModelConfig(**dataclasses.asdict(jc)), p, ro, rd


@pytest.mark.parametrize("mode", ["uniform", "zvals"])
def test_composited_plain_matches_pallas_interpret(composited_setup, mode):
    # f32 compute in both; tests/test_fused_composite.py's tolerances: rgb
    # 5e-5, depth 5e-4 (uniform) / 1e-3 (per-ray depths), weights 5e-5
    jc, tc, p, ro, rd = composited_setup
    rcfg, jrcfg = RenderConfig(white_background=True), JRenderConfig(white_background=True)
    args = dict(sentinel=rcfg.dist_sentinel, eps=rcfg.transmittance_eps)
    pt, rot, rdt = params_from_numpy(p, "cpu"), torch.tensor(ro), torch.tensor(rd)
    if mode == "uniform":
        S, depth_tol = 64, 5e-4
        o8, w, z = jrk.fused_render_samples_composited(
            p, jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0, S, jc, dtype=jnp.float32,
            interpret=True, with_weights=True, **args)
        got8, got_w, got_z = fused_render_samples_composited(
            pt, rot, rdt, 2.0, 6.0, S, tc, dtype=torch.float32, with_weights=True, **args)
        np.testing.assert_allclose(got_z.numpy(), np.asarray(z), rtol=1e-6)
    else:
        S, depth_tol = 96, 1e-3
        z = _sorted_depths(100, S, 5)
        o8, w = jrk.fused_render_zvals_composited(
            p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jc, dtype=jnp.float32,
            interpret=True, with_weights=True, **args)
        got8, got_w = fused_render_zvals_composited(
            pt, rot, rdt, torch.tensor(z), tc, dtype=torch.float32, with_weights=True, **args)
    ref = jrk.composited_to_outputs(o8, w, jrcfg)
    got = composited_to_outputs(got8, got_w, rcfg)
    assert got8.shape == (100, 8) and got_w.shape == (100, S)
    np.testing.assert_array_equal(got8[:, 5:].numpy(), 0.0)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(ref.rgb), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.acc.numpy(), np.asarray(ref.acc), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=depth_tol, rtol=0)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights), atol=5e-5, rtol=0)


def test_composited_plain_matches_volume_render(composited_setup):
    # in-kernel compositing = the raw kernel + volume_render on its output
    # (log(max(1 - a, eps)) vs cumprod(1 - a + eps): equal to float32
    # rounding, atol 1e-5 with depths up to 6)
    _, tc, p, ro, rd = composited_setup
    pt, rot, rdt = params_from_numpy(p, "cpu"), torch.tensor(ro), torch.tensor(rd)
    z = torch.tensor(_sorted_depths(100, 48, 9))
    raw = fused_render_zvals_raw(pt, rot, rdt, z, tc).reshape(100, 48, 4)
    ref = volume_render(raw[..., 0], raw[..., 1:], z, rdt, RenderConfig())
    out8, w = fused_render_zvals_composited(pt, rot, rdt, z, tc, with_weights=True)
    got = composited_to_outputs(out8, w, RenderConfig())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_composited_to_outputs_keeps_weights_or_none():
    # no [R, 1] placeholder: the weights are [R, S] when asked for, else None
    out8 = torch.rand(6, 8, generator=torch.Generator().manual_seed(0))
    w = torch.rand(6, 10)
    assert composited_to_outputs(out8, None, RenderConfig()).weights is None
    res = composited_to_outputs(out8, w, RenderConfig(white_background=True))
    assert res.weights is w
    torch.testing.assert_close(res.rgb, out8[:, :3] + (1.0 - out8[:, 4:5]))
    torch.testing.assert_close(res.depth, out8[:, 3])
    _, tc = _cfgs("reference")
    p = params_from_numpy(jax.device_get(jinit(jax.random.PRNGKey(12), JModelConfig())), "cpu")
    ro, rd = (torch.tensor(a) for a in _rays(4, 14))
    out, z = fused_render_samples_composited(p, ro, rd, 2.0, 6.0, 16, tc)
    assert out.shape == (4, 8) and z.shape == (4, 16)
