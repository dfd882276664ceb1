"""PyTorch port vs JAX package: cameras, ray sampling, hierarchical
sampling, volume rendering, and the render configuration."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu import config as jconfig
from nerf_tpu.config import RenderConfig as JRenderConfig
from nerf_tpu.utils import cameras as jcam
from nerf_tpu.utils import rendering as jrendering
from nerf_tpu.utils.rendering import sample_points_on_rays as jsample, volume_render as jvr
from nerf_tpu_torch import config
from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.utils import cameras
from nerf_tpu_torch.utils.rendering import (
    importance_sample,
    sample_pdf,
    sample_points_on_rays,
    volume_render,
)


def test_pose_helpers_match_jax():
    np.testing.assert_allclose(cameras.spherical_pose(47.0, -30.0, 4.0),
                               jcam.spherical_pose(47.0, -30.0, 4.0), atol=1e-6)
    np.testing.assert_allclose(cameras.orbit_poses(5), jcam.orbit_poses(5), atol=1e-6)
    np.testing.assert_allclose(cameras.gate_poses(3, phi_deg=-20.0),
                               jcam.gate_poses(3, phi_deg=-20.0), atol=1e-6)
    assert cameras.focal_from_angle(800, 0.6911112070083618) == \
        jcam.focal_from_angle(800, 0.6911112070083618)
    assert cameras.BENCHMARK_FOCAL == jcam.BENCHMARK_FOCAL


@pytest.mark.parametrize("pose_fn", [lambda: jcam.spherical_pose(30.0, -30.0, 4.0),
                                     lambda: jcam.orbit_poses(4)[1]])
def test_generate_rays_matches_jax(pose_fn):
    # atol 1e-6: a 3x3 rotation summed in a different order
    pose = pose_fn()
    ro_j, rd_j = jcam.generate_rays(jnp.asarray(pose), 37, 23, 41.5)
    ro, rd = cameras.generate_rays(pose, 37, 23, 41.5, device="cpu")
    assert ro.shape == (23, 37, 3) and rd.dtype == torch.float32
    np.testing.assert_allclose(ro.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), atol=1e-6)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    return ro, rd


def test_sample_points_match_jax():
    ro, rd = _rays(20, 0)
    p_j, z_j = jsample(jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0, 33)
    p, z = sample_points_on_rays(torch.tensor(ro), torch.tensor(rd), 2.0, 6.0, 33)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), atol=1e-6)


def test_perturbed_samples_stay_in_their_strata():
    ro, rd = _rays(50, 1)
    g = torch.Generator().manual_seed(0)
    _, z = sample_points_on_rays(torch.tensor(ro), torch.tensor(rd), 2.0, 6.0, 16,
                                 perturb=True, generator=g)
    _, z0 = sample_points_on_rays(torch.tensor(ro), torch.tensor(rd), 2.0, 6.0, 16)
    half = (6.0 - 2.0) / 15 / 2
    assert (z - z0).abs().max() <= half + 1e-6
    assert (z[:, 1:] >= z[:, :-1]).all()
    with pytest.raises(ValueError):
        sample_points_on_rays(torch.tensor(ro), torch.tensor(rd), 2.0, 6.0, 16, perturb=True)


@pytest.mark.parametrize("white", [False, True])
def test_volume_render_matches_jax(white):
    # atol 1e-5: the same cumprod and sums in float32, in another order
    rng = np.random.default_rng(3)
    n, s = 64, 24
    sigma = rng.uniform(-2.0, 30.0, (n, s)).astype(np.float32)
    sigma[:, ::5] = 0.0
    rgb = rng.uniform(0.0, 1.0, (n, s, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), axis=1).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ref = jvr(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(z), jnp.asarray(rd),
              JRenderConfig(white_background=white))
    got = volume_render(torch.tensor(sigma), torch.tensor(rgb), torch.tensor(z),
                        torch.tensor(rd), RenderConfig(white_background=white))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def _pdf_inputs(kind, n=48, s=64, seed=0):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), axis=1).astype(np.float32)
    if kind == "zero":
        w = np.zeros((n, s), np.float32)
    elif kind == "one_hot":
        w = np.zeros((n, s), np.float32)
        w[np.arange(n), rng.integers(0, s, n)] = 1.0
    elif kind == "dyadic":
        # integer weights >= 256 (so + 1e-5 rounds away) summing to 2^15 per
        # row: the CDF is exact in float32 in any summation order, one bin
        # holds over half of the mass in half of the rows
        w = np.full((n, s), 256.0, np.float32)
        for i in range(n):
            if i % 2:
                w[i, rng.integers(0, s)] += 2.0 ** 15 - 256.0 * s
            else:
                np.add.at(w[i], rng.integers(0, s, (2 ** 15 - 256 * s) // 256), 256.0)
    else:                                   # "random": many bins of tiny mass
        w = rng.uniform(0.0, 1.0, (n, s)).astype(np.float32) ** 4
    return z, w


@pytest.mark.parametrize("kind", ["zero", "one_hot", "dyadic"])
@pytest.mark.parametrize("n_importance", [128, 7])
def test_sample_pdf_matches_jax(kind, n_importance):
    # rtol 1e-6 on the depths. The bins and the interpolation are the same
    # arithmetic; the CDF's float32 sums run in another order (ATen's cumsum
    # vs XLA's reduce-window), which for the 64 equal bins of a zero-weight
    # row moves a depth by a few ulps. Dyadic rows have an exact CDF and
    # agree bit for bit.
    z, w = _pdf_inputs(kind)
    ref = np.asarray(jrendering.sample_pdf(jnp.asarray(z), jnp.asarray(w), n_importance,
                                           deterministic=True))
    got = sample_pdf(torch.tensor(z), torch.tensor(w), n_importance, deterministic=True)
    assert got.shape == (z.shape[0], n_importance) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    if kind == "dyadic":
        np.testing.assert_array_equal(got.numpy(), ref)


def test_sample_pdf_ill_conditioned_bins():
    # weights u^4 leave bins of ~1e-6 of the mass: there a CDF ulp (6e-8)
    # moves a draw by up to bin width x ulp / bin mass, ~1e-4 here, so the
    # two summation orders agree to 5e-4 (and to 1e-6 for most draws)
    z, w = _pdf_inputs("random")
    ref = np.asarray(jrendering.sample_pdf(jnp.asarray(z), jnp.asarray(w), 128,
                                           deterministic=True))
    got = sample_pdf(torch.tensor(z), torch.tensor(w), 128, deterministic=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    assert np.mean(np.abs(got - ref) <= 1e-6) > 0.9


def test_sample_pdf_draws_past_the_last_knot_fall_in_the_last_bin(monkeypatch):
    # the same draws fed to both: u = 0 lands on the first depth; u =
    # 0.99999994 (the largest float32 below 1) lies past cdf[-1] in the rows
    # where rounding left the CDF's sum just under 1, and lands on the last
    # depth (the final knot counts as +inf), exactly, in both
    z, w = _pdf_inputs("random", n=64, seed=3)
    n_imp = 6
    u = np.tile(np.array([0.0, 0.25, 0.5, 0.75, 0.9999999, 0.99999994], np.float32),
                (z.shape[0], 1))
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.tensor(u))
    ref = np.asarray(jrendering.sample_pdf(jnp.asarray(z), jnp.asarray(w), n_imp,
                                           key=jax.random.PRNGKey(0)))
    got = sample_pdf(torch.tensor(z), torch.tensor(w), n_imp,
                     generator=torch.Generator()).numpy()
    wt = torch.tensor(w) + 1e-5
    cdf_end = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)[:, -1].numpy()
    assert (cdf_end < u[0, -1]).any(), "no row exercises a draw past cdf[-1]"
    np.testing.assert_array_equal(got[:, 0], z[:, 0])
    np.testing.assert_array_equal(got[:, -1], z[:, -1])
    np.testing.assert_array_equal(ref[:, -1], z[:, -1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)
    with pytest.raises(ValueError):
        sample_pdf(torch.tensor(z), torch.tensor(w), n_imp)


@pytest.mark.parametrize("kind", ["one_hot", "dyadic"])
def test_importance_sample_matches_jax(kind):
    # well-conditioned coarse weights (one-hot, or a CDF exact in float32),
    # so rtol 1e-6 as above
    z, w = _pdf_inputs(kind, n=20, s=32, seed=5)
    ro, rd = _rays(20, 6)
    pts_j, z_j = jrendering.importance_sample(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                                              jnp.asarray(w), 48, deterministic=True)
    pts, zz = importance_sample(torch.tensor(ro), torch.tensor(rd), torch.tensor(z),
                                torch.tensor(w), 48, deterministic=True)
    assert zz.shape == (20, 32 + 48)
    np.testing.assert_allclose(zz.numpy(), np.asarray(z_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_j), rtol=1e-6, atol=1e-6)
    assert (zz[:, 1:] >= zz[:, :-1]).all()


def test_stochastic_sample_pdf_by_its_properties():
    z, w = _pdf_inputs("random", n=30, seed=7)
    draw = lambda seed: sample_pdf(torch.tensor(z), torch.tensor(w), 40,
                                   generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert (a >= torch.tensor(z[:, :1])).all() and (a <= torch.tensor(z[:, -1:])).all()


def test_render_config_matches_jax():
    # the hierarchical fields keep the JAX names and defaults
    ours = dataclasses.asdict(RenderConfig())
    theirs = dataclasses.asdict(JRenderConfig())
    assert ours == theirs
    ref = jconfig.reference_compat_config()
    compat = config.reference_compat_config()
    assert dataclasses.asdict(compat.render) == dataclasses.asdict(ref.render)
    assert compat.train.compute_dtype == ref.train.compute_dtype == "float32"
