"""PyTorch port vs JAX package: cameras, ray sampling, volume rendering."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import RenderConfig as JRenderConfig
from nerf_tpu.utils import cameras as jcam
from nerf_tpu.utils.rendering import sample_points_on_rays as jsample, volume_render as jvr
from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.utils import cameras
from nerf_tpu_torch.utils.rendering import sample_points_on_rays, volume_render


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
