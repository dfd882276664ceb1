"""The port's image metrics and depth normalization against the JAX
package's (``nerf_tpu/utils/metrics.py``, ``rendering.normalized_depth``)
on seeded numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.utils import metrics as jmetrics
from nerf_tpu.utils.rendering import RenderOutputs as JRenderOutputs, normalized_depth as jnd
from nerf_tpu_torch.utils import metrics
from nerf_tpu_torch.utils.rendering import RenderOutputs, normalized_depth

SSIM_TOL = 1e-5    # the two blurs sum the same float32 products in another order


def _image(seed, h=30, w=40):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


def _noisy(img, level, seed):
    noise = np.random.default_rng(seed).standard_normal(img.shape).astype(np.float32)
    return np.clip(img + level * noise, 0.0, 1.0)


def test_ssim_of_identical_images_is_exactly_one():
    img = _image(0)
    assert float(metrics.ssim(img, img)) == 1.0
    assert float(metrics.ssim(torch.from_numpy(img), torch.from_numpy(img))) == 1.0


@pytest.mark.parametrize("level", [0.01, 0.05, 0.2])
@pytest.mark.parametrize("seed", [1, 2])
def test_ssim_matches_jax(level, seed):
    img = _image(seed)
    other = _noisy(img, level, seed + 10)
    got = float(metrics.ssim(img, other))
    want = float(jmetrics.ssim(jnp.asarray(img), jnp.asarray(other)))
    assert abs(got - want) <= SSIM_TOL, (got, want)


def test_ssim_matches_jax_on_smooth_images_and_options():
    # a smooth image (the blur's cancellations are small), another window
    # and another range: max_val 255
    y, x = np.mgrid[0:48, 0:64].astype(np.float32)
    img = np.stack([np.sin(x / 7.0), np.cos(y / 5.0), np.sin((x + y) / 11.0)], -1) * 0.4 + 0.5
    other = _noisy(img, 0.03, 3)
    got = float(metrics.ssim(img, other, filter_size=7, filter_sigma=1.0))
    want = float(jmetrics.ssim(jnp.asarray(img), jnp.asarray(other), filter_size=7,
                               filter_sigma=1.0))
    assert abs(got - want) <= SSIM_TOL, (got, want)
    got = float(metrics.ssim(img * 255.0, other * 255.0, max_val=255.0))
    want = float(jmetrics.ssim(jnp.asarray(img * 255.0), jnp.asarray(other * 255.0),
                               max_val=255.0))
    assert abs(got - want) <= SSIM_TOL, (got, want)


def test_ssim_of_a_near_constant_pair_stays_at_most_one():
    # blur(x*x) - mu^2 cancels to a few ulps of 0.25 here, so the unclamped
    # ratio can exceed 1; both packages clamp the variances and the
    # covariance. The residual is that cancellation, summed in another
    # order in each package, so the values agree to 1e-4 here, not 1e-5
    flat = np.full((32, 32, 3), 0.5, np.float32)
    near = flat + 1e-4 * np.random.default_rng(4).standard_normal(flat.shape).astype(np.float32)
    got = float(metrics.ssim(flat, near))
    want = float(jmetrics.ssim(jnp.asarray(flat), jnp.asarray(near)))
    assert got <= 1.0 and want <= 1.0
    assert abs(got - want) <= 1e-4, (got, want)


def test_ssim_orders_noise_levels_as_jax_does():
    img = _image(5)
    low, high = _noisy(img, 0.02, 6), _noisy(img, 0.2, 7)
    ours = [float(metrics.ssim(img, o)) for o in (low, high)]
    theirs = [float(jmetrics.ssim(jnp.asarray(img), jnp.asarray(o))) for o in (low, high)]
    assert ours[0] > ours[1] and theirs[0] > theirs[1]
    assert all(-1.0 <= v <= 1.0 for v in ours)


def test_mse_and_psnr_match_jax():
    a, b = _image(8), _image(9)
    assert float(metrics.mse(a, b)) == pytest.approx(
        float(jmetrics.mse(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
    assert float(metrics.psnr(a, b)) == pytest.approx(
        float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), abs=1e-5)


def test_normalized_depth_matches_jax():
    # opacity from 0 (background: clamped to eps) to 1
    rng = np.random.default_rng(10)
    depth = rng.random(257).astype(np.float32) * 4.0
    acc = rng.random(257).astype(np.float32)
    acc[:5] = [0.0, 1e-7, 1e-6, 1.0, 0.5]
    rgb, w = np.zeros((257, 3), np.float32), np.zeros((257, 8), np.float32)
    got = normalized_depth(RenderOutputs(*(torch.from_numpy(t) for t in (rgb, depth, acc, w))))
    want = jnd(JRenderOutputs(*(jnp.asarray(t) for t in (rgb, depth, acc, w))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:2].numpy(), depth[:2] / 1e-6, rtol=1e-6)
    got = normalized_depth(RenderOutputs(*(torch.from_numpy(t) for t in (rgb, depth, acc, w))),
                           eps=0.1)
    want = jnd(JRenderOutputs(*(jnp.asarray(t) for t in (rgb, depth, acc, w))), eps=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
