"""The hierarchical pipeline (``render/pipeline.render_rays``) of the port vs
the JAX package's, on the trained weights of
``results/convergence/final_params.npz``, and its stochastic form by its
properties."""

import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig, RenderConfig as JRenderConfig
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.render.pipeline import render_rays as jrender_rays
from nerf_tpu.train.checkpoint import restore_bare_params as jrestore
from nerf_tpu.utils.cameras import generate_rays as jgenerate_rays, spherical_pose
from nerf_tpu_torch.config import ModelConfig, RenderConfig
from nerf_tpu_torch.models.nerf import apply_nerf, params_from_numpy
from nerf_tpu_torch.render.pipeline import RayRenderResult, render_rays
from nerf_tpu_torch.train.checkpoint import restore_bare_params

PARAMS = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"


@pytest.fixture(scope="module")
def scene():
    """Trained coarse and fine params in both packages, and 16x12 camera
    rays of the trained scene (made once, by the JAX package, as numpy)."""
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    jc = JModelConfig()
    template = {"fine": jinit(jax.random.PRNGKey(0), jc), "coarse": jinit(jax.random.PRNGKey(1), jc)}
    jp = jax.tree.map(jnp.asarray, jrestore(str(PARAMS), template))
    tp = params_from_numpy(restore_bare_params(str(PARAMS)), "cpu")
    ro, rd = jgenerate_rays(jnp.asarray(spherical_pose(30.0, -30.0, 4.0)), 16, 12, 20.0)
    ro = np.asarray(ro).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)
    return jc, ModelConfig(**dataclasses.asdict(jc)), jp, tp, ro, rd


@pytest.mark.parametrize("use_importance", [True, False])
def test_render_rays_matches_jax_f32(scene, use_importance):
    # float32 throughout, deterministic: the fine depths are sample_pdf's
    # midpoint draws (use_importance) or a uniform 128-sample grid. rgb,
    # acc and weights agree to 1e-4 and depth to 1e-3 (encoding ulps at
    # the top band, CDF sums in another order)
    jc, tc, jp, tp, ro, rd = scene
    jrcfg = JRenderConfig(white_background=True, use_importance=use_importance)
    rcfg = RenderConfig(white_background=True, use_importance=use_importance)
    ref = jrender_rays(jp["coarse"], jp["fine"], jnp.asarray(ro), jnp.asarray(rd), jc, jrcfg)
    got = render_rays(tp["coarse"], tp["fine"], torch.tensor(ro), torch.tensor(rd), tc, rcfg)
    assert isinstance(got, RayRenderResult)
    n_fine = 64 + 128 if use_importance else 128
    assert got.coarse.weights.shape == (192, 64) and got.fine.weights.shape == (192, n_fine)
    for ours, theirs in ((got.coarse, ref.coarse), (got.fine, ref.fine)):
        np.testing.assert_allclose(ours.rgb.numpy(), np.asarray(theirs.rgb), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours.acc.numpy(), np.asarray(theirs.acc), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours.weights.numpy(), np.asarray(theirs.weights),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours.depth.numpy(), np.asarray(theirs.depth), atol=1e-3,
                                   rtol=0)
    # the scene is not empty: some rays are opaque
    assert got.fine.acc.max() > 0.9


def test_injected_evaluator_and_compositor(scene):
    # apply_fn and composite_fn replace the MLP and volume_render on both
    # passes of a deterministic render
    _, tc, _, tp, ro, rd = scene
    calls = {"apply": [], "composite": []}

    def apply_fn(params, pts, dirs, cfg, compute_dtype):
        calls["apply"].append(pts.shape[1])
        return apply_nerf(params, pts, dirs, cfg, compute_dtype)

    def composite_fn(sigma, rgb, z, rays_d, rcfg):
        calls["composite"].append(z.shape[1])
        from nerf_tpu_torch.utils.rendering import volume_render
        return volume_render(sigma, rgb, z, rays_d, rcfg)

    rcfg = RenderConfig()
    a = render_rays(tp["coarse"], tp["fine"], torch.tensor(ro), torch.tensor(rd), tc, rcfg,
                    apply_fn=apply_fn, composite_fn=composite_fn)
    b = render_rays(tp["coarse"], tp["fine"], torch.tensor(ro), torch.tensor(rd), tc, rcfg)
    assert calls == {"apply": [64, 192], "composite": [64, 192]}
    torch.testing.assert_close(a.fine.rgb, b.fine.rgb, rtol=0, atol=0)


def test_stochastic_render_rays_by_its_properties(scene):
    # jittered coarse depths and random importance draws: every fine depth
    # is sorted and within [near, far], one seed gives one render, and
    # another seed another
    _, tc, _, tp, ro, rd = scene
    rcfg = RenderConfig()
    ro, rd = torch.tensor(ro[:48]), torch.tensor(rd[:48])
    seen_z = []

    def apply_fn(params, pts, dirs, cfg, compute_dtype):
        seen_z.append(((pts - ro[:, None]) / rd[:, None]).mean(-1))
        return apply_nerf(params, pts, dirs, cfg, compute_dtype)

    def run(seed):
        seen_z.clear()
        res = render_rays(tp["coarse"], tp["fine"], ro, rd, tc, rcfg,
                          generator=torch.Generator().manual_seed(seed), perturb=True,
                          apply_fn=apply_fn)
        return res, [z.clone() for z in seen_z]

    a, (zc_a, zf_a) = run(0)
    b, (zc_b, zf_b) = run(0)
    c, (zc_c, zf_c) = run(1)
    assert zf_a.shape == (48, 192)
    for z in (zc_a, zf_a, zf_c):
        assert (z[:, 1:] >= z[:, :-1] - 1e-4).all()
        assert (z >= rcfg.near - 1e-4).all() and (z <= rcfg.far + 1e-4).all()
    torch.testing.assert_close(a.fine.rgb, b.fine.rgb, rtol=0, atol=0)
    torch.testing.assert_close(zf_a, zf_b, rtol=0, atol=0)
    assert not torch.equal(zf_a, zf_c) and not torch.equal(zc_a, zc_c)
    assert torch.isfinite(a.fine.rgb).all()
    # random importance draws without jitter: reproducible too
    d = render_rays(tp["coarse"], tp["fine"], ro, rd, tc, rcfg,
                    generator=torch.Generator().manual_seed(2))
    e = render_rays(tp["coarse"], tp["fine"], ro, rd, tc, rcfg,
                    generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(d.fine.depth, e.fine.depth, rtol=0, atol=0)


def test_perturb_needs_a_generator_and_noise_waits_for_training(scene):
    _, tc, _, tp, ro, rd = scene
    ro, rd = torch.tensor(ro[:4]), torch.tensor(rd[:4])
    with pytest.raises(ValueError, match="Generator"):
        render_rays(tp["coarse"], tp["fine"], ro, rd, tc, RenderConfig(), perturb=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        render_rays(tp["coarse"], tp["fine"], ro, rd, tc, RenderConfig(raw_noise_std=1.0),
                    generator=torch.Generator(), perturb=True)
