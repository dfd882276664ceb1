"""The fused ray kernel's plain version (``fused_render_samples`` on CPU
tensors) vs the JAX Pallas kernel in interpret mode, and vs the port's own
``apply_nerf``. The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig, bmild_config as jbmild
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops.render_kernel import fused_render_samples as jfrs
from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.nerf import apply_nerf, params_from_numpy
from nerf_tpu_torch.ops import render_kernel
from nerf_tpu_torch.ops.mlp_kernel import pack_params
from nerf_tpu_torch.ops.render_kernel import fused_render_samples
from nerf_tpu_torch.utils.rendering import sample_points_on_rays


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
    before = render_kernel.launches
    raw, _ = fused_render_samples(packed, ro, rd, 2.0, 6.0, 64, tc, raw=True)
    assert torch.isfinite(raw).all()
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
