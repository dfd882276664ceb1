"""The compositor kernels' plain version (``fused_volume_render_interleaved``
and the planar ``fused_volume_render`` on CPU tensors) vs the JAX Pallas
kernels in interpret mode and vs ``volume_render``. The CUDA kernels are held
against the same plain version on the card by ``chip_smoke.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import RenderConfig as JRenderConfig
from nerf_tpu.ops.composite_kernel import fused_volume_render as jfvr
from nerf_tpu.ops.composite_kernel import fused_volume_render_interleaved as jfvri
from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.ops import composite_kernel
from nerf_tpu_torch.ops.composite_kernel import (
    fused_volume_render,
    fused_volume_render_interleaved,
)
from nerf_tpu_torch.utils.rendering import volume_render


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(-1.0, 40.0, (n, s)).astype(np.float32)
    sigma[:, ::6] = 0.0
    sigma[::4, s // 2] = 1e6                      # an opaque sample
    rgb = rng.uniform(0.0, 1.0, (n, s, 3)).astype(np.float32)
    raw = np.concatenate([sigma[..., None], rgb], -1).reshape(n, 4 * s)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), axis=1).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    return raw, sigma, rgb, z, rd


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("s", [16, 64, 45])
def test_plain_matches_pallas_interpret(white, s):
    # atol 1e-5: the same log-space transmittance; the Pallas kernel's
    # exclusive sum is a triangular matmul, the port's a cumsum
    raw, _, _, z, rd = _inputs(70, s, s)
    ref = jfvri(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                JRenderConfig(white_background=white), interpret=True)
    got = fused_volume_render_interleaved(torch.tensor(raw), torch.tensor(z),
                                          torch.tensor(rd),
                                          RenderConfig(white_background=white))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_plain_matches_volume_render():
    # volume_render multiplies (1 - alpha + 1e-10); the kernel sums
    # log(max(1 - alpha, 1e-10)): the factors differ by at most eps = 1e-10,
    # so the maps agree to float32 rounding (atol 1e-5 with depth up to 6)
    raw, sigma, rgb, z, rd = _inputs(50, 32, 1)
    cfg = RenderConfig(white_background=True)
    ref = volume_render(torch.tensor(sigma), torch.tensor(rgb), torch.tensor(z),
                        torch.tensor(rd), cfg)
    got = fused_volume_render_interleaved(torch.tensor(raw), torch.tensor(z),
                                          torch.tensor(rd), cfg)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_broadcast_depths_and_no_cpu_launch_count():
    raw, _, _, z, rd = _inputs(10, 16, 2)
    zb = torch.linspace(2.0, 6.0, 16).expand(10, 16)
    before = composite_kernel.launches
    got = fused_volume_render_interleaved(torch.tensor(raw), zb, torch.tensor(rd))
    ref = fused_volume_render_interleaved(torch.tensor(raw), zb.contiguous(),
                                          torch.tensor(rd))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b)
    assert composite_kernel.launches == before
    with pytest.raises(ValueError):
        fused_volume_render_interleaved(torch.zeros(10, 15), zb, torch.tensor(rd))


# -- K6: the planar compositor --------------------------------------------------


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("form", ["nS3", "planes"])
def test_planar_plain_matches_pallas_interpret_and_volume_render(white, form):
    # atol 1e-5 against the Pallas kernel (the same log-space transmittance)
    # and against volume_render (factors differ by <= eps = 1e-10); rgb as one
    # [N, S, 3] array or as a tuple of three planes; 70 rays x 45 samples:
    # neither a multiple of a block
    _, sigma, rgb, z, rd = _inputs(70, 45, 7)
    jrgb = jnp.asarray(rgb) if form == "nS3" else tuple(jnp.asarray(rgb[..., c])
                                                         for c in range(3))
    ref = jfvr(jnp.asarray(sigma), jrgb, jnp.asarray(z), jnp.asarray(rd),
               JRenderConfig(white_background=white), 64, True)
    trgb = torch.tensor(rgb) if form == "nS3" else tuple(torch.tensor(rgb[..., c])
                                                          for c in range(3))
    cfg = RenderConfig(white_background=white)
    before = composite_kernel.planar_launches
    got = fused_volume_render(torch.tensor(sigma), trgb, torch.tensor(z), torch.tensor(rd), cfg)
    assert composite_kernel.planar_launches == before     # the CPU path launches no kernel
    assert got.rgb.shape == (70, 3) and got.weights.shape == (70, 45)
    vr = volume_render(torch.tensor(sigma), torch.tensor(rgb), torch.tensor(z),
                       torch.tensor(rd), cfg)
    for a, b, c in zip(got, ref, vr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=0)


def test_planar_takes_views_of_the_mlp_kernels_output():
    # sigma and rgb as strided views of one [N * S, 4] buffer, as
    # fused_nerf_apply returns them
    _, sigma, rgb, z, rd = _inputs(12, 16, 8)
    out4 = torch.tensor(np.concatenate([sigma[..., None], rgb], -1).reshape(-1, 4))
    got = fused_volume_render(out4[:, 0].reshape(12, 16), out4[:, 1:4].reshape(12, 16, 3),
                              torch.tensor(z), torch.tensor(rd))
    ref = fused_volume_render(torch.tensor(sigma), torch.tensor(rgb), torch.tensor(z),
                              torch.tensor(rd))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="three"):
        fused_volume_render(torch.tensor(sigma), (torch.tensor(rgb[..., 0]),) * 2,
                            torch.tensor(z), torch.tensor(rd))


@pytest.mark.parametrize("form", ["nS3", "planes"])
def test_planar_gradients_match_jax(form):
    # the loss of tests/test_composite_kernel.py::test_gradients_match_jnp;
    # both packages recompute through their volume_render in the backward
    _, sigma, rgb, z, rd = _inputs(16, 33, 9)
    sigma = (sigma * 0.1).astype(np.float32)              # translucent: gradients everywhere

    def jloss(sigma, rgb):
        out = jfvr(sigma, rgb, jnp.asarray(z), jnp.asarray(rd), JRenderConfig(), 16, True)
        return jnp.mean((out.rgb - 0.4) ** 2) + jnp.mean(out.depth) * 0.01

    jrgb = jnp.asarray(rgb) if form == "nS3" else tuple(jnp.asarray(rgb[..., c])
                                                         for c in range(3))
    gs_j, gr_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sigma), jrgb)
    gr_j = np.asarray(gr_j) if form == "nS3" else np.stack([np.asarray(g) for g in gr_j], -1)

    ts = torch.tensor(sigma, requires_grad=True)
    tr = torch.tensor(rgb, requires_grad=True)
    trgb = tr if form == "nS3" else tuple(tr[..., c] for c in range(3))
    out = fused_volume_render(ts, trgb, torch.tensor(z), torch.tensor(rd))
    loss = ((out.rgb - 0.4) ** 2).mean() + out.depth.mean() * 0.01
    gs, gr = torch.autograd.grad(loss, (ts, tr))
    np.testing.assert_allclose(gs.numpy(), np.asarray(gs_j), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gr.numpy(), gr_j, rtol=1e-4, atol=1e-7)
    assert float(gs.abs().max()) > 0 and float(gr.abs().max()) > 0
