"""The compositor kernel's plain version (``fused_volume_render_interleaved``
on CPU tensors) vs the JAX Pallas kernel in interpret mode and vs
``volume_render``. The CUDA kernel is held against the same plain version
on the card by ``chip_smoke.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import RenderConfig as JRenderConfig
from nerf_tpu.ops.composite_kernel import fused_volume_render_interleaved as jfvri
from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.ops import composite_kernel
from nerf_tpu_torch.ops.composite_kernel import fused_volume_render_interleaved
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
