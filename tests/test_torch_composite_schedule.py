"""K2's schedule (``ops/composite_kernel.py`` ``rays_schedule``, the one
``csrc/composite.cu`` exports: rays a warp, a contiguous run of samples a
lane, persistent blocks), the plain version against the JAX Pallas kernel in
interpret mode at the sample counts the new body is instantiated for and on
a bfloat16 raw, the weights asked for only where they are read, and the
wrapper's refusals. The CUDA kernel is held against the plain version on the
card by ``chip_smoke.py`` (``k2_check``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import RenderConfig as JRenderConfig
from nerf_tpu.ops.composite_kernel import fused_volume_render_interleaved as jfvri
from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.ops import composite_kernel as ck

SAMPLE_COUNTS = (1, 16, 32, 45, 64, 128, 192, 200, 300)   # 300: the chunked body


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(-1.0, 40.0, (n, s)).astype(np.float32)
    sigma[:, ::7] = 0.0
    sigma[::5, s // 2] = 1e6                      # an opaque sample
    rgb = rng.uniform(0.0, 1.0, (n, s, 3)).astype(np.float32)
    raw = np.concatenate([sigma[..., None], rgb], -1).reshape(n, 4 * s)
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), axis=1).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    return raw, z, rd


@pytest.mark.parametrize("s", SAMPLE_COUNTS)
def test_segments_are_powers_of_two_that_hold_the_ray(s):
    p, k = ck.segment_lanes(s), ck.run_length(s)
    assert p & (p - 1) == 0 and p <= 32
    # a power of two from 16 on: runs of 4; else one sample a lane up to 32
    if s >= 16 and s & (s - 1) == 0:
        assert p == min(s // 4, 32) and k == min(s // p, ck.MAX_RUN)
    else:
        assert p >= s if s <= 32 else p == 32
    assert k == min(-(-s // p), ck.MAX_RUN) and ck.rays_per_warp(s) * p == 32
    # one chunk of p k samples holds the ray up to 224 (no lane owns only
    # padding past a full run); 300 takes a chunk of 224 in runs of 7, then
    # chunks of 32 in runs of 1
    chunks = ck.ray_chunks(s)
    if s <= 32 * ck.MAX_RUN:
        assert chunks == [(0, k)] and p * k >= s > p * (k - 1)
    else:
        assert chunks == [(0, 7), (224, 1), (256, 1), (288, 1)]


@pytest.mark.parametrize("s", SAMPLE_COUNTS)
@pytest.mark.parametrize("n", [1, 1001, 16384])
def test_schedule_covers_every_ray_and_sample_once(n, s):
    # on an H100 (132 SMs) at a few residencies, and on a small grid whose
    # warps walk many groups
    for grid in {ck.rays_grid(n, s, 132, b) for b in (1, 4, 8)} | {3}:
        block, warp, step, ray, first, stop = ck.rays_schedule(n, s, grid)
        assert block.max() < grid and warp.max() < ck.RAYS_WARPS
        count = np.zeros(n * s, np.int64)
        flat = np.repeat(ray * s + first, stop - first) + (
            np.arange((stop - first).sum()) - np.repeat(np.cumsum(stop - first) - (stop - first),
                                                        stop - first))
        np.add.at(count, flat, 1)
        assert (count == 1).all()
        # each step of a warp serves one group of rays_per_warp consecutive rays
        key = (block * ck.RAYS_WARPS + warp) * (step.max() + 1) + step
        order = np.argsort(key, kind="stable")
        starts = np.flatnonzero(np.r_[True, np.diff(key[order]) != 0])
        group = ray[order] // ck.rays_per_warp(s)
        assert (np.maximum.reduceat(group, starts) == np.minimum.reduceat(group, starts)).all()
        assert ((stop - first) <= ck.run_length(s)).all()


def test_grid_is_persistent_and_never_empty():
    assert ck.rays_grid(1, 1, 132, 8) == 1
    assert ck.rays_grid(16384, 128, 132, 8) == 132 * 8         # 2,048 blocks of work
    assert ck.rays_grid(16384, 64, 132, 8) == 1024             # 2 rays a warp
    assert ck.rays_grid(16384, 1, 132, 8) == 64                # 32 rays a warp
    assert ck.rays_grid(1001, 16, 132, 8) == -(-1001 // 64)    # 8 rays a warp, 8 warps
    assert ck.rays_grid(1001, 45, 132, 8) == -(-1001 // 8)     # a ray a warp


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("s", [1, 32, 192])
def test_plain_matches_pallas_interpret_at_the_new_counts(white, s):
    # atol 1e-5, as at S = 16, 45, 64 (tests/test_torch_composite_kernel.py):
    # the same log-space transmittance; the Pallas kernel's exclusive sum is
    # a triangular matmul, the port's a cumsum
    raw, z, rd = _inputs(70, s, s + 1)
    ref = jfvri(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                JRenderConfig(white_background=white), interpret=True)
    got = ck.fused_volume_render_interleaved(torch.tensor(raw), torch.tensor(z),
                                             torch.tensor(rd), RenderConfig(white_background=white))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [16, 64, 192])
def test_plain_matches_pallas_interpret_on_a_bf16_raw(s):
    # the ray kernels' raw_dtype: both widen each bf16 value exactly to
    # float32 and composite in float32; atol 1e-5 as on a float32 raw
    raw, z, rd = _inputs(70, s, 3 * s)
    raw_b = torch.tensor(raw).bfloat16()
    ref = jfvri(jnp.asarray(raw_b.float().numpy()).astype(jnp.bfloat16), jnp.asarray(z),
                jnp.asarray(rd), JRenderConfig(white_background=True), interpret=True)
    got = ck.fused_volume_render_interleaved(raw_b, torch.tensor(z), torch.tensor(rd),
                                             RenderConfig(white_background=True))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 45, 200])
def test_without_weights_same_outputs(s, dtype):
    raw, z, rd = _inputs(33, s, 5)
    args = (torch.tensor(raw).to(dtype), torch.tensor(z), torch.tensor(rd),
            RenderConfig(white_background=True))
    before = ck.launches
    full = ck.composite_rays(*args, with_weights=True)
    bare = ck.composite_rays(*args, with_weights=False)
    assert ck.launches == before                            # the CPU launches no kernel
    assert bare.weights is None and full.weights.shape == (33, s)
    for a, b in zip(bare[:3], full[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(full, ck.fused_volume_render_interleaved(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_engines_ask_for_weights_only_where_they_read_them(monkeypatch):
    # the coarse pass of the hierarchical mode reads them (sample_pdf); the
    # benchmark mode and the per-ray-depth pass (_at_depths: the fine pass,
    # the accel frames) drop them
    from pathlib import Path

    from nerf_tpu_torch.config import default_config
    from nerf_tpu_torch.render import engines

    params = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"
    asked = []
    real = engines.composite_rays

    def recording(raw, z, rd, cfg, with_weights=True):
        asked.append((z.shape[1], with_weights))
        return real(raw, z, rd, cfg, with_weights)

    monkeypatch.setattr(engines, "composite_rays", recording)
    engine = engines.CudaEngine(engines.SharedModel(default_config(), "cpu").load(str(params)))
    from nerf_tpu_torch.utils.cameras import spherical_pose

    pose = spherical_pose(30.0, -30.0, 4.0)
    engine.render_image(pose, (6, 4), 8, focal=5.0, mode="benchmark", monitor=False)
    assert asked == [(8, False)]
    del asked[:]
    engine.render_image(pose, (6, 4), 8, focal=5.0, mode="hierarchical", monitor=False)
    cfg = default_config().render
    assert asked == [(cfg.n_coarse, True), (cfg.n_coarse + cfg.n_fine, False)]


def test_launch_refuses_what_the_kernels_do_not_take():
    raw, z, rd = (torch.tensor(a) for a in _inputs(4, 8, 6))
    # a float32 raw must start 16-byte aligned (its samples are 16-byte loads)
    buf = torch.zeros(4 * 32 + 1)
    with pytest.raises(ValueError, match="aligned"):
        ck._launch(buf[1:].view(4, 32), z, rd, 1e10, 1e-10)
    with pytest.raises(ValueError, match="bfloat16"):
        ck._launch(raw.half(), z, rd, 1e10, 1e-10)
