"""The occupancy grid of the accel engine (``nerf_tpu_torch/ops/occupancy.py``)
against ``nerf_tpu.ops.occupancy``: the bake in float32 and in bf16 (the
latter through the plain version of the per-sample kernel K4, as the accel
engine bakes on the CPU), the mip, the lookups and the grid-guided depths in
each weight mode and ray stride. The JAX package's own occupancy tests load
lego weights; these build their grids from the weights in the repo
(``results/convergence/final_params.npz``, trained on the procedural sphere)
and from seeded weights of both variants. Inputs are made with numpy from a
seed and reach both packages as the same float32 values."""

import dataclasses
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import ModelConfig as JModelConfig
from nerf_tpu.config import bmild_config as jbmild
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.ops import occupancy as jocc
from nerf_tpu_torch.config import AccelConfig, ModelConfig
from nerf_tpu_torch.data import synthetic
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.ops import occupancy as occ
from nerf_tpu_torch.ops.mlp_kernel import make_cuda_apply_fn, pack_params
from nerf_tpu_torch.train.checkpoint import restore_bare_params
from nerf_tpu_torch.utils.cameras import generate_rays, spherical_pose

PARAMS = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"
G = 32
# float32 bake: both packages sum each product's 256 float32 terms in their
# own order, so sigma agrees to a few float32 ulps of the largest terms:
# observed 1.3e-5 abs (7e-6 relative where sigma > 1) on the trained network
F32_RTOL, F32_ATOL = 1e-5, 3e-5
# bf16 bake: the port's K4 rounds activations where apply_nerf does, but sums
# in its own order, so an activation now and then rounds to the neighbouring
# bf16 value: within one bf16 rounding (2^-8) of max sigma (observed 2.5e-4
# on the trained network, 1.5e-3 on seeded weights)
BF16_TOL = 2.0 ** -8                  # max |a - b| / max |sigma|
# the binary store's threshold: AccelConfig's 5 for the trained network;
# seeded weights' densities lie in [0.01, 0.08], so theirs is taken at 0.05
THRESHOLD = {"trained": 5.0, "seeded_reference": 0.05, "seeded_bmild": 0.05}
Z_ATOL = 1e-3                         # depths: sample_pdf's CDF sums differ in order (ROADMAP)


def _weights(kind):
    """(JAX cfg, port cfg, JAX params, port params) of one network:
    the trained fine network or seeded weights of a variant."""
    if kind == "trained":
        if not PARAMS.exists():
            pytest.skip(f"{PARAMS} not present")
        tree = restore_bare_params(str(PARAMS))["fine"]
        jc = JModelConfig()
    else:
        jc = JModelConfig() if kind == "seeded_reference" else jbmild().model
        tree = jax.device_get(jinit(jax.random.PRNGKey(7), jc))
    tc = ModelConfig(**dataclasses.asdict(jc))
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _jgrid(grid):
    """A port grid as the JAX package's (same values)."""
    return jocc.OccupancyGrid(occupancy=jnp.asarray(grid.occupancy.numpy()),
                              aabb_lo=jnp.asarray(grid.aabb_lo.numpy()),
                              aabb_hi=jnp.asarray(grid.aabb_hi.numpy()),
                              resolution=grid.resolution)


@pytest.fixture(scope="module")
def trained_density_grid():
    """The trained network's float32 density grid, baked by the port."""
    _, tc, _, tp = _weights("trained")
    return occ.build_occupancy_grid(tp, tc, resolution=G, compute_dtype=torch.float32,
                                    store="density")


@pytest.mark.parametrize("kind", ["trained", "seeded_reference", "seeded_bmild"])
def test_float32_bake_matches_the_jax_bake(kind):
    # apply_fn = each package's apply_nerf in float32: the density store to
    # F32_RTOL/F32_ATOL, and the binary store equal, with matter in it. Zero
    # directions normalize to NaN in the bmild variant (a colour only):
    # sigma, the only output kept, stays finite
    jc, tc, jp, tp = _weights(kind)
    jd = jocc.build_occupancy_grid(jp, jc, resolution=G, compute_dtype=jnp.float32,
                                   store="density")
    td = occ.build_occupancy_grid(tp, tc, resolution=G, compute_dtype=torch.float32,
                                  store="density")
    a, b = td.occupancy.numpy(), np.asarray(jd.occupancy)
    assert a.shape == (G ** 3,) and a.dtype == np.float32 and np.isfinite(a).all()
    assert a.min() >= 0.0 and a.max() > 0.0
    np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL)
    th = THRESHOLD[kind]
    jb = jocc.build_occupancy_grid(jp, jc, resolution=G, compute_dtype=jnp.float32,
                                   density_threshold=th)
    tb = occ.build_occupancy_grid(tp, tc, resolution=G, compute_dtype=torch.float32,
                                  density_threshold=th)
    np.testing.assert_array_equal(tb.occupancy.numpy(), np.asarray(jb.occupancy))
    np.testing.assert_array_equal(tb.occupancy.numpy(), (a > th).astype(np.float32))
    assert 0.0 < tb.occupancy.mean() < 1.0
    assert tb.resolution == G and tb.aabb_lo.tolist() == [-1.5] * 3
    assert tb.aabb_hi.tolist() == [1.5] * 3


@pytest.mark.parametrize("kind", ["trained", "seeded_reference", "seeded_bmild"])
def test_bf16_bake_through_k4_matches_the_jax_bf16_bake(kind):
    # the accel engine's bake on the CPU: K4's plain version on bf16 packed
    # weights; the JAX engine's: apply_nerf at its default bf16
    jc, tc, jp, tp = _weights(kind)
    jd = np.asarray(jocc.build_occupancy_grid(jp, jc, resolution=G, store="density").occupancy)
    td = occ.build_occupancy_grid(pack_params(tp, tc, torch.bfloat16), tc, resolution=G,
                                  apply_fn=make_cuda_apply_fn(torch.bfloat16), store="density")
    got = td.occupancy.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - jd).max() <= BF16_TOL * max(np.abs(jd).max(), 1e-6)


def test_downsample_and_query_match(trained_density_grid):
    grid = trained_density_grid
    jg = _jgrid(grid)
    for factor in (2, 4):
        np.testing.assert_array_equal(occ.downsample_grid(grid, factor).occupancy.numpy(),
                                      np.asarray(jocc.downsample_grid(jg, factor).occupancy))
    mip = occ.downsample_grid(grid, 2)
    assert mip.resolution == G // 2
    fine = grid.occupancy.numpy().reshape(G, G, G)
    coarse = mip.occupancy.numpy().reshape(G // 2, G // 2, G // 2)
    ix, iy, iz = np.nonzero(fine)
    assert np.all(coarse[ix // 2, iy // 2, iz // 2] >= fine[ix, iy, iz])   # dilates
    with pytest.raises(AssertionError):
        occ.downsample_grid(grid, 3)
    # random points in and around the box (|x| up to 2.5 > 1.5), and the cells'
    # own centres and faces
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.5, 2.5, size=(4096, 3)).astype(np.float32)
    edges = np.asarray([[-1.5, -1.5, -1.5], [1.5, 0.0, 0.0], [0.0, 1.5 - 1e-7, 0.0],
                        [-1.5 - 1e-6, 0.0, 0.0], [1e9, 0.0, 0.0]], np.float32)
    pts = np.concatenate([pts, edges])
    got = occ.query_occupancy(grid, torch.from_numpy(pts)).numpy()
    want = np.asarray(jocc.query_occupancy(jg, jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)
    outside = np.any(np.abs(pts) > 1.5, axis=-1)
    assert outside.sum() > 1000 and np.all(got[outside] == 0.0)
    c = (np.asarray([5, 17, 30]) + 0.5) / G * 3.0 - 1.5
    assert occ.query_occupancy(grid, torch.tensor(c[None], dtype=torch.float32))[0] == \
        fine[5, 17, 30]


def _rays(n, seed=0):
    """``n`` camera rays of a 16 x 12 view, scanline order, as numpy."""
    ro, rd = generate_rays(spherical_pose(30.0 + seed, -30.0, 4.0), 16, 12, 20.0, "cpu")
    return ro.reshape(-1, 3)[:n].numpy(), rd.reshape(-1, 3)[:n].numpy()


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("mode", ["occupancy", "alpha", "transmittance"])
def test_grid_guided_depths_match(trained_density_grid, mode, stride):
    # the binary grid for the occupancy weights, the density grid for the
    # others; 190 rays, so the last stride group is ragged (190 = 47 x 4 + 2)
    grid = trained_density_grid
    if mode == "occupancy":
        grid = grid._replace(occupancy=(grid.occupancy > 5.0).float())
    ro, rd = _rays(190)
    args = (2.0, 6.0, 16)
    kw = dict(n_probe=48, ray_stride=stride, weight_mode=mode)
    z = occ.grid_guided_z_vals(grid, torch.from_numpy(ro), torch.from_numpy(rd), *args,
                               **kw).numpy()
    zj = np.asarray(jocc.grid_guided_z_vals(_jgrid(grid), jnp.asarray(ro), jnp.asarray(rd),
                                            *args, **kw))
    assert z.shape == (190, 16) and z.dtype == np.float32
    np.testing.assert_allclose(z, zj, rtol=0, atol=Z_ATOL)
    assert np.all(np.diff(z, axis=-1) >= 0) and z.min() >= 2.0 and z.max() <= 6.0
    for g in range(0, 190, stride):                   # a group shares its leader's depths
        np.testing.assert_array_equal(z[g:g + stride], np.broadcast_to(z[g], z[g:g + stride].shape))
    if stride > 1:
        lead = occ.grid_guided_z_vals(grid, torch.from_numpy(ro[::stride]),
                                      torch.from_numpy(rd[::stride]), *args, n_probe=48,
                                      weight_mode=mode).numpy()
        np.testing.assert_array_equal(z[::stride], lead)
    # depths gather where the grid has matter, against uniform placement
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    pts_u = ro[:, None, :] + rd[:, None, :] * np.linspace(2.0, 6.0, 16)[None, :, None]
    hit = occ.query_occupancy(grid, torch.from_numpy(pts.astype(np.float32))).gt(0).float().mean()
    hit_u = occ.query_occupancy(grid, torch.from_numpy(pts_u.astype(np.float32))).gt(0).float().mean()
    assert hit > 1.5 * hit_u


def test_unknown_weight_mode_raises(trained_density_grid):
    ro, rd = _rays(8)
    with pytest.raises(ValueError, match="weight_mode"):
        occ.grid_guided_z_vals(trained_density_grid, torch.from_numpy(ro), torch.from_numpy(rd),
                               2.0, 6.0, 8, weight_mode="bogus")


def test_stochastic_draws_stay_per_ray(trained_density_grid):
    # with a generator the rays of a group share weights but draw their own
    # depths, sorted; the same generator state draws the same depths
    ro = torch.tensor([[0.0, 0.0, 4.0]]).expand(4, 3)
    rd = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
    kw = dict(n_probe=48, ray_stride=4, weight_mode="alpha")
    z = occ.grid_guided_z_vals(trained_density_grid, ro, rd, 2.0, 6.0, 16,
                               generator=torch.Generator().manual_seed(0), **kw)
    assert z.shape == (4, 16)
    assert not torch.allclose(z[0], z[1])
    assert bool((z[:, 1:] >= z[:, :-1]).all()) and z.min() >= 2.0 and z.max() <= 6.0
    again = occ.grid_guided_z_vals(trained_density_grid, ro, rd, 2.0, 6.0, 16,
                                   generator=torch.Generator().manual_seed(0), **kw)
    torch.testing.assert_close(z, again, rtol=0, atol=0)


def test_empty_ray_falls_back_to_near_uniform(trained_density_grid):
    # a ray that misses the box: the floor keeps its depths spread over [near, far]
    z = occ.grid_guided_z_vals(trained_density_grid, torch.tensor([[50.0, 50.0, 50.0]]),
                               torch.tensor([[0.0, 0.0, -1.0]]), 2.0, 6.0, 16, n_probe=48,
                               weight_mode="alpha")
    assert bool(((z >= 2.0) & (z <= 6.0)).all()) and float(z.std()) > 0.3


def test_default_aabb_holds_the_procedural_sphere(trained_density_grid):
    # the scene of make_procedural_dataset (and of final_params.npz) is a
    # sphere of radius 1 at the origin; the default box is [-1.5, 1.5]^3. The
    # trained network's grid has matter, about the sphere's share of the box,
    # and none in the cells on the box's faces
    sig = inspect.signature(synthetic._render_sphere_view).parameters
    center, radius = np.asarray(sig["center"].default), sig["radius"].default
    lo, hi = AccelConfig().aabb
    assert radius == 1.0 and np.all(center - radius > lo) and np.all(center + radius < hi)
    binary = (trained_density_grid.occupancy > 5.0).numpy().reshape(G, G, G)
    share = binary.mean()
    assert 0.5 * (4 / 3 * np.pi) / 27 < share < 1.5 * (4 / 3 * np.pi) / 27
    faces = np.zeros_like(binary)
    faces[[0, -1]] = faces[:, [0, -1]] = faces[:, :, [0, -1]] = True
    assert not binary[faces].any()
