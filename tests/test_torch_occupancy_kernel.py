"""The accel engine's depths kernel (``csrc/occupancy.cu``) on its host side:
what ``ops/occupancy.grid_guided_z_vals`` hands the launcher and what the
launcher hands the C entry point, on meta tensors (a meta tensor has no
value, so any read back to the host raises); the limits; and an emulation of
the kernel's warp (a lane's run of probes, the warp scans, the binary search,
the fan-out to the group's rows) against the plain version. The kernel
itself runs only on the card, where ``chip_smoke.py`` holds it against the
plain version."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops import occupancy as jocc
from nerf_tpu_torch.ops import _ext
from nerf_tpu_torch.ops import occupancy as occ
from nerf_tpu_torch.utils.cameras import generate_rays, spherical_pose

G = 16
N_RAYS = 190          # ragged last groups at strides 3 (63 x 3 + 1) and 4 (47 x 4 + 2)
NEAR, FAR, S, P = 2.0, 6.0, 16, 48
LANES = 32
# the emulation sums in the kernel's order, the plain version in ATen's: the
# knots differ by float32 ulps, a depth by their share of a bin's width; in
# the transmittance weights also the log-transmittance's sums (terms down to
# log(1e-7) = -16), which moved depths in [2, 6] by up to 1.3e-5
EMU_ATOL = 5e-5
Z_ATOL = 1e-3         # against the JAX package (tests/test_torch_occupancy.py)


def _grid(binary: bool) -> occ.OccupancyGrid:
    """A density grid from a seed: a sphere of radius 1 with noisy density,
    some empty cells inside; thresholded at 5 for the occupancy weights."""
    rng = np.random.default_rng(3)
    c = (np.arange(G) + 0.5) / G * 3.0 - 1.5
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    dens = np.where(r < 1.0, rng.uniform(0.0, 40.0, r.shape), 0.0)
    dens *= rng.uniform(size=r.shape) > 0.2
    t = torch.from_numpy(dens.astype(np.float32).reshape(-1))
    if binary:
        t = (t > 5.0).float()
    return occ.OccupancyGrid(t, torch.full((3,), -1.5), torch.full((3,), 1.5), G)


def _rays(n=N_RAYS):
    ro, rd = generate_rays(spherical_pose(30.0, -30.0, 4.0), 16, 12, 14.0, "cpu")
    return ro.reshape(-1, 3)[:n].contiguous(), rd.reshape(-1, 3)[:n].contiguous()


def _jgrid(grid):
    return jocc.OccupancyGrid(occupancy=jnp.asarray(grid.occupancy.numpy()),
                              aabb_lo=jnp.asarray(grid.aabb_lo.numpy()),
                              aabb_hi=jnp.asarray(grid.aabb_hi.numpy()),
                              resolution=grid.resolution)


# -- an emulation of the kernel's warp, in float32, one warp a row of tensors --

def _probe_z(i, n_probe):
    return NEAR + (FAR - NEAR) * ((i.float() + 0.5) / n_probe)


def _warp_exclusive(v):
    """warp_exclusive: Hillis-Steele over the 32 lanes, shifted by one."""
    incl = v.clone()
    for o in (1, 2, 4, 8, 16):
        prev = incl.clone()
        incl[:, o:] = prev[:, o:] + prev[:, :-o]
    return torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)


def _warp_sum(v):
    """warp_sum: the xor butterfly (every lane ends with the same sum)."""
    lanes = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, :1]


def _invert(cdf, u, n_probe):
    """invert: the binary search for the last knot j < P with cdf[j] <= u,
    the 1e-5 rule and the lerp, for u [R, S] against cdf [R, P + 1]."""
    a = torch.zeros(u.shape, dtype=torch.long)
    b = torch.full(u.shape, n_probe, dtype=torch.long)
    while bool((a < b).any()):
        mid = (a + b) // 2
        go = a < b
        le = torch.gather(cdf, 1, mid.clamp(max=n_probe)) <= u
        a = torch.where(go & le, mid + 1, a)
        b = torch.where(go & ~le, mid, b)
    below = (a - 1).clamp(min=0)
    above = (below + 1).clamp(max=n_probe - 1)
    cb = torch.gather(cdf, 1, below)
    denom = torch.gather(cdf, 1, below + 1) - cb
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cb) / denom
    zb = _probe_z(below, n_probe)
    return zb + t * (_probe_z(above, n_probe) - zb)


def _kernel_emulation(grid, ro, rd, n_samples, n_probe, stride, mode, floor=1e-3, u=None):
    n = ro.shape[0]
    n_groups = -(-n // stride)
    lead = torch.clamp(torch.arange(n_groups) * stride, max=n - 1)
    o, d = ro[lead], rd[lead]
    k = -(-n_probe // LANES)
    i = torch.arange(LANES * k)                       # lane l's run: l * k ... l * k + k - 1
    valid = (i < n_probe).reshape(LANES, k)
    x = o[:, None, :] + d[:, None, :] * _probe_z(i, n_probe)[None, :, None]
    g = grid.resolution
    c = torch.floor((x - grid.aabb_lo) / (grid.aabb_hi - grid.aabb_lo) * g)
    inside = ((c >= 0) & (c < g)).all(dim=-1)
    ci = torch.where(inside[..., None], c, torch.zeros_like(c)).long()
    value = grid.occupancy[(ci[..., 0] * g + ci[..., 1]) * g + ci[..., 2]]
    value = torch.where(inside, value, torch.zeros_like(value)).reshape(n_groups, LANES, k)
    dz = torch.tensor((FAR - NEAR) / n_probe, dtype=torch.float32) * torch.sqrt(
        d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    zero = torch.zeros(n_groups, LANES)
    w = torch.zeros_like(value)
    if mode == "transmittance":
        alpha = 1.0 - torch.exp(-value * dz[:, None, None])
        lt = torch.log1p(-torch.clamp(alpha, max=0.9999999))
        run_log = zero.clone()
        for j in range(k):
            run_log = run_log + torch.where(valid[:, j], lt[:, :, j], 0.0)
        incl = _warp_exclusive(run_log)
        for j in range(k):
            incl = incl + lt[:, :, j]
            w[:, :, j] = alpha[:, :, j] * torch.exp(incl - lt[:, :, j]) + floor + 1e-5
    else:
        if mode == "alpha":
            value = 1.0 - torch.exp(-value * dz[:, None, None])
        w = value + floor + 1e-5
    w = torch.where(valid, w, torch.zeros_like(w))
    run = zero.clone()
    for j in range(k):
        run = run + w[:, :, j]
    total = _warp_sum(run)
    run_pdf = zero.clone()
    for j in range(k):
        run_pdf = run_pdf + w[:, :, j] / total
    acc = _warp_exclusive(run_pdf)
    knots = torch.zeros_like(w)
    for j in range(k):
        acc = acc + w[:, :, j] / total
        knots[:, :, j] = acc
    cdf = torch.cat([torch.zeros(n_groups, 1), knots.reshape(n_groups, -1)[:, :n_probe]], dim=1)
    if u is None:
        mid = ((torch.arange(n_samples).float() + 0.5) / n_samples).expand(n_groups, n_samples)
        return _invert(cdf, mid, n_probe).repeat_interleave(stride, dim=0)[:n]
    z = _invert(cdf.repeat_interleave(stride, dim=0)[:n], u, n_probe)
    return torch.sort(z, dim=-1).values


@pytest.mark.parametrize("stride", [1, 3, 4])
@pytest.mark.parametrize("mode", ["occupancy", "alpha", "transmittance"])
def test_plain_version_and_kernel_emulation(mode, stride):
    # the CPU path is the plain version, which is the JAX package's function;
    # the kernel's order of work gives the plain version's depths
    grid = _grid(binary=mode == "occupancy")
    ro, rd = _rays()
    kw = dict(n_probe=P, ray_stride=stride, weight_mode=mode)
    z = occ.grid_guided_z_vals(grid, ro, rd, NEAR, FAR, S, **kw)
    plain = occ.grid_guided_z_vals_plain(grid, ro, rd, NEAR, FAR, S, **kw)
    torch.testing.assert_close(z, plain, rtol=0, atol=0)
    zj = np.asarray(jocc.grid_guided_z_vals(_jgrid(grid), jnp.asarray(ro.numpy()),
                                            jnp.asarray(rd.numpy()), NEAR, FAR, S, **kw))
    np.testing.assert_allclose(plain.numpy(), zj, rtol=0, atol=Z_ATOL)
    emu = _kernel_emulation(grid, ro, rd, S, P, stride, mode)
    assert emu.shape == (N_RAYS, S) and emu.dtype == torch.float32
    torch.testing.assert_close(emu, plain, rtol=0, atol=EMU_ATOL)
    assert bool((emu[:, 1:] >= emu[:, :-1]).all())            # sorted as drawn
    # the grid placed the depths: the midpoints would be uniform
    assert float((plain[:, 1:] - plain[:, :-1]).std()) > 0.01


@pytest.mark.parametrize("n_probe", [1, 31, 33, 100])
def test_kernel_emulation_at_ragged_probe_counts(n_probe):
    # lanes past the last probe hold empty runs
    grid = _grid(binary=False)
    ro, rd = _rays()
    plain = occ.grid_guided_z_vals_plain(grid, ro, rd, NEAR, FAR, S, n_probe=n_probe,
                                         ray_stride=4, weight_mode="alpha")
    emu = _kernel_emulation(grid, ro, rd, S, n_probe, 4, "alpha")
    torch.testing.assert_close(emu, plain, rtol=0, atol=EMU_ATOL)


@pytest.mark.parametrize("stride", [1, 3])
def test_kernel_emulation_of_the_stochastic_form(stride):
    # the plain version's draws (draw_uniforms, from the same generator
    # state), each row against its group's CDF, then sorted
    grid = _grid(binary=False)
    ro, rd = _rays()
    plain = occ.grid_guided_z_vals_plain(grid, ro, rd, NEAR, FAR, S, n_probe=P,
                                         generator=torch.Generator().manual_seed(5),
                                         ray_stride=stride, weight_mode="transmittance")
    u = torch.rand((N_RAYS, S), generator=torch.Generator().manual_seed(5))
    emu = _kernel_emulation(grid, ro, rd, S, P, stride, "transmittance", u=u)
    torch.testing.assert_close(emu, plain, rtol=0, atol=EMU_ATOL)


# -- the launcher's arguments, on meta tensors ------------------------------

def _meta(n=N_RAYS):
    grid = occ.OccupancyGrid(torch.empty(G ** 3, device="meta"), torch.empty(3, device="meta"),
                             torch.empty(3, device="meta"), G)
    return grid, torch.empty(n, 3, device="meta"), torch.empty(n, 3, device="meta")


@pytest.mark.parametrize("drawn", [False, True])
@pytest.mark.parametrize("mode", ["occupancy", "alpha", "transmittance"])
def test_dispatch_hands_the_launcher_its_arguments(monkeypatch, mode, drawn):
    grid, ro, rd = _meta()
    seen = []
    monkeypatch.setattr(occ, "_launch", lambda *a: seen.append(a) or "depths")
    gen = torch.Generator().manual_seed(0) if drawn else None
    out = occ.grid_guided_z_vals(grid, ro, rd, NEAR, FAR, S, n_probe=P, generator=gen,
                                 floor=2e-3, ray_stride=4, weight_mode=mode)
    assert out == "depths" and len(seen) == 1
    g, o, d, near, far, n_samples, n_probe, u, floor, stride, code = seen[0]
    # the grid itself: its corners reach the kernel as device tensors
    assert g is grid and o is ro and d is rd
    assert (near, far, n_samples, n_probe, floor, stride) == (NEAR, FAR, S, P, 2e-3, 4)
    assert code == {"occupancy": 0, "alpha": 1, "transmittance": 2}[mode]
    if drawn:
        assert u.device.type == "meta" and u.shape == (N_RAYS, S) and u.dtype == torch.float32
    else:
        assert u is None


@pytest.mark.parametrize("origins", ["rows", "broadcast"])
@pytest.mark.parametrize("drawn", [False, True])
def test_launcher_hands_the_entry_point_device_pointers(monkeypatch, drawn, origins):
    # a frame of one chunk, unpadded, passes generate_rays' broadcast origins
    grid, ro, rd = _meta()
    if origins == "broadcast":
        ro = torch.empty(3, device="meta").expand(N_RAYS, 3)
    calls = []

    class Lib:
        def occupancy_z_vals(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(occ, "load", lambda: Lib())
    monkeypatch.setattr(_ext, "ptr", lambda t: t)
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: ("stream", dev.type))
    before = occ.launches
    u = torch.empty(N_RAYS, S, device="meta") if drawn else None
    out = occ._launch(grid, ro, rd, NEAR, FAR, S, P, u, 1e-3, 4, 2)
    assert occ.launches == before + 1 and len(calls) == 1
    assert out.device.type == "meta" and out.shape == (N_RAYS, S) and out.dtype == torch.float32
    a = calls[0]
    assert a[0] is grid.occupancy and a[1] == G and a[2] is grid.aabb_lo and a[3] is grid.aabb_hi
    assert a[5] is rd and a[4].shape == (N_RAYS, 3) and a[4].is_contiguous()
    assert (a[4] is ro) == (origins == "rows")
    assert a[6:11] == (N_RAYS, 4, P, S, 2)                  # N, stride, P, S, mode
    assert a[11:15] == (NEAR, FAR - NEAR, (FAR - NEAR) / P, 1e-3)
    assert (a[15] is u) and a[16] is out and a[17] == ("stream", "meta")
    assert len(a) == len(occ._ARGTYPES)


def test_limits_match_the_kernel_source():
    src = (_ext.CSRC / "occupancy.cu").read_text()
    assert int(re.search(r"MAX_PROBES = (\d+);", src).group(1)) == occ.MAX_PROBES
    assert int(re.search(r"MAX_SORTED = (\d+);", src).group(1)) == occ.MAX_SORTED
    enum = re.search(r"enum WeightMode \{([^}]*)\}", src).group(1)
    assert {k.strip().lower(): int(v) for k, v in re.findall(r"(\w+) = (\d+)", enum)} \
        == occ.WEIGHT_MODES
    assert occ.LIBRARY in _ext.SOURCES
    assert re.search(rf"__global__ void __launch_bounds__\(THREADS\) {occ.KERNEL}\(", src)


@pytest.mark.parametrize("case", ["probes_above", "probes_zero", "sorted_above", "dtype",
                                  "corners", "draws", "mode"])
def test_limits_raise(monkeypatch, case):
    # nothing falls back to the plain version: the call raises, naming the limit
    monkeypatch.setattr(occ, "load", lambda: pytest.fail("the launch was reached"))
    grid, ro, rd = _meta()
    kw = dict(n_probe=P, weight_mode="alpha")
    match = {"probes_above": "MAX_PROBES", "probes_zero": "MAX_PROBES",
             "sorted_above": "MAX_SORTED", "dtype": "rays_o", "corners": "aabb_lo",
             "draws": "u must", "mode": "weight_mode"}[case]
    n_samples = S
    if case == "probes_above":
        kw["n_probe"] = occ.MAX_PROBES + 1
    elif case == "probes_zero":
        kw["n_probe"] = 0
    elif case == "sorted_above":
        n_samples, kw["generator"] = occ.MAX_SORTED + 1, torch.Generator()
    elif case == "dtype":
        ro = ro.double()
    elif case == "corners":
        grid = grid._replace(aabb_lo=torch.empty(1, 3, device="meta"))
    elif case == "draws":                       # the launcher's own check of its draws
        with pytest.raises(ValueError, match=match):
            occ._launch(grid, ro, rd, NEAR, FAR, S, P, torch.empty(N_RAYS, S + 1, device="meta"),
                        1e-3, 1, 1)
        return
    else:
        kw["weight_mode"] = "bogus"
    with pytest.raises(ValueError, match=match):
        occ.grid_guided_z_vals(grid, ro, rd, NEAR, FAR, n_samples, **kw)


class _Reached(Exception):
    pass


def test_deterministic_depths_have_no_sort_limit(monkeypatch):
    # the midpoints' depths come out sorted: only the random draws are sorted
    # in the kernel, so only they are bound by MAX_SORTED
    def load():
        raise _Reached

    monkeypatch.setattr(occ, "load", load)
    grid, ro, rd = _meta()
    with pytest.raises(_Reached):
        occ.grid_guided_z_vals(grid, ro, rd, NEAR, FAR, occ.MAX_SORTED + 1, n_probe=P)
