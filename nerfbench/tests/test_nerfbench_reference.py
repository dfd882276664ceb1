"""The plain reference against the port's plain paths at a tiny size on the
CPU, in float32: the network, the frames of each engine, the accel depths,
the compressed weights and the trainer's steps. The reference itself
imports nothing of the port."""

import ast

import numpy as np
import pytest
import torch

from nerfbench import harness, traffic
from nerfbench.reference import nerf as rn
from nerfbench.reference import quant as rq
from nerfbench.reference import render as rr
from nerfbench.tests import tiny

REF = harness.load_json(harness.HERE / "configs" / "nerf-dbr-reference.json")
# the original NeRF's variant of the same widths (bmild/nerf)
BMILD = {**REF, "model": {**REF["model"], "variant": "bmild", "posenc_pi": False,
                          "normalize_dirs": True},
         "render": {**REF["render"], "white_background": True}}
CONFIGS = {"nerf-dbr-reference": REF, "bmild": BMILD}


def random_nets(config, seed):
    """Both networks of torch.nn.Linear's rule, on the CPU."""
    from nerf_tpu_torch.models.nerf import init_nerf_params

    g = torch.Generator().manual_seed(seed)
    model = harness.program_config(config).model
    return {"coarse": init_nerf_params(g, model, "cpu"), "fine": init_nerf_params(g, model, "cpu")}


def small(config):
    return {**config, "render": {**config["render"], **tiny.RENDER},
            "compute_dtype": "float32"}


def test_reference_imports_nothing_of_the_port():
    for path in sorted((harness.HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("nerf_tpu_torch", "nerf_tpu", "jax"), (path, n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_network_matches_apply_nerf(name):
    from nerf_tpu_torch.models.nerf import apply_nerf

    config = CONFIGS[name]
    cfg = harness.program_config(config)
    nets = random_nets(config, 3)
    g = torch.Generator().manual_seed(1)
    pts = torch.rand(5, 7, 3, generator=g) * 3 - 1.5
    d = torch.randn(5, 3, generator=g)
    s, c = rn.mlp(nets["fine"], pts, d, config["model"])
    s2, c2 = apply_nerf(nets["fine"], pts, d[:, None].expand(pts.shape), cfg.model)
    torch.testing.assert_close(s, s2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, c2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine,mode,name", [
    ("torch", "benchmark", "nerf-dbr-reference"),
    ("torch", "hierarchical", "bmild"),
    ("cuda", "hierarchical", "nerf-dbr-reference"),
    ("accel", "benchmark", "nerf-dbr-reference"),
])
def test_frames_match_the_engines(engine, mode, name):
    from nerf_tpu_torch.render.engines import ENGINE_CLASSES, SharedModel

    config = small(CONFIGS[name])
    wl = {"engine": engine, "mode": mode, "samples_per_ray": 8, "resolution": [12, 8],
          "camera_angle_x": 0.69}
    if engine == "accel":
        config["accel"] = {**config["accel"], "grid_resolution": 16, "probe_resolution": 8}
    cfg = harness.program_config(config)
    nets = (harness.weights(config, torch.device("cpu"))
            if name == "nerf-dbr-reference" else random_nets(config, 5))
    shared = SharedModel(cfg, device="cpu")
    shared.params = nets
    eng = ENGINE_CLASSES[engine](shared, chunk_rays=32)
    if engine == "accel":
        # the engine bakes in bf16 whatever the compute dtype; hold the
        # depths, not the bake, here: the reference's grid in its place
        grid = rr.bake_grid(nets["fine"], config["model"], config["accel"], None)
        from nerf_tpu_torch.ops.occupancy import OccupancyGrid

        eng._grid = OccupancyGrid(grid[0], torch.full((3,), -1.5), torch.full((3,), 1.5),
                                  grid[1])
    pose = traffic.spherical_pose(40.0, -30.0, 4.0)
    focal = traffic.focal_from_angle(12, 0.69)
    res = eng.render_image(pose, (12, 8), 8, focal, mode, monitor=False)
    kind = "accel" if engine == "accel" else ("hierarchical" if mode == "hierarchical"
                                              else "uniform")
    rgb, depth = rr.frame(kind, nets, pose, 12, 8, focal, config["model"], config["render"], 8,
                          grid=grid if engine == "accel" else None, accel=config.get("accel"))
    # the port's plain K1 forms its depths by its own formula: at 8 + 8
    # samples a trained scene moves the drawn depths, and an edge pixel, by
    # that rounding
    np.testing.assert_allclose(res.rgb, rgb.numpy(), atol=5e-4)
    np.testing.assert_allclose(res.depth, depth.numpy(), rtol=1e-4, atol=1e-4)


def test_bake_matches_the_ports_grid():
    from nerf_tpu_torch.models.nerf import apply_nerf
    from nerf_tpu_torch.ops.occupancy import build_occupancy_grid, downsample_grid

    config = CONFIGS["nerf-dbr-reference"]
    accel = {**config["accel"], "grid_resolution": 16, "probe_resolution": 8}
    nets = random_nets(config, 2)
    mine, g = rr.bake_grid(nets["fine"], config["model"], accel, None)
    cfg = harness.program_config(config)
    theirs = build_occupancy_grid(nets["fine"], cfg.model, resolution=16, apply_fn=apply_nerf,
                                  compute_dtype=torch.float32, store="density")
    theirs = downsample_grid(theirs, 2)
    assert g == theirs.resolution
    torch.testing.assert_close(mine, theirs.occupancy, rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize("bits", [8, 16])
def test_compressed_weights_match_quantize_model(bits):
    from nerf_tpu_torch.ops.quant import dequantize, quantize_model
    from nerf_tpu_torch.ops.mlp_kernel import pack_params

    for name, config in CONFIGS.items():
        cfg = harness.program_config(config)
        nets = random_nets(config, 4)
        q, _ = quantize_model(nets, cfg.model, bits=bits, prune_fraction=0.1)
        mine = rq.compressed(nets, config["model"], bits, 0.1)
        for net in ("coarse", "fine"):
            want = dequantize(q[net], torch.float32)
            got = pack_params(mine[net], cfg.model, dtype=torch.float32)
            for field in want._fields:
                a, b = getattr(want, field), getattr(got, field)
                if a is not None:
                    torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=f"{name} {field}")


def test_train_steps_match_the_trainer():
    line, out = tiny.execute("ref-train", compute_dtype="float32")
    gaps = out.notes["gaps"]
    assert gaps["loss_gap"] < 1e-5 and gaps["moment_gap"] < 1e-3 and gaps["update_gap"] < 1e-3


@pytest.mark.parametrize("cell", ["ref-hier", "ref-int8-hier"])
def test_frames_of_a_cell_match_at_float32(cell):
    line, out = tiny.execute(cell, compute_dtype="float32")
    # at 8 + 8 samples an edge pixel moves with the order of the sums
    assert out.notes["gaps"]["rgb_max_abs"] < 5e-4


def test_seeded_weights_have_the_ports_layout_and_follow_the_seed():
    from nerf_tpu_torch.models.nerf import init_nerf_params

    config = harness.load_json(harness.HERE / "configs" / "nerf-original-lego.json")
    dev = torch.device("cpu")
    nets = harness.weights(config, dev, 2150000001)
    port = init_nerf_params(torch.Generator().manual_seed(0),
                            harness.program_config(config).model, "cpu")
    shapes = {p: tuple(t.shape) for p, t in rn.leaves(port)}
    for net in ("coarse", "fine"):
        assert {p: tuple(t.shape) for p, t in rn.leaves(nets[net])} == shapes
        for layer in [*nets[net]["trunk"], nets[net]["density"], nets[net]["bottleneck"]]:
            fan_in, fan_out = layer["w"].shape
            assert float(layer["w"].abs().max()) <= (6.0 / (fan_in + fan_out)) ** 0.5
            assert not layer["b"].any()
    again = harness.weights(config, dev, 2150000001)
    other = harness.weights(config, dev, 2150000002)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(rn.leaves(nets), rn.leaves(again)))
    assert not torch.equal(nets["fine"]["trunk"][0]["w"], other["fine"]["trunk"][0]["w"])
    assert not torch.equal(nets["coarse"]["trunk"][0]["w"], nets["fine"]["trunk"][0]["w"])
