"""The port's scaling report (``nerf_tpu_torch/bench/scaling.py``) on the CPU,
against ``tests/test_scaling.py`` and the JAX package's sharded render: the
rows over ``devices=["cpu"] * k`` (one device named k times plays the JAX
package's virtual devices), the frame stitched from shards against the
one-shard frame and JAX's, the frame stitched on rank 0 of two processes
(gloo), the PNG, and the ``scale`` subcommand."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nerf_tpu.bench.scaling import _make_sharded_render as j_make_sharded_render
from nerf_tpu.bench.scaling import assemble_frame as jassemble_frame
from nerf_tpu.config import Config as JConfig
from nerf_tpu.models.nerf import apply_nerf as japply_nerf, init_nerf_params as jinit
from nerf_tpu.parallel.mesh import make_mesh as jmake_mesh
from nerf_tpu.utils.cameras import generate_rays as jgenerate_rays
from nerf_tpu_torch.bench.scaling import (
    ScalingRow,
    _make_sharded_render,
    assemble_frame,
    scaling_report,
)
from nerf_tpu_torch.config import Config, ModelConfig, RenderConfig, TrainConfig
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.parallel.train import initialize_distributed
from nerf_tpu_torch.utils.cameras import generate_rays

ROOT = Path(__file__).resolve().parents[1]
W, H, SPP, FOCAL = 32, 24, 8, 50.0
TIMEOUT = 240


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config() -> Config:
    """tests/test_scaling.py's config."""
    return Config(
        model=ModelConfig(pos_freqs=4, dir_freqs=2, hidden_dim=32,
                          n_layers=4, skip_layer=2, color_hidden_dim=16),
        render=RenderConfig(),
        train=TrainConfig(compute_dtype="float32"),
    )


def jax_params():
    jcfg = JConfig.from_dict(tiny_config().to_dict())
    return jax.device_get(jinit(jax.random.PRNGKey(0), jcfg.model))


def camera_rays():
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    ro, rd = generate_rays(pose, W, H, FOCAL, "cpu")
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def port_frame(params, nd):
    ro, rd = camera_rays()
    render = _make_sharded_render(params, tiny_config(), ["cpu"] * nd, SPP)
    return assemble_frame(*render(ro, rd), W * H, (W, H))


def test_scaling_report_rows_over_repeated_devices(tmp_path):
    params = params_from_numpy(jax_params(), "cpu")
    logs = []
    rows = scaling_report(params, tiny_config(), resolution=(64, 48), spp=8, focal=FOCAL,
                          device_counts=[1, 2, 8], n_frames=1, log=logs.append,
                          devices=["cpu"] * 8, device="cpu")
    assert [r.n_devices for r in rows] == [1, 2, 8]
    assert all(r.rays_per_second > 0 for r in rows)
    assert rows[0].efficiency == 1.0 and rows[0].distinct_devices
    assert not rows[1].distinct_devices and not rows[2].distinct_devices
    assert len(logs) == 3
    assert "not a scaling number" not in logs[0]
    assert all("devices not distinct: not a scaling number" in ln for ln in logs[1:])
    # default: one device a rank, here one process
    assert [r.n_devices for r in scaling_report(params, tiny_config(), resolution=(16, 12),
                                                spp=4, n_frames=1, log=lambda m: None,
                                                device="cpu")] == [1]
    with pytest.raises(ValueError, match="need 2 devices"):
        scaling_report(params, tiny_config(), resolution=(16, 12), spp=4, device_counts=[2],
                       log=lambda m: None, device="cpu")


def test_frame_from_shards_matches_one_shard_and_jax():
    jp = jax_params()
    params = params_from_numpy(jp, "cpu")
    frames = {nd: port_frame(params, nd) for nd in (1, 8)}
    np.testing.assert_allclose(frames[8][0], frames[1][0], atol=1e-5)
    np.testing.assert_allclose(frames[8][1], frames[1][1], atol=1e-5)
    # the JAX package's sharded render and stitch, on its 8 virtual devices
    jcfg = JConfig.from_dict(tiny_config().to_dict())
    pose = jnp.eye(4, dtype=jnp.float32).at[2, 3].set(4.0)
    ro, rd = jgenerate_rays(pose, W, H, FOCAL)
    mesh = jmake_mesh(n_data=8, n_model=1, devices=jax.devices()[:8])
    render = j_make_sharded_render(jp, jcfg, mesh, SPP, japply_nerf)
    jrgb, jdepth = jassemble_frame(*render(jp, ro.reshape(-1, 3), rd.reshape(-1, 3)), W * H,
                                   (W, H))
    np.testing.assert_allclose(frames[8][0], jrgb, atol=1e-5)
    np.testing.assert_allclose(frames[8][1], jdepth, atol=1e-5)


def test_frame_png_is_written_without_pillow(tmp_path):
    params = params_from_numpy(jax_params(), "cpu")
    path = tmp_path / "frame.png"
    scaling_report(params, tiny_config(), resolution=(W, H), spp=SPP, focal=FOCAL,
                   device_counts=[8], n_frames=1, log=lambda m: None, devices=["cpu"] * 8,
                   frame_path=str(path), device="cpu")
    from PIL import Image        # the test reads it; the module writes it with zlib

    rgb, _ = port_frame(params, 8)
    assert np.array_equal(np.asarray(Image.open(path)),
                          (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_rank_frame(rank, world, port, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        params = params_from_numpy(jax_params(), "cpu")
        frame = port_frame(params, 4)            # shards 0, 2 on rank 0; 1, 3 on rank 1
        rows = scaling_report(params, tiny_config(), resolution=(W, H), spp=SPP, focal=FOCAL,
                              n_frames=1, log=lambda m: None, device="cpu")
    finally:
        dist.destroy_process_group()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"),
            {"frame": frame, "rows": [r.__dict__ for r in rows]}, allow_pickle=True)


def test_two_process_frame_is_stitched_on_rank_zero(tmp_path):
    ctx = mp.start_processes(_two_rank_frame, args=(2, _free_port(), str(tmp_path)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two ranks did not finish in {TIMEOUT} s")
    r0, r1 = (np.load(tmp_path / f"rank{r}.npy", allow_pickle=True).item() for r in range(2))
    assert r1["frame"] is None
    one = port_frame(params_from_numpy(jax_params(), "cpu"), 1)
    np.testing.assert_allclose(r0["frame"][0], one[0], atol=1e-5)
    np.testing.assert_allclose(r0["frame"][1], one[1], atol=1e-5)
    # one device a rank by default: rows for 1 and 2, the same on both ranks
    assert [r["n_devices"] for r in r0["rows"]] == [1, 2] and r0["rows"] == r1["rows"]
    # the two ranks' devices are one CPU: not a scaling number
    assert [r["distinct_devices"] for r in r0["rows"]] == [True, False]


def test_cli_scale_writes_report_and_png(tmp_path):
    from nerf_tpu_torch.cli import main as cli

    ckpt = str(ROOT / "results" / "convergence" / "final_params.npz")
    out = tmp_path / "out"
    assert cli.main(["scale", "--device", "cpu", "--checkpoint", ckpt, "--resolution", "16x12",
                     "--samples", "8", "--output_dir", str(out)]) == 0
    rows = json.loads((out / "scaling_report.json").read_text())
    assert [r["n_devices"] for r in rows] == [1] and rows[0]["rays_per_second"] > 0
    assert set(rows[0]) == set(ScalingRow.__dataclass_fields__)
    from PIL import Image

    assert np.asarray(Image.open(out / "scaling_frame.png")).shape == (12, 16, 3)
    help_text = subprocess.run([sys.executable, "-m", "nerf_tpu_torch.cli", "scale", "--help"],
                               cwd=ROOT, capture_output=True, text=True, timeout=120).stdout
    for flag in ("--coordinator_address", "--num_processes", "--process_id", "--device"):
        assert flag in help_text
