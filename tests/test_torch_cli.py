"""The port's command line (``nerf_tpu_torch/cli``) on the CPU, against the
JAX package's (``nerf_tpu/cli/main.py``): the parsers' surface, a tiny
``pipeline``, ``train`` on a Blender directory and from the ray producer,
``render`` (the two packages' PNGs), ``export`` (the two packages' ``.pth``
payloads), ``compare``'s grid, ``smoke``, the module entry, and no CPU
fallback. Every run passes ``--device cpu``, where the kernels' plain
versions run."""

import argparse
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_tpu.cli import main as jcli
from nerf_tpu_torch.bench.suite import UnifiedBenchmarkSuite
from nerf_tpu_torch.cli import main as cli
from nerf_tpu_torch.config import default_config
from nerf_tpu_torch.render.engines import ENGINE_CLASSES, SharedModel
from nerf_tpu_torch.train.trainer import NeRFTrainer
from nerf_tpu_torch.utils.cameras import focal_from_angle, spherical_pose
from test_torch_blender import write_blender_dir

ROOT = Path(__file__).resolve().parents[1]
MULTI_HOST = {"coordinator_address", "num_processes", "process_id"}   # the multi-GPU slice's
ENGINE_NAMES = {"xla": "torch", "pallas": "cuda"}


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(subparser):
    return {a.dest: a for a in subparser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test workers' thread pools fighting for the cores slow the
    full-width CPU renders many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("command", sorted(_subparsers(jcli.build_parser())))
def test_parser_has_the_jax_surface(command):
    port = _subparsers(cli.build_parser())
    if command == "scale":            # waits for the multi-GPU slice, with the multi-host flags
        assert command not in port
        return
    jopts, opts = _options(_subparsers(jcli.build_parser())[command]), _options(port[command])
    assert set(jopts) - MULTI_HOST == set(opts) - {"device"}
    assert opts["device"].default == "cuda"
    for dest, j in jopts.items():
        if dest in MULTI_HOST:
            continue
        o = opts[dest]
        assert o.option_strings == j.option_strings and o.nargs == j.nargs, dest
        assert o.required == j.required and o.type == j.type, dest
        if dest == "engine":          # the registry's names for xla and pallas
            assert o.default == ENGINE_NAMES[j.default]
            assert o.choices == [ENGINE_NAMES.get(c, c) for c in j.choices] == list(ENGINE_CLASSES)
            continue
        assert o.default == j.default and o.choices == j.choices, dest
        if dest != "trace":           # "a torch.profiler trace" for "a jax.profiler trace"
            assert o.help == j.help, dest
    assert port[command].description == _subparsers(jcli.build_parser())[command].description


def test_pipeline_namespace_covers_train_and_benchmark_reads():
    args = cli.build_parser().parse_args(["pipeline"])
    for attr in ("data_dir", "epochs", "image_size", "no_resume", "streaming_steps", "n_rays",
                 "checkpoint_dir", "output_dir",                           # cmd_train reads
                 "checkpoint", "resolutions", "samples", "views", "engines",
                 "gt_gate", "gt_spp",                                      # cmd_benchmark reads
                 "device"):
        assert hasattr(args, attr), f"pipeline namespace missing {attr}"
    assert args.device == "cuda"


@pytest.fixture
def small_quality_report(monkeypatch):
    """``benchmark`` runs the quality report over 4 views at 200x150 and
    400x300 at 64 samples where ``torch`` and another engine run: minutes at
    full width on the CPU. The same call at the sweep's tiny size."""
    report = functools.partialmethod(UnifiedBenchmarkSuite.quality_report,
                                     resolutions=[(32, 24)], spp=8, n_views=1)
    monkeypatch.setattr(UnifiedBenchmarkSuite, "quality_report", report)


def test_pipeline_tiny_restores_in_the_jax_package(tmp_path, small_quality_report):
    import json

    import jax

    from nerf_tpu.config import Config as JConfig
    from nerf_tpu.train.checkpoint import restore_checkpoint as jrestore
    from nerf_tpu.train.trainer import init_train_state

    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    rc = cli.main(["pipeline", "--device", "cpu", "--data_dir", str(tmp_path / "missing"),
                   "--image_size", "16", "--n_rays", "64", "--epochs", "1", "--no_resume",
                   "--output_dir", str(out), "--checkpoint_dir", str(ckpt),
                   "--resolutions", "32x24", "--samples", "8", "--views", "1",
                   "--engines", "torch", "cuda"])
    assert rc == 0
    path = ckpt / "final_model.npz"
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    jcfg = JConfig.from_dict(meta["config"])
    assert jcfg.data_dir == str(tmp_path / "missing")
    state, jmeta = jrestore(str(path), init_train_state(jax.random.PRNGKey(0), jcfg))
    assert int(state.step) == 20 and len(jmeta["train_losses"]) == 1
    report = json.loads((out / "benchmark_results.json").read_text())
    assert [r["renderer_name"] for r in report["results"]] == ["torch", "cuda"]
    assert all(r["success"] for r in report["results"]) and "cuda" in report["quality"]


def test_train_reads_a_blender_directory(tmp_path, capsys):
    data = write_blender_dir(tmp_path / "scene", n_train=2, n_val=1, wh=(16, 16))
    rc = cli.main(["train", "--device", "cpu", "--data_dir", str(data), "--image_size", "16",
                   "--n_rays", "64", "--epochs", "1", "--no_resume",
                   "--checkpoint_dir", str(tmp_path / "ckpt"),
                   "--output_dir", str(tmp_path / "out")])
    assert rc == 0 and "procedural" not in capsys.readouterr().out
    trainer = NeRFTrainer(default_config(), (16, 16), device="cpu")
    trainer.load_checkpoint(str(tmp_path / "ckpt" / "final_model.npz"))
    assert trainer.state.step == 2 and len(trainer.train_losses) == 1


def test_train_streaming_steps(tmp_path, capsys):
    rc = cli.main(["train", "--device", "cpu", "--data_dir", str(tmp_path / "missing"),
                   "--image_size", "16", "--n_rays", "64", "--streaming_steps", "4",
                   "--no_resume", "--checkpoint_dir", str(tmp_path / "ckpt"),
                   "--output_dir", str(tmp_path / "out")])
    assert rc == 0
    assert "final checkpoint" in capsys.readouterr().out
    trainer = NeRFTrainer(default_config(), (16, 16), device="cpu")
    trainer.load_checkpoint(str(tmp_path / "ckpt" / "final_model.npz"))
    assert trainer.state.step == 4


@pytest.fixture(scope="module")
def seeded_checkpoint(tmp_path_factory):
    """A full-width trainer checkpoint of seeded weights: seed 3 starts both
    networks with a live density, so the frames are not empty."""
    d = tmp_path_factory.mktemp("seeded")
    cfg = default_config()
    cfg = dataclasses.replace(cfg, checkpoint_dir=str(d),
                              train=dataclasses.replace(cfg.train, seed=3))
    trainer = NeRFTrainer(cfg, (8, 8), device="cpu")
    trainer.train_losses, trainer.val_losses = [0.5, 0.25], [0.125]
    return trainer.save_checkpoint("seeded.npz")


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path), np.float64) / 255.0


def _psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.fixture(scope="module")
def jax_renders(seeded_checkpoint, tmp_path_factory):
    """The JAX command line's ``render --engine xla`` of the seeded
    checkpoint, per mode (its command function, without the compile cache
    its ``main`` turns on)."""
    out = {}
    for mode in ("benchmark", "hierarchical"):
        d = tmp_path_factory.mktemp(f"jax_render_{mode}")
        args = jcli.build_parser().parse_args(
            ["render", "--weights", seeded_checkpoint, "--engine", "xla", "--width", "32",
             "--height", "24", "--samples", "16", "--mode", mode, "--out", str(d)])
        assert args.fn(args) == 0
        out[mode] = d
    return out


@pytest.mark.parametrize("mode", ["benchmark", "hierarchical"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_render_matches_the_jax_command_line(engine, mode, seeded_checkpoint, jax_renders,
                                             tmp_path, capsys):
    rc = cli.main(["render", "--device", "cpu", "--weights", seeded_checkpoint, "--engine",
                   engine, "--width", "32", "--height", "24", "--samples", "16",
                   "--mode", mode, "--out", str(tmp_path)])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith(f"rendered 32x24@16 with {engine} in ")
    assert lines[-1] == f"wrote {tmp_path / 'rgb.png'}, {tmp_path / 'depth.png'}"
    got, ref = _read_png(tmp_path / "rgb.png"), _read_png(jax_renders[mode] / "rgb.png")
    assert got.shape == ref.shape == (24, 32, 3) and ref.std() > 0.02
    assert _psnr(got, ref) >= 40.0
    depth = _read_png(tmp_path / "depth.png")
    assert depth.shape == (24, 32) and depth.min() == 0.0 and depth.max() == 1.0


def test_render_writes_the_frame_and_a_trace(seeded_checkpoint, tmp_path):
    # rgb.png and depth.png are the in-process frame's uint8 images
    rc = cli.main(["render", "--device", "cpu", "--weights", seeded_checkpoint, "--width",
                   "32", "--height", "24", "--samples", "16", "--out", str(tmp_path),
                   "--trace", str(tmp_path / "trace")])
    assert rc == 0 and list((tmp_path / "trace").glob("trace_*.json"))
    shared = SharedModel(default_config(), "cpu").load(seeded_checkpoint)
    res = ENGINE_CLASSES["cuda"](shared).render_image(
        spherical_pose(30.0, -30.0, 4.0), (32, 24), 16, focal=focal_from_angle(32, 0.6911112070083618))
    np.testing.assert_array_equal(_read_png(tmp_path / "rgb.png") * 255,
                                  (np.clip(res.rgb, 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(_read_png(tmp_path / "depth.png") * 255,
                                  cli._depth_to_uint8(res.depth))


def test_export_equals_the_jax_payload(seeded_checkpoint, tmp_path):
    rc = cli.main(["export", "--device", "cpu", "--checkpoint", seeded_checkpoint,
                   "--out", str(tmp_path / "port.pth")])
    assert rc == 0
    args = jcli.build_parser().parse_args(["export", "--checkpoint", seeded_checkpoint,
                                           "--out", str(tmp_path / "jax.pth")])
    assert args.fn(args) == 0
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    ref = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert list(got) == list(ref)
    for net in ("coarse_model", "fine_model"):
        assert list(got[net]) == list(ref[net]) and len(got[net]) == 22
        for k, v in ref[net].items():
            assert got[net][k].dtype == v.dtype and got[net][k].is_contiguous() == v.is_contiguous()
            assert torch.equal(got[net][k], v), (net, k)
    assert got["config"] == ref["config"] and got["config"]["train"]["seed"] == 3
    assert got["train_losses"] == ref["train_losses"] == [0.5, 0.25]
    assert got["val_losses"] == ref["val_losses"] == [0.125]
    # and the port's engines read it back as the checkpoint's params
    a = SharedModel(default_config(), "cpu").load(str(tmp_path / "port.pth")).params
    b = SharedModel(default_config(), "cpu").load(seeded_checkpoint).params
    for net in ("coarse", "fine"):
        for key in ("trunk", "density", "color0", "color1"):
            la, lb = a[net][key], b[net][key]
            for x, y in zip(la if key == "trunk" else [la], lb if key == "trunk" else [lb]):
                assert torch.equal(x["w"], y["w"]) and torch.equal(x["b"], y["b"]), (net, key)


def test_compare_grid_holds_each_engines_frame(seeded_checkpoint, tmp_path, monkeypatch, capsys):
    # the accel engine's grid at 16^3 rather than 128^3: a full-width bake on
    # the CPU takes minutes
    def small_grid(weights, _config_for=cli._config_for):
        cfg = _config_for(weights)
        return dataclasses.replace(cfg, accel=dataclasses.replace(
            cfg.accel, grid_resolution=16, probe_resolution=8))

    monkeypatch.setattr(cli, "_config_for", small_grid)
    size, spp = 16, 8
    rc = cli.main(["compare", "--device", "cpu", "--checkpoint", seeded_checkpoint,
                   "--size", str(size), "--samples", str(spp), "--output_dir", str(tmp_path)])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    for name in ENGINE_CLASSES:
        assert any(ln.startswith(f"{name}: ") and "s mean=" in ln for ln in lines), name
    grid = np.round(_read_png(tmp_path / "renderer_comparison.png") * 255).astype(np.uint8)
    assert grid.shape == (2 * size, size * len(ENGINE_CLASSES), 3)
    shared = SharedModel(small_grid(seeded_checkpoint), "cpu").load(seeded_checkpoint)
    for col, (name, cls) in enumerate(ENGINE_CLASSES.items()):
        res = cls(shared).render_image(spherical_pose(40.0, -30.0, 4.0), (size, size), spp,
                                       focal=focal_from_angle(size, 0.6911112070083618))
        tile = grid[:, col * size:(col + 1) * size]
        np.testing.assert_array_equal(tile[:size], (np.clip(res.rgb, 0, 1) * 255).astype(np.uint8),
                                      err_msg=name)
        np.testing.assert_array_equal(tile[size:], np.repeat(
            cli._depth_to_uint8(res.depth)[..., None], 3, axis=-1), err_msg=name)


def test_smoke_on_the_cpu(capsys):
    assert cli.main(["smoke", "--device", "cpu"]) == 0
    assert "smoke test passed" in capsys.readouterr().out


def test_module_entry_runs_in_a_child_process():
    res = subprocess.run([sys.executable, "-m", "nerf_tpu_torch.cli", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for command in ("train", "benchmark", "render", "compare", "export", "smoke", "pipeline"):
        assert command in res.stdout


def test_no_cpu_fallback_without_a_card(seeded_checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["render", "--weights", seeded_checkpoint, "--out", str(tmp_path)])
    assert not (tmp_path / "rgb.png").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["export", "--checkpoint", seeded_checkpoint, "--out", str(tmp_path / "m.pth")])
