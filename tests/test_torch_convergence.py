"""The port's convergence tool (``nerf_tpu_torch/tools/convergence_run.py``)
against the JAX script it counts for (``scripts/convergence_run.py``) and
that script's committed run (``results/convergence/``), on the CPU: a run
shrunk to 16 x 16, 4 views, a few steps and a narrow network (the full
width validates at ~26 s a view here); its files and their keys, the
validation steps, the params archive through the port's loader, the exit
code against the 28 dB bar, and no run without a card when one is asked
for."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_tpu_torch import runtime
from nerf_tpu_torch.config import ModelConfig, RenderConfig, default_config
from nerf_tpu_torch.render.engines import SharedModel
from nerf_tpu_torch.tools import convergence_run
from nerf_tpu_torch.train.checkpoint import restore_bare_params

ROOT = Path(__file__).resolve().parents[1]
JAX_RUN = ROOT / "results" / "convergence"
IMG, VIEWS, STEPS, VAL_EVERY = 16, 4, 12, 8


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("convergence")
    cfg = convergence_run.recipe(IMG, seed=3)
    cfg = dataclasses.replace(
        cfg, model=ModelConfig(hidden_dim=32, color_hidden_dim=16),
        render=dataclasses.replace(cfg.render, n_coarse=8, n_fine=8),
        train=dataclasses.replace(cfg.train, n_rays=64))
    lines = []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = convergence_run.run(STEPS, str(out), views=VIEWS, val_every=VAL_EVERY,
                                     device="cpu", cfg=cfg, log=lines.append)
    finally:
        torch.set_num_threads(n)
    return out, result, lines, cfg


def test_the_recipe_is_the_jax_scripts():
    cfg = convergence_run.recipe()
    assert cfg.render == RenderConfig(white_background=True)
    assert cfg.model == default_config().model and cfg.img_wh == (400, 400)
    assert cfg.train == dataclasses.replace(default_config().train, n_rays=2048, seed=3)
    assert convergence_run.DEFAULT_SEED == 3 and convergence_run.QUALITY_BAR_DB == 28.0


def test_validation_steps_follow_the_jax_scripts_rule():
    jax_steps = [t["step"] for t in json.loads((JAX_RUN / "trajectory.json").read_text())
                 ["trajectory"]]
    assert convergence_run.validation_steps(24000, 40, 500) == jax_steps
    assert jax_steps[:3] == [520, 1000, 1520] and len(jax_steps) == 48
    assert convergence_run.validation_steps(2000, 40, 500) == [520, 1000, 1520, 2000]
    assert convergence_run.validation_steps(STEPS, VIEWS, VAL_EVERY) == [8, 12]


def test_trajectory_has_the_jax_scripts_keys(tiny_run):
    out, result, lines, cfg = tiny_run
    jax = json.loads((JAX_RUN / "trajectory.json").read_text())
    ours = json.loads((out / "trajectory.json").read_text())
    assert ours == json.loads(json.dumps(result))
    assert set(jax) <= set(ours) and set(ours) - set(jax) == {"timing", "train_losses"}
    assert set(ours["config"]) == set(jax["config"]) | {"seed"}
    assert ours["config"] == {"img_wh": [IMG, IMG], "views": VIEWS, "n_rays": 64,
                              "samples": [8, 8], "importance": True, "steps": STEPS,
                              "device": "cpu", "seed": 3}
    assert [set(t) for t in ours["trajectory"]] == [set(jax["trajectory"][0])] * 2
    assert [t["step"] for t in ours["trajectory"]] == [8, 12]
    assert len(ours["train_losses"]) == STEPS // VIEWS
    assert [t["train_loss"] for t in ours["trajectory"]] == ours["train_losses"][1:]
    for t in ours["trajectory"]:
        assert np.isfinite(t["train_loss"]) and t["val_psnr_db"] == pytest.approx(
            10 * np.log10(1 / t["val_mse"]))
    timing = ours["timing"]
    assert timing["validations"] == 2 and timing["val_views"] == 5
    assert 0 < timing["train_s"] + timing["validate_s"] <= ours["wall_time_s"]
    assert 0 < timing["first_epoch_s"] < timing["train_s"]
    assert timing["ms_per_step"] == pytest.approx(
        (timing["train_s"] - timing["first_epoch_s"]) * 1e3 / (STEPS - VIEWS))
    assert timing["val_ms_per_view"] == pytest.approx(timing["validate_s"] * 1e3 / 10)
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == ["8", "12"]
    assert lines[0] == "device: cpu"


def test_the_images_are_written(tiny_run):
    out = tiny_run[0]
    rgb, gt, depth = runtime.decode_png_batch(
        [out / "final_rgb.png", out / "ground_truth.png", out / "final_depth.png"], (IMG, IMG))
    assert np.isfinite(rgb).all() and gt.std() > 0
    assert depth.min() == 0 and depth.max() == 1                # normalized to [0, 255]


def test_final_params_round_trip_with_the_jax_runs_keys(tiny_run):
    out, _, _, cfg = tiny_run
    ours = restore_bare_params(str(out / "final_params.npz"))
    with np.load(out / "final_params.npz") as a, np.load(JAX_RUN / "final_params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == np.float32 for k in a.files)
    model = SharedModel(cfg, "cpu").load(str(out / "final_params.npz"))
    for net in ("coarse", "fine"):
        assert model.params[net]["trunk"][7]["w"].shape == (32, 32)
        np.testing.assert_array_equal(model.params[net]["trunk"][0]["w"].numpy(),
                                      ours[net]["trunk"][0]["w"])


def test_exit_code_is_the_28_db_bar(monkeypatch, capsys):
    for psnr, code in ((27.99, 1), (28.0, 0)):
        monkeypatch.setattr(convergence_run, "run", lambda *a, **k: {
            "trajectory": [{"step": 40, "val_psnr_db": psnr}]})
        assert convergence_run.main(["--steps", "40", "--device", "cpu"]) == code
        assert capsys.readouterr().out.startswith(f"FINAL val PSNR {psnr:.2f} dB")


def test_the_card_is_the_default_and_nothing_runs_without_it(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        convergence_run.main(["--steps", "40", "--out", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        convergence_run.main(["--device", "cuda", "--out", str(tmp_path / "out")])
    assert capsys.readouterr() == ("", "") and not (tmp_path / "out").exists()
