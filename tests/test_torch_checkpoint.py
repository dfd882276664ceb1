"""Trainer checkpoints cross between the two packages: a file saved by the
JAX trainer restores in the port and the reverse (params, Adam moments,
counts, meta), and a step taken from the restored state agrees. Plus resume
over a torn file, the directory helpers and the config round trip."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_tpu.config import Config as JConfig
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train.trainer import (
    init_train_state as jinit_train_state,
    make_ray_train_step as jmake_ray_train_step,
)
from nerf_tpu_torch.config import (AccelConfig, Config, ModelConfig, RenderConfig, TrainConfig,
                                   default_config)
from nerf_tpu_torch.data.synthetic import make_procedural_dataset
from nerf_tpu_torch.render.engines import SharedModel
from nerf_tpu_torch.train import checkpoint as ckpt
from nerf_tpu_torch.train.trainer import NeRFTrainer, make_ray_train_step
from nerf_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one thread per test worker is the fast way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(tmp_path) -> Config:
    """Tiny model, deterministic render (uniform fine pass, no jitter), so a
    step needs no random draw in either package."""
    return Config(
        model=ModelConfig(pos_freqs=4, dir_freqs=2, hidden_dim=32,
                          n_layers=4, skip_layer=2, color_hidden_dim=16),
        render=RenderConfig(n_coarse=12, n_fine=16, use_importance=False, perturb=False),
        train=TrainConfig(n_rays=64, compute_dtype="float32", learning_rate=5e-3),
        checkpoint_dir=str(tmp_path / "ckpt"), output_dir=str(tmp_path / "out"),
        img_wh=(48, 48),
    )


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    return ro, rd, rng.uniform(size=(n, 3)).astype(np.float32)


def _jax_leaves(tree):
    return {p: np.asarray(v) for p, v in tree_leaves(jax.device_get(tree))}


def _assert_leaves_close(ours, theirs, atol):
    """Port tensors vs JAX arrays, both as {path: leaf}."""
    assert set(ours) == set(theirs)
    for k, leaf in ours.items():
        np.testing.assert_allclose(leaf.detach().numpy(), theirs[k], atol=atol, rtol=0,
                                   err_msg=str(k))


def test_jax_checkpoint_restores_in_the_port_and_steps_alike(tmp_path):
    cfg = tiny_config(tmp_path)
    jcfg = JConfig.from_dict(cfg.to_dict())
    rays = _rays(64, 0)
    jrays = [jnp.asarray(a) for a in rays]
    jstep = jmake_ray_train_step(jcfg, donate=False)
    jstate = jinit_train_state(jax.random.PRNGKey(0), jcfg)
    for _ in range(3):
        jstate, _ = jstep(jstate, *jrays, jax.random.PRNGKey(1))
    path = str(tmp_path / "ckpt" / "checkpoint_epoch_3.npz")
    jckpt.save_checkpoint(path, jstate, {"config": jcfg.to_dict(), "train_losses": [0.5, 0.4, 0.3],
                                         "val_losses": [0.2], "step": 3})

    trainer = NeRFTrainer(cfg, (48, 48), device="cpu")
    assert trainer.try_resume() == path
    assert trainer.state.step == 3 and trainer.state.optimizer.count == 3
    assert trainer.train_losses == [0.5, 0.4, 0.3] and trainer.val_losses == [0.2]
    _assert_leaves_close(dict(tree_leaves(trainer.state.params)),
                         _jax_leaves(jstate.params), 0)
    paths = [p for p, _ in tree_leaves(trainer.state.params)]
    adam = jstate.opt_state[2]
    _assert_leaves_close(dict(zip(paths, trainer.state.optimizer.mu)), _jax_leaves(adam.mu), 0)
    _assert_leaves_close(dict(zip(paths, trainer.state.optimizer.nu)), _jax_leaves(adam.nu), 0)
    assert all(leaf.requires_grad for _, leaf in tree_leaves(trainer.state.params))

    # one identical step in both: the restored moments and counts are in use
    jstate, jmetrics = jstep(jstate, *jrays, jax.random.PRNGKey(2))
    metrics = make_ray_train_step(cfg)(trainer.state, *(torch.tensor(a) for a in rays))
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    _assert_leaves_close(dict(tree_leaves(trainer.state.params)),
                         _jax_leaves(jstate.params), 1e-5)
    assert trainer.state.step == int(jstate.step) == 4


def test_port_checkpoint_restores_in_jax_and_steps_alike(tmp_path):
    cfg = tiny_config(tmp_path)
    jcfg = JConfig.from_dict(cfg.to_dict())
    rays = _rays(64, 1)
    trays = [torch.tensor(a) for a in rays]
    trainer = NeRFTrainer(cfg, (48, 48), device="cpu")
    step = make_ray_train_step(cfg)
    for _ in range(3):
        step(trainer.state, *trays)
    trainer.train_losses = [0.9, 0.8]
    path = trainer.save_checkpoint("checkpoint_epoch_2")
    assert path.endswith("checkpoint_epoch_2.npz")

    # the file is the JAX trainer's own format: its restore reads it against
    # a template state, optimizer state and all
    template = jinit_train_state(jax.random.PRNGKey(5), jcfg)
    jstate, meta = jckpt.restore_checkpoint(path, template)
    assert meta["step"] == 3 and meta["train_losses"] == [0.9, 0.8]
    assert JConfig.from_dict(meta["config"]).train == jcfg.train
    assert int(jstate.step) == 3
    assert int(jstate.opt_state[2].count) == 3 and int(jstate.opt_state[3].count) == 3
    _assert_leaves_close(dict(tree_leaves(trainer.state.params)),
                         _jax_leaves(jstate.params), 0)
    paths = [p for p, _ in tree_leaves(trainer.state.params)]
    _assert_leaves_close(dict(zip(paths, trainer.state.optimizer.nu)),
                         _jax_leaves(jstate.opt_state[2].nu), 0)

    jstate, _ = jmake_ray_train_step(jcfg, donate=False)(
        jstate, *(jnp.asarray(a) for a in rays), jax.random.PRNGKey(2))
    step(trainer.state, *trays)
    _assert_leaves_close(dict(tree_leaves(trainer.state.params)),
                         _jax_leaves(jstate.params), 1e-5)

    # and the port reads its own file back bit for bit
    state, meta = ckpt.restore_checkpoint(path)
    assert state["count"] == 3 and state["step"] == 3 and set(state) == {
        "params", "mu", "nu", "count", "step"}
    assert Config.from_dict(meta["config"]) == cfg


def test_resume_skips_a_truncated_file_and_helpers(tmp_path, capsys):
    cfg = tiny_config(tmp_path)
    ds = make_procedural_dataset(n_views=2, img_wh=(48, 48))
    trainer = NeRFTrainer(cfg, (48, 48), device="cpu")
    assert trainer.try_resume() is None                    # no directory yet
    trainer.train_epoch(ds)
    good = trainer.save_checkpoint("checkpoint_epoch_1.npz")
    assert good == ckpt.checkpoint_path(cfg.checkpoint_dir, 1)
    torn = ckpt.checkpoint_path(cfg.checkpoint_dir, 7)
    with open(good, "rb") as f, open(torn, "wb") as g:
        g.write(f.read()[:2000])                           # a write cut short
    (tmp_path / "ckpt" / "notes.txt").write_text("not a checkpoint")
    assert ckpt.find_latest_checkpoint(cfg.checkpoint_dir) == torn
    assert ckpt.find_latest_checkpoint(cfg.checkpoint_dir, exclude={torn}) == good
    assert ckpt.find_latest_checkpoint(str(tmp_path / "missing")) is None

    fresh = NeRFTrainer(cfg, (48, 48), device="cpu")
    assert fresh.try_resume() == good
    assert "unreadable" in capsys.readouterr().out
    assert fresh.state.step == 2
    for (_, a), (_, b) in zip(tree_leaves(fresh.state.params), tree_leaves(trainer.state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a checkpoint of another architecture is refused, not half-loaded
    other = NeRFTrainer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, hidden_dim=16)), (48, 48), device="cpu")
    with pytest.raises(KeyError, match="does not match"):
        other.load_checkpoint(good)
    # no temporary file is left behind
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "checkpoint_epoch_1.npz", "checkpoint_epoch_7.npz", "notes.txt"]


def test_shared_model_reads_a_trainer_checkpoint(tmp_path):
    cfg = tiny_config(tmp_path)
    trainer = NeRFTrainer(cfg, (48, 48), device="cpu")
    path = trainer.save_checkpoint("checkpoint_epoch_1")
    assert ckpt.has_checkpoint_meta(path)
    shared = SharedModel(cfg, "cpu").load(path)
    for net in ("coarse", "fine"):
        for (_, a), (_, b) in zip(tree_leaves(shared.params[net]),
                                  tree_leaves(trainer.state.params[net])):
            torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
            assert not a.requires_grad
    with pytest.raises(KeyError, match="__meta__"):
        np.savez(tmp_path / "bare.npz", **{"['fine']['w']": np.zeros(2)})
        ckpt.restore_checkpoint(str(tmp_path / "bare.npz"))


def test_config_round_trips_and_reads_the_jax_dict():
    cfg = dataclasses.replace(default_config(), checkpoint_dir="c", img_wh=(64, 48),
                              train=TrainConfig(n_rays=512, seed=4))
    again = Config.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert again == cfg and again.img_wh == (64, 48)
    # the JAX package's dict has the port's sections: each carries over
    jcfg = JConfig.from_dict(cfg.to_dict())
    assert Config.from_dict(jcfg.to_dict()) == cfg
    assert {f.name for f in dataclasses.fields(TrainConfig)} == {
        f.name for f in dataclasses.fields(type(jcfg.train))}
    assert TrainConfig() == TrainConfig(**dataclasses.asdict(JConfig().train))
    # the accel section, its aabb a tuple again after JSON, with the JAX names
    # and defaults
    jacc = dataclasses.replace(jcfg, accel=dataclasses.replace(
        jcfg.accel, aabb=(-2.0, 2.5), n_probe=48, grid_store="binary",
        weight_mode="occupancy", probe_ray_stride=1, probe_resolution=0))
    got = Config.from_dict(json.loads(json.dumps(jacc.to_dict()))).accel
    assert dataclasses.asdict(got) == dataclasses.asdict(jacc.accel)
    assert got.aabb == (-2.0, 2.5) and isinstance(got.aabb, tuple)
    assert AccelConfig() == AccelConfig(**dataclasses.asdict(JConfig().accel))
