"""Sharded training of the port (``nerf_tpu_torch/parallel``) on the CPU:
the counterparts of ``tests/test_sharding.py`` and ``tests/test_distributed.py``.

Where the JAX package runs its mesh on eight virtual XLA devices, the port
runs one OS process a rank over gloo on 127.0.0.1 (``torch.multiprocessing``
spawns a function of this file, each run under a timeout); the JAX side runs
in the test process. Inputs are made with numpy or seeded generators, and
every rank gets the same ones, as replicated inputs."""

import dataclasses
import json
import os
import re
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

from nerf_tpu.config import Config as JConfig
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.parallel import make_mesh as jmake_mesh, ray_sharding as jray_sharding
from nerf_tpu.parallel import tp_param_shardings as jtp_param_shardings
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train.trainer import (
    TrainState as JTrainState,
    init_train_state as jinit_train_state,
    make_optimizer as jmake_optimizer,
    make_ray_train_step as jmake_ray_train_step,
)
from nerf_tpu_torch.config import (Config, MeshConfig, ModelConfig, RenderConfig, TrainConfig,
                                   bmild_config, default_config)
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.parallel import (
    make_mesh,
    make_sharded_train_step,
    ray_sharding,
    replicated,
    shard_train_state,
    tp_param_shardings,
)
from nerf_tpu_torch.parallel.mesh import replicate, shard_rays
from nerf_tpu_torch.parallel.train import (
    gather_train_state,
    initialize_distributed,
    make_sharded_ray_train_step,
)
from nerf_tpu_torch.train import checkpoint as ckpt
from nerf_tpu_torch.train.trainer import (
    NeRFTrainer,
    TrainState,
    checkpoint_state,
    init_train_state,
    make_optimizer,
    make_train_step,
    select_rays,
)
from nerf_tpu_torch.utils.rendering import (
    RayShard,
    draw_uniforms,
    sample_points_on_rays,
    volume_render,
)
from nerf_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
HW = (24, 32)
FOCAL = 30.0
TIMEOUT = 240          # seconds for one spawned group of ranks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one thread per test worker is the fast way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(**train_kw) -> Config:
    """The reduced-size config of tests/test_sharding.py."""
    return Config(
        model=ModelConfig(pos_freqs=4, dir_freqs=2, hidden_dim=32,
                          n_layers=4, skip_layer=2, color_hidden_dim=16),
        render=RenderConfig(n_coarse=8, n_fine=8),
        train=TrainConfig(**{"n_rays": 64, "compute_dtype": "float32", **train_kw}),
    )


def deterministic(cfg: Config) -> Config:
    """No jitter: with no generator the render draws nothing, in either
    package."""
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, perturb=False))


def ray_step_config() -> Config:
    """The deterministic tiny config with tests/test_sharding.py's weight
    decay, 1e-2. At the default 1e-6 some gradient elements cancel to the
    order of Adam's eps (1e-8), where the first update, lr g / (|g| + eps),
    turns a float32 rounding of g in either framework into up to lr: on
    this test's rays one element of 864 has |g| = 2.2e-8 in JAX and 2.7e-8
    in the port, sharded or not, and its updates differ by 1.3e-5. The
    decay adds 1e-2 w to every element first, so the comparison holds what
    the sharding does, at 1e-5."""
    return deterministic(tiny_config(weight_decay=1e-2))


def sample():
    rng = np.random.default_rng(0)
    image = torch.tensor(rng.uniform(size=(*HW, 3)).astype(np.float32))
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    return image, pose


def fixed_rays(n=64, seed=3):
    rng = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    return ro, rd, rng.uniform(size=(n, 3)).astype(np.float32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, world, *args):
    """Run ``fn(rank, world, port, *args)`` in ``world`` spawned processes,
    within ``TIMEOUT`` seconds; a rank that raises fails the test."""
    ctx = mp.start_processes(fn, args=(world, _free_port(), *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__}: {world} ranks did not finish in {TIMEOUT} s")


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _snapshot(prefix, state: TrainState, out: dict) -> None:
    for (path, leaf), mu, nu in zip(tree_leaves(state.params), state.optimizer.mu,
                                    state.optimizer.nu):
        out[f"{prefix} param {_key(path)}"] = leaf.detach().numpy().copy()
        out[f"{prefix} mu {_key(path)}"] = mu.numpy().copy()
        out[f"{prefix} nu {_key(path)}"] = nu.numpy().copy()


def _part(out: dict, prefix: str, kind: str) -> dict:
    head = f"{prefix} {kind} "
    return {k[len(head):]: v for k, v in out.items() if k.startswith(head)}


# -- the workers (one OS process a rank, gloo on the CPU) ------------------------


def _two_rank_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {}
    try:
        cfg = tiny_config()
        image, pose = sample()
        # data 2 x model 1: one step
        dp = make_mesh(2, 1, device="cpu")
        state = shard_train_state(init_train_state(torch.Generator().manual_seed(2), cfg, "cpu"), dp)
        m = make_sharded_train_step(cfg, HW, dp)(state, image, pose, FOCAL,
                                                 torch.Generator().manual_seed(1))
        res["dp loss"] = float(m["loss"])
        _snapshot("dp", state, res)
        # data 1 x model 2: three steps with a strong weight decay
        wcfg = tiny_config(weight_decay=1e-2)
        tp = make_mesh(1, 2, device="cpu")
        tstate = shard_train_state(init_train_state(torch.Generator().manual_seed(6), wcfg, "cpu"),
                                   tp, tp=True)
        step = make_sharded_train_step(wcfg, HW, tp, tp=True)
        g = torch.Generator().manual_seed(100)
        res["tp losses"] = [float(step(tstate, image, pose, FOCAL, g)["loss"]) for _ in range(3)]
        _snapshot("tp local", tstate, res)
        whole = gather_train_state(tstate, tp, tp=True)
        _snapshot("tp whole", whole, res)
        # rank 0 writes the checkpoint; every rank reads it, shards it again
        # and takes one more step beside the state that never left
        path = os.path.join(out_dir, "tp_state.npz")
        if rank == 0:
            ckpt.save_checkpoint(path, checkpoint_state(whole),
                                 {"config": wcfg.to_dict(), "step": whole.step})
        dist.barrier()
        trainer = NeRFTrainer(wcfg, HW, device="cpu")
        trainer.load_checkpoint(path)
        again = shard_train_state(trainer.state, tp, tp=True)
        g_again = torch.Generator().set_state(g.get_state())
        res["tp continued loss"] = float(step(tstate, image, pose, FOCAL, g)["loss"])
        res["tp resumed loss"] = float(step(again, image, pose, FOCAL, g_again)["loss"])
        res["tp resumed bit-equal"] = all(
            torch.equal(a, b) for a, b in zip(tstate.leaves() + tstate.optimizer.mu
                                              + tstate.optimizer.nu,
                                              again.leaves() + again.optimizer.mu
                                              + again.optimizer.nu))
        # the sharded ray step on fixed rays from the JAX package's params
        pcfg = ray_step_config()
        params = params_from_numpy(ckpt.restore_bare_params(os.path.join(out_dir, "jax_params.npz")),
                                   "cpu")
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        rstate = TrainState(params=params, optimizer=make_optimizer(pcfg, params), step=0)
        rays = np.load(os.path.join(out_dir, "rays.npz"))
        m = make_sharded_ray_train_step(pcfg, dp)(rstate, *(torch.tensor(rays[k])
                                                           for k in ("ro", "rd", "target")))
        res["ray loss"] = float(m["loss"])
        _snapshot("ray", rstate, res)
    finally:
        dist.destroy_process_group()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), res, allow_pickle=True)


def _four_rank_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    res = {}
    try:
        cfg = tiny_config()
        image, pose = sample()
        mesh = make_mesh(2, 2, device="cpu")
        state = shard_train_state(init_train_state(torch.Generator().manual_seed(3), cfg, "cpu"),
                                  mesh, tp=True)
        res["shape before"] = tuple(state.params["fine"]["trunk"][1]["w"].shape)
        m = make_sharded_train_step(cfg, HW, mesh, tp=True)(state, image, pose, FOCAL,
                                                            torch.Generator().manual_seed(4))
        res["loss"] = float(m["loss"])
        res["coords"] = mesh.coords
        res["shape after"] = tuple(state.params["fine"]["trunk"][1]["w"].shape)
        res["mu shape"] = tuple(state.optimizer.mu[
            [p for p, _ in tree_leaves(state.params)].index(("fine", "trunk", 1, "w"))].shape)
        res["finite"] = all(bool(x.isfinite().all()) for x in state.leaves())
    finally:
        dist.destroy_process_group()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), res, allow_pickle=True)


def _load(out_dir, world):
    return [np.load(os.path.join(out_dir, f"rank{r}.npy"), allow_pickle=True).item()
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    jcfg = JConfig.from_dict(tiny_config().to_dict())
    jp = {k: jax.device_get(jinit(jax.random.PRNGKey(7 + i), jcfg.model))
          for i, k in enumerate(("coarse", "fine"))}
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    np.savez(out / "jax_params.npz", **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    ro, rd, target = fixed_rays()
    np.savez(out / "rays.npz", ro=ro, rd=rd, target=target)
    _spawn(_two_rank_worker, 2, str(out))
    return {"dir": out, "ranks": _load(out, 2), "jax_params": jp, "rays": (ro, rd, target)}


def _single_process(cfg, seed, gen_seed, n_steps):
    state = init_train_state(torch.Generator().manual_seed(seed), cfg, "cpu")
    step = make_train_step(cfg, HW)
    image, pose = sample()
    g = torch.Generator().manual_seed(gen_seed)
    losses = [float(step(state, image, pose, FOCAL, g)["loss"]) for _ in range(n_steps)]
    return state, losses


# -- the layout against the JAX package ------------------------------------------


def _full_width(variant):
    return bmild_config() if variant == "bmild" else default_config()


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("variant", ["reference", "bmild"])
def test_tp_param_shardings_match_jax(size, variant):
    cfg = tiny_config() if size == "tiny" else _full_width(variant)
    if size == "tiny" and variant == "bmild":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, variant="bmild"))
    jcfg = JConfig.from_dict(cfg.to_dict())
    jp = jinit_train_state(jax.random.PRNGKey(0), jcfg).params
    jspec = jtp_param_shardings(jp, jmake_mesh(n_data=4, n_model=2))
    as_port = {(None, "model"): 1, ("model",): 0, (): None}
    want = {path: as_port[tuple(s.spec)] for path, s in tree_leaves(jspec)}
    params = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu").params
    got = dict(tree_leaves(tp_param_shardings(params, make_mesh(device="cpu"))))
    assert got == want
    assert {p for p, s in got.items() if s is not None} == {
        p for p, _ in tree_leaves(params) if "trunk" in p or "bottleneck" in p}


def test_config_has_the_jax_mesh_section():
    assert list(Config().to_dict()) == list(JConfig().to_dict())
    assert Config().to_dict()["mesh"] == JConfig().to_dict()["mesh"]
    mesh = MeshConfig(data_axis=2, model_axis=4)
    cfg = dataclasses.replace(default_config(), mesh=mesh)
    back = Config.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back == cfg and back.mesh.axis_names == ("data", "model")
    assert JConfig.from_dict(cfg.to_dict()).mesh == type(JConfig().mesh)(data_axis=2, model_axis=4)


# -- within the port, in one process -----------------------------------------------


def test_mesh_without_a_process_group_is_one_by_one():
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.coords, mesh.distributed) == ((1, 1), (0, 0), False)
    assert mesh.device == torch.device("cpu") and mesh.axis_names == ("data", "model")
    assert ray_sharding(mesh) == replicated(mesh) == RayShard(0, 1)
    x = torch.arange(12.0).reshape(6, 2)
    assert shard_rays(mesh, x) is not None and torch.equal(shard_rays(mesh, x), x)
    assert replicate(mesh, [x])[0] is x
    with pytest.raises(ValueError, match="process group"):
        make_mesh(n_data=2, device="cpu")
    if not torch.cuda.is_available():           # the card is the default: no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("tp", [False, True], ids=["replicated", "tp"])
def test_one_by_one_mesh_is_make_train_step_bit_for_bit(tp):
    # jitter, importance draws and density noise: every draw is in play
    cfg = tiny_config(weight_decay=1e-2)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, raw_noise_std=0.5))
    ref, ref_losses = _single_process(cfg, 2, 1, 3)
    mesh = make_mesh(device="cpu")
    state = shard_train_state(init_train_state(torch.Generator().manual_seed(2), cfg, "cpu"),
                              mesh, tp=tp)
    step = make_sharded_train_step(cfg, HW, mesh, tp=tp)
    image, pose = sample()
    g = torch.Generator().manual_seed(1)
    losses = [float(step(state, image, pose, FOCAL, g)["loss"]) for _ in range(3)]
    assert losses == ref_losses
    for a, b in zip(state.leaves() + state.optimizer.mu + state.optimizer.nu,
                    ref.leaves() + ref.optimizer.mu + ref.optimizer.nu):
        assert torch.equal(a, b)
    assert state.step == ref.step == 3 and state.optimizer.count == 3


def test_shard_draws_concatenate_to_the_unsharded_draws():
    cfg = tiny_config()
    image, pose = sample()
    n, count, S = cfg.train.n_rays, 4, 8

    def draws(shard):
        g = torch.Generator().manual_seed(11)
        ro, rd, target = select_rays(image, pose, FOCAL, g, HW, n, shard)
        _, z = sample_points_on_rays(ro, rd, 2.0, 6.0, S, perturb=True, generator=g, shard=shard)
        u = draw_uniforms(z, 16, g, shard)
        sigma = torch.zeros(ro.shape[0], S)
        rgb = torch.zeros(ro.shape[0], S, 3)
        noisy = volume_render(sigma + 1.0, rgb, z, rd,
                              dataclasses.replace(cfg.render, raw_noise_std=1.0),
                              noise_generator=g, shard=shard)
        return [rd, target, z, u, noisy.weights]

    whole = draws(None)
    shards = [draws(RayShard(i, count)) for i in range(count)]
    for k, full in enumerate(whole):
        assert torch.equal(torch.cat([s[k] for s in shards]), full), k
    with pytest.raises(ValueError, match="equal shards"):
        select_rays(image, pose, FOCAL, torch.Generator(), HW, 63, RayShard(0, 2))


def test_unsharded_make_train_step_draws_as_before():
    # the step's draws without a shard, written out as the trainer made them
    # before shards existed: pixel ids, then the jitter, the importance draws,
    # the coarse and the fine density noise, each one torch call on the
    # generator for the batch
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, raw_noise_std=0.5))
    image, pose = sample()
    H, W = HW
    n, S_c, S_f = cfg.train.n_rays, cfg.render.n_coarse, cfg.render.n_fine
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, H * W, (n,), generator=g)
    t_rand = torch.rand((n, S_c), generator=g)
    u = torch.rand((n, S_f), generator=g)
    noise_c = torch.randn((n, S_c), generator=g)
    noise_f = torch.randn((n, S_c + S_f), generator=g)

    g2 = torch.Generator().manual_seed(5)
    ro, rd, target = select_rays(image, pose, FOCAL, g2, HW, n)
    i, j = (idx % W).float(), torch.div(idx, W, rounding_mode="floor").float()
    dirs = torch.stack([(i - W * 0.5) / FOCAL, -(j - H * 0.5) / FOCAL, -torch.ones_like(i)], -1)
    assert torch.equal(rd, (dirs[:, None, :] * pose[:3, :3]).sum(-1))
    assert torch.equal(target, image.reshape(-1, 3)[idx])
    _, z = sample_points_on_rays(ro, rd, 2.0, 6.0, S_c, perturb=True, generator=g2)
    t = torch.linspace(0.0, 1.0, S_c)
    lin = (2.0 * (1.0 - t) + 6.0 * t).expand(n, S_c)
    m = 0.5 * (lin[:, 1:] + lin[:, :-1])
    upper, lower = torch.cat([m, lin[:, -1:]], -1), torch.cat([lin[:, :1], m], -1)
    assert torch.equal(z, lower + (upper - lower) * t_rand)
    assert torch.equal(draw_uniforms(z, S_f, g2), u)
    for k, noise in enumerate((noise_c, noise_f)):
        S = noise.shape[1]
        sigma = torch.zeros(n, S)
        out = volume_render(sigma, torch.zeros(n, S, 3), torch.linspace(2, 6, S).expand(n, S), rd,
                            dataclasses.replace(cfg.render, raw_noise_std=1.0),
                            noise_generator=g2)
        plain = volume_render(noise, torch.zeros(n, S, 3), torch.linspace(2, 6, S).expand(n, S),
                              rd, cfg.render)
        assert torch.equal(out.weights, plain.weights), k


# -- two ranks (data 2 x model 1, data 1 x model 2) --------------------------------


def test_dp_step_matches_single_process(two_ranks):
    ref, ref_losses = _single_process(tiny_config(), 2, 1, 1)
    r0, r1 = two_ranks["ranks"]
    assert r0["dp loss"] == r1["dp loss"]            # the global loss, on every rank
    np.testing.assert_allclose(r0["dp loss"], ref_losses[0], rtol=1e-5)
    got = _part(r0, "dp", "param")
    assert got.keys() == _part(r1, "dp", "param").keys()
    for (path, leaf) in tree_leaves(ref.params):
        assert np.array_equal(got[_key(path)], _part(r1, "dp", "param")[_key(path)])
        np.testing.assert_allclose(got[_key(path)], leaf.detach().numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))


def test_tp_weight_decay_bit_equal_to_single_process(two_ranks):
    ref, ref_losses = _single_process(tiny_config(weight_decay=1e-2), 6, 100, 3)
    for r in two_ranks["ranks"]:
        assert r["tp losses"] == ref_losses
        for kind, values in (("param", [x.detach() for x in ref.leaves()]),
                             ("mu", ref.optimizer.mu), ("nu", ref.optimizer.nu)):
            whole = _part(r, "tp whole", kind)
            for (path, _), value in zip(tree_leaves(ref.params), values):
                assert np.array_equal(whole[_key(path)], value.numpy()), (kind, path)


def test_tp_moments_sliced_like_their_params(two_ranks):
    ref, _ = _single_process(tiny_config(weight_decay=1e-2), 6, 100, 3)
    split = dict(tree_leaves(tp_param_shardings(ref.params, make_mesh(device="cpu"))))
    for m, r in enumerate(two_ranks["ranks"]):
        for kind, values in (("param", [x.detach() for x in ref.leaves()]),
                             ("mu", ref.optimizer.mu), ("nu", ref.optimizer.nu)):
            local = _part(r, "tp local", kind)
            for (path, _), value in zip(tree_leaves(ref.params), values):
                axis = split[path]
                want = value.numpy() if axis is None else np.split(value.numpy(), 2, axis)[m]
                assert local[_key(path)].shape == want.shape, (kind, path)
                assert np.array_equal(local[_key(path)], want), (kind, path)
    w = _part(two_ranks["ranks"][0], "tp local", "mu")["fine/trunk/1/w"]
    assert w.shape == (32, 16)


def test_tp_checkpoint_read_by_jax_and_keeps_training(two_ranks):
    path = str(two_ranks["dir"] / "tp_state.npz")
    cfg = tiny_config(weight_decay=1e-2)
    template = jinit_train_state(jax.random.PRNGKey(11), JConfig.from_dict(cfg.to_dict()))
    jstate, meta = jckpt.restore_checkpoint(path, template)
    assert meta["step"] == 3 and int(jstate.step) == 3
    whole = _part(two_ranks["ranks"][0], "tp whole", "param")
    for path_, leaf in tree_leaves(jax.device_get(jstate.params)):
        assert np.array_equal(np.asarray(leaf), whole[_key(path_)]), path_
    adam = [s for s in jstate.opt_state if hasattr(s, "mu")][0]
    mu = _part(two_ranks["ranks"][0], "tp whole", "mu")
    for path_, leaf in tree_leaves(jax.device_get(adam.mu)):
        assert np.array_equal(np.asarray(leaf), mu[_key(path_)]), path_
    for r in two_ranks["ranks"]:
        assert np.isfinite(r["tp resumed loss"])
        assert r["tp resumed loss"] == r["tp continued loss"] and r["tp resumed bit-equal"]


def test_sharded_ray_step_matches_jax(two_ranks):
    # the JAX sharded ray step on its 8 virtual devices, the port's on 2
    # ranks: the same params, rays and deterministic render
    cfg = ray_step_config()
    jcfg = JConfig.from_dict(cfg.to_dict())
    jp = two_ranks["jax_params"]
    jstate = JTrainState(params=jp, opt_state=jmake_optimizer(jcfg).init(jp),
                         step=jnp.zeros((), jnp.int32))
    jstep = jmake_ray_train_step(jcfg, donate=False, ray_sharding=jray_sharding(jmake_mesh(8)))
    new, metrics = jstep(jstate, *(jnp.asarray(a) for a in two_ranks["rays"]), None)
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(r["ray loss"], float(metrics["loss"]), rtol=1e-5)
        got = _part(r, "ray", "param")
        for path, leaf in tree_leaves(jax.device_get(new.params)):
            np.testing.assert_allclose(got[_key(path)], np.asarray(leaf), atol=1e-5, rtol=0,
                                       err_msg=str(path))


# -- four ranks: data 2 x model 2 ---------------------------------------------------


def test_dp_tp_2x2_step_is_finite_and_keeps_its_layout(tmp_path):
    _spawn(_four_rank_worker, 4, str(tmp_path))
    ranks = _load(tmp_path, 4)
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert np.isfinite(r["loss"]) and r["finite"]
        assert r["shape before"] == r["shape after"] == r["mu shape"] == (32, 16)
    assert len({r["loss"] for r in ranks}) == 1


# -- the command line: train over two processes --------------------------------------


def test_two_process_cli_train(tmp_path):
    port = _free_port()
    ckpt_dir = tmp_path / "ckpt"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                     else "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nerf_tpu_torch.cli", "train", "--device", "cpu",
         "--data_dir", str(tmp_path / "nonexistent"),       # the procedural scene
         "--image_size", "16", "--streaming_steps", "4", "--n_rays", "64",
         "--checkpoint_dir", str(ckpt_dir), "--output_dir", str(tmp_path / "out"),
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), f"{outs[0][-1500:]}\n---\n{outs[1][-1500:]}"
    losses = {}
    for out in outs:
        m = re.search(r"PROC (\d+) FINAL LOSS ([0-9.]+)", out)
        assert m, out[-2000:]
        losses[int(m.group(1))] = float(m.group(2))
    assert len(losses) == 2 and losses[0] == losses[1]
    path = ckpt_dir / "final_model.npz"
    state, meta = ckpt.restore_checkpoint(str(path))
    assert meta["distributed"] and state["step"] == 4 and state["count"] == 4
    jcfg = JConfig.from_dict(meta["config"])
    jstate, _ = jckpt.restore_checkpoint(str(path), jinit_train_state(jax.random.PRNGKey(0), jcfg))
    for p, leaf in tree_leaves(jax.device_get(jstate.params)):
        assert np.array_equal(np.asarray(leaf), dict(tree_leaves(state["params"]))[p])
