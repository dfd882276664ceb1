"""The training slice of the port on the CPU: the step's gradients and the
optimizer's trajectory vs the JAX package's on the same rays and parameters,
and the trainer's loop (counterparts of ``tests/test_train.py``). Stochastic
draws cannot be reproduced across the frameworks, so the parity tests render
deterministically (no jitter, no generator / no key)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nerf_tpu.config import Config as JConfig
from nerf_tpu.models.nerf import init_nerf_params as jinit
from nerf_tpu.render.pipeline import render_rays as jrender_rays
from nerf_tpu.train.trainer import make_optimizer as jmake_optimizer
from nerf_tpu_torch.config import Config, ModelConfig, RenderConfig, TrainConfig
from nerf_tpu_torch.data.synthetic import make_procedural_dataset
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.train.trainer import (
    NeRFTrainer,
    TrainState,
    init_train_state,
    loss_fn,
    make_eval_render,
    make_optimizer,
    make_ray_train_step,
    make_train_step,
)
from nerf_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny config's tensors are too small to share between threads, and
    several test workers' thread pools fighting for the cores slow these
    loops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(render=None, **train_kw) -> Config:
    """The reduced-size config of tests/test_train.py."""
    return Config(
        model=ModelConfig(pos_freqs=4, dir_freqs=2, hidden_dim=32,
                          n_layers=4, skip_layer=2, color_hidden_dim=16),
        render=render or RenderConfig(n_coarse=12, n_fine=16),
        train=TrainConfig(**{"n_rays": 128, "compute_dtype": "float32",
                             "learning_rate": 5e-3, **train_kw}),
    )


def _jax_cfg(cfg: Config) -> JConfig:
    return JConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def ds():
    return make_procedural_dataset(n_views=4, img_wh=(48, 48))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 4.0
    rd = (rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    return ro, rd, rng.uniform(size=(n, 3)).astype(np.float32)


def _both_params(cfg: Config, seed):
    """The same coarse and fine params in both packages."""
    jp = {k: jax.device_get(jinit(jax.random.PRNGKey(seed + i), _jax_cfg(cfg).model))
          for i, k in enumerate(("coarse", "fine"))}
    tp = params_from_numpy(jp, "cpu")
    for _, leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    return jp, tp


def _jax_loss(jcfg, rays):
    ro, rd, target = (jnp.asarray(a) for a in rays)

    def loss(params):
        res = jrender_rays(params["coarse"], params["fine"], ro, rd, jcfg.model, jcfg.render,
                           key=None, perturb=False,
                           compute_dtype=jnp.dtype(jcfg.train.compute_dtype))
        return jnp.mean((res.coarse.rgb - target) ** 2) + jnp.mean((res.fine.rgb - target) ** 2)

    return loss


# -- the slice against the JAX package ------------------------------------------


@pytest.mark.parametrize("case", ["tiny", "full_uniform_fine", "full_importance"])
def test_step_gradients_match_jax(case):
    # float32, deterministic, the same rays: per leaf ||a - b|| / ||b|| <=
    # 1e-4 against jax.grad of the JAX loss, at the tiny config and at full
    # width with a uniform fine pass. With importance sampling at full width
    # the fine network's leaves are held to 2e-2: sample_pdf's CDF sums run
    # in another order in the two frameworks, which moves a draw in a bin of
    # tiny mass by up to ~1e-4, and the top encoding band (2^9 pi) turns that
    # into percents of the small gradients of an untrained fine network (its
    # first layer's worst, 1.1e-2). The coarse network's leaves stay at 1e-4
    if case == "tiny":
        cfg, n_rays = tiny_config(), 96
    else:
        cfg = Config(render=RenderConfig(n_coarse=16, n_fine=24,
                                         use_importance=case == "full_importance"),
                     train=TrainConfig(compute_dtype="float32"))
        n_rays = 40
    rays = _rays(n_rays, 0)
    jp, tp = _both_params(cfg, 0)
    g_j = dict(tree_leaves(jax.device_get(jax.grad(_jax_loss(_jax_cfg(cfg), rays))(jp))))
    loss, (loss_c, loss_f) = loss_fn(tp, cfg, *(torch.tensor(a) for a in rays))
    paths, leaves = zip(*tree_leaves(tp))
    g_t = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    assert float(loss.detach()) == pytest.approx(float(loss_c.detach()) + float(loss_f.detach()))
    assert set(g_t) == set(g_j)
    for k, ref in g_j.items():
        ref = torch.tensor(np.asarray(ref))
        tol = 2e-2 if case == "full_importance" and k[0] == "fine" else 1e-4
        assert float((g_t[k] - ref).norm() / (ref.norm() + 1e-20)) <= tol, k


@pytest.mark.parametrize("clip, decay", [(1e-3, 1e-3), (100.0, 1e-2)],
                         ids=["clip_fires", "clip_idle_strong_decay"])
def test_optimizer_trajectory_matches_optax(clip, decay):
    # 20 steps of the two optimizers on the same rays from the same
    # parameters, at the recipe's learning rate (3e-4: each parameter moves
    # by up to 6e-3): parameters within 1e-5. This holds the hand-written
    # clip, the decay, Adam and the schedule against optax's chain. Where the
    # clip fires the decay term outweighs the clipped gradient, so a missing
    # or misplaced clip would change the trajectory's direction
    cfg = tiny_config(grad_clip_norm=clip, weight_decay=decay, lr_decay_steps=40,
                      learning_rate=3e-4)
    jcfg = _jax_cfg(cfg)
    rays = _rays(96, 1)
    jp, tp = _both_params(cfg, 2)
    jloss = _jax_loss(jcfg, rays)
    norm0 = float(optax.global_norm(jax.grad(jloss)(jp)))
    assert (norm0 > clip) == (clip < 1.0)        # the case is what its name says

    opt = jmake_optimizer(jcfg)

    @jax.jit
    def jstep(params, opt_state):
        updates, opt_state = opt.update(jax.grad(jloss)(params), opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt_state = opt.init(jp)
    state = TrainState(params=tp, optimizer=make_optimizer(cfg, tp), step=0)
    step = make_ray_train_step(cfg)
    trays = [torch.tensor(a) for a in rays]
    for _ in range(20):
        jp, opt_state = jstep(jp, opt_state)
        step(state, *trays)
    assert state.step == 20 and state.optimizer.count == 20
    ref = dict(tree_leaves(jax.device_get(jp)))
    for k, leaf in tree_leaves(state.params):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0,
                                   err_msg=str(k))


def test_lr_schedule_matches_reference_formula():
    # lr(t) = lr0 * decay^(t / decay_steps), with t the count before the update
    cfg = tiny_config()
    opt = make_optimizer(cfg, init_train_state(torch.Generator().manual_seed(0), cfg,
                                               "cpu").params)
    sched = optax.exponential_decay(cfg.train.learning_rate, cfg.train.lr_decay_steps,
                                    cfg.train.lr_decay)
    for t in (0, 1000, 250_000):
        expected = cfg.train.learning_rate * cfg.train.lr_decay ** (t / cfg.train.lr_decay_steps)
        assert opt.learning_rate(t) == pytest.approx(expected, rel=1e-12)
        assert opt.learning_rate(t) == pytest.approx(float(sched(t)), rel=1e-5)


# -- the trainer (counterparts of tests/test_train.py) ----------------------------


def test_single_step_updates_params_and_metrics(ds):
    cfg = tiny_config()
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    before = state.params["fine"]["trunk"][0]["w"].detach().clone()
    step = make_train_step(cfg, (48, 48))
    item = ds[0]
    metrics = step(state, torch.tensor(item["image"]), torch.tensor(item["pose"]),
                   float(ds.focal), torch.Generator().manual_seed(1))
    assert state.step == 1 and state.optimizer.count == 1
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["loss_coarse"]) > 0 and float(metrics["loss_fine"]) > 0
    assert float(metrics["psnr"]) == pytest.approx(-10 * np.log10(float(metrics["loss_fine"])),
                                                   rel=1e-5)
    assert (state.params["fine"]["trunk"][0]["w"] - before).abs().max() > 0


def test_loss_decreases_on_procedural_scene(ds):
    trainer = NeRFTrainer(tiny_config(), (48, 48), device="cpu")
    first = trainer.train_epoch(ds)
    for _ in range(14):
        last = trainer.train_epoch(ds)
    assert last < first * 0.7, f"no learning: first={first:.4f} last={last:.4f}"


def test_density_noise_trains_and_is_seeded(ds):
    # raw_noise_std > 0: the perturbed passes draw density noise from the
    # step's generator; one seed gives one trajectory, another another
    cfg = tiny_config(render=RenderConfig(n_coarse=12, n_fine=16, raw_noise_std=1.0))

    def run(seed):
        trainer = NeRFTrainer(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, seed=seed)), (48, 48), device="cpu")
        return trainer.train_epoch(ds)

    a, b, c = run(0), run(0), run(1)
    assert np.isfinite(a) and a == b and a != c


def test_trainer_loop_with_validation_and_plot(ds, tmp_path):
    cfg = dataclasses.replace(
        tiny_config(checkpoint_frequency=2, val_frequency=2, n_epochs=2),
        checkpoint_dir=str(tmp_path / "ckpt"), output_dir=str(tmp_path / "out"))
    trainer = NeRFTrainer(cfg, (48, 48), device="cpu")
    logs = []
    trainer.train(ds, val_ds=ds, n_epochs=2, log_fn=logs.append)
    assert len(trainer.train_losses) == 2
    assert len(trainer.val_losses) == 1
    assert (tmp_path / "ckpt" / "checkpoint_epoch_2.npz").exists()
    assert trainer.plot_losses() is not None

    # resume: a fresh trainer picks up at epoch 2 and continues to 3
    trainer2 = NeRFTrainer(cfg, (48, 48), device="cpu")
    logs2 = []
    trainer2.train(ds, n_epochs=3, log_fn=logs2.append)
    assert any("resumed" in line for line in logs2)
    assert len(trainer2.train_losses) == 3
    assert trainer2.state.step == 3 * len(ds)


def test_eval_render_pads_non_divisible_shapes(ds):
    cfg = tiny_config()
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    render = make_eval_render(cfg, n_rays_chunk=1000, device="cpu")  # 48*48=2304 -> pad
    rgb, depth = render(state.params, ds[0]["pose"], (48, 48), float(ds.focal))
    assert rgb.shape == (48, 48, 3) and depth.shape == (48, 48)
    assert torch.isfinite(rgb).all() and not rgb.requires_grad


def test_procedural_dataset_matches_jax_package(ds):
    from nerf_tpu.data.synthetic import make_procedural_dataset as jmake

    ref = jmake(n_views=4, img_wh=(48, 48))
    np.testing.assert_array_equal(ds.images, ref.images)
    np.testing.assert_array_equal(ds.poses, ref.poses)
    assert ds.focal == ref.focal and len(ds) == 4 and ds[1]["image"].shape == (48, 48, 3)


def test_about_half_of_all_seeds_start_a_network_dead_in_both_packages():
    # The density head is ReLU'd and both packages draw it from the same law
    # (uniform +-1/sqrt(fan_in) against 256 non-negative inputs), so about half
    # of all full-width networks start with a density of 0 on every sample,
    # where no gradient reaches them. Share of 400 rays x 64 uniform depths
    # (spherical_pose(30, -30, 4), near 2, far 6) with a positive initial
    # density, coarse / fine, for the networks the two trainers draw from
    # TrainConfig.seed (JAX: PRNGKey(seed) split as NeRFTrainer and
    # init_train_state split it; the port: one torch.Generator, coarse
    # first). Asserted: what is stable. The JAX package's own default seed 0
    # starts with a dead coarse network, the port's with a dead fine one,
    # seed 5 is alive in both, and each package has between a quarter and
    # three quarters of its sixteen networks dead
    from nerf_tpu.config import ModelConfig as JModelConfig
    from nerf_tpu.models import apply_nerf as japply
    from nerf_tpu.train.trainer import init_train_state as jinit_train_state
    from nerf_tpu_torch.models.nerf import apply_nerf
    from nerf_tpu_torch.utils.cameras import focal_from_angle, generate_rays, spherical_pose

    cfg, jcfg = Config(), JConfig()
    assert cfg.train.seed == jcfg.train.seed == 0
    ours, theirs = dataclasses.asdict(cfg.model), dataclasses.asdict(JModelConfig())
    assert {k: v for k, v in ours.items() if k in theirs} == theirs
    # the port's own keys are the mip and mip360 variants', at values the
    # other variants ignore
    assert {k: v for k, v in ours.items() if k not in theirs} == {
        "ipe_min_deg": 0, "ipe_max_deg": 16, "density_bias": 0.0, "rgb_padding": 0.0,
        "bottleneck_dim": 256, "prop_hidden_dim": 256, "prop_layers": 4}
    n = 20
    ro, rd = generate_rays(spherical_pose(30.0, -30.0, 4.0), n, n,
                           focal_from_angle(n, 0.6911112070083618), "cpu")
    z = torch.linspace(2.0, 6.0, 64)
    pos = ro.reshape(-1, 1, 3) + rd.reshape(-1, 1, 3) * z[None, :, None]
    dirs = rd.reshape(-1, 1, 3).expand(pos.shape)
    jpos, jdirs = jnp.asarray(pos.numpy()), jnp.asarray(dirs.numpy())
    torch.set_num_threads(4)

    def port_shares(seed):
        state = init_train_state(torch.Generator().manual_seed(seed), cfg, "cpu")
        with torch.no_grad():
            return tuple(float((apply_nerf(state.params[net], pos, dirs, cfg.model)[0] > 0)
                               .float().mean()) for net in ("coarse", "fine"))

    def jax_shares(seed):
        _, init_key = jax.random.split(jax.random.PRNGKey(seed))
        state = jinit_train_state(init_key, jcfg)
        return tuple(float((japply(state.params[net], jpos, jdirs, jcfg.model)[0] > 0).mean())
                     for net in ("coarse", "fine"))

    table = {seed: (jax_shares(seed), port_shares(seed)) for seed in range(8)}
    print("seed: JAX coarse/fine, port coarse/fine", table)
    (j0c, j0f), (p0c, p0f) = table[0]
    assert j0c < 0.01 and j0f > 0.99          # JAX seed 0: dead coarse network
    assert p0c > 0.99 and p0f < 0.01          # the port's seed 0: dead fine network
    assert min(*table[5][0], *table[5][1]) > 0.99
    for package in (0, 1):
        dead = sum(share < 0.5 for seed in table for share in table[seed][package])
        assert 4 <= dead <= 12, (package, dead)
