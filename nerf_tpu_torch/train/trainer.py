"""NeRF trainer: the train step and an orchestration loop.

Counterpart of ``nerf_tpu/train/trainer.py``: coarse + fine networks under
one Adam optimizer, per-step exponential learning-rate decay
``lr * decay^(step / decay_steps)``, a random ray subset of one image per
step, loss = MSE(coarse) + MSE(fine), global gradient-norm clipping, periodic
validation on at most ``max_val_images`` images, epoch-granular checkpoints
with auto-resume, and a loss-curve PNG.

The whole step runs on the device with no host round trip: ray selection,
stratified + importance sampling, both MLP evaluations, compositing, loss,
backward and the optimizer update. On a CUDA device with the standard
architecture the MLP's forward and backward are the hand-written kernels
(``ops/train_kernel.fused_train_apply``: K4 and K5); everything else is
plain PyTorch under autograd. PyTorch idiom where the JAX package is
functional: a ``TrainState`` is updated in place, and a step takes a
``torch.Generator`` (on the training device) where JAX takes a key. One
generator serves a step's draws in this order: ray selection, then
``render_rays``' (jitter, importance draws, density noise). A rank of the
sharded step (``parallel/train.py``) makes the same draws for the whole
batch and keeps its rows (``select_rays`` and ``loss_fn`` with a
``RayShard``).

The optimizer is optax's chain of the JAX trainer, written out: clip by
global norm (scale by ``max_norm / norm`` only when ``norm >= max_norm``;
``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead), L2
decay added to the clipped gradient, Adam (``eps = 1e-8`` outside the
square root), and the learning rate of the step count before the update.
Its state is (``mu``, ``nu``, ``count``), as optax's, so checkpoints carry
over between the packages.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_tpu_torch.config import Config
from nerf_tpu_torch.models.nerf import (
    NeRFParams,
    apply_nerf,
    init_nerf_params,
    params_from_numpy,
    params_to_numpy,
)
from nerf_tpu_torch.render.pipeline import render_rays
from nerf_tpu_torch.train import checkpoint as ckpt
from nerf_tpu_torch.utils.cameras import generate_rays
from nerf_tpu_torch.utils.device import resolve_device, torch_dtype
from nerf_tpu_torch.utils.graph import GraphedCall, HostCounters
from nerf_tpu_torch.utils.metrics import psnr_from_mse
from nerf_tpu_torch.utils.rendering import RayShard
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves


class Optimizer:
    """optax's ``chain(clip_by_global_norm, add_decayed_weights,
    scale_by_adam, scale_by_learning_rate(exponential_decay))`` over a list
    of leaves, updated in place. ``mu`` and ``nu`` line up with the leaves;
    ``count`` is the number of updates made, a host int (the checkpoints
    write it). ``device_count`` holds the same number on the leaves' device,
    and the update's scalars (the learning rate, Adam's bias corrections)
    are made from it there, in float64: an update captured in a CUDA graph
    then reads the count of each replay, and the eager and the captured
    update run the same arithmetic."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: Config, leaves: List[torch.Tensor]):
        self.tcfg = cfg.train
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.count = 0
        self.device_count = torch.zeros((), dtype=torch.int64, device=leaves[0].device)

    def set_count(self, count: int) -> None:
        self.count = int(count)
        self.device_count.fill_(self.count)

    def learning_rate(self, count):
        """The schedule at ``count`` updates: of an int, a float; of a
        float64 tensor (``update``'s device count), a tensor."""
        t = self.tcfg
        return t.learning_rate * t.lr_decay ** (count / t.lr_decay_steps)

    def _scalars(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(lr(count) / (1 - b1^n), 1 - b2^n)``, ``n = count + 1``: float32
        device scalars computed in float64 from ``device_count``."""
        count = self.device_count.double()
        n = count + 1.0
        step_size = self.learning_rate(count) / (1.0 - self.b1 ** n)
        return step_size.float(), (1.0 - self.b2 ** n).float()

    @torch.no_grad()
    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """One update of ``leaves`` from ``grads`` (which it overwrites)."""
        self.apply(leaves, grads, self.clip_scale(grads))

    @torch.no_grad()
    def clip_scale(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global-norm clip's factor of ``grads`` (every leaf's whole
        gradient): 1, or ``max_norm / norm`` where ``norm >= max_norm``."""
        max_norm = self.tcfg.grad_clip_norm
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        return torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)

    @torch.no_grad()
    def apply(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
              scale: torch.Tensor) -> None:
        """The update after the clip's norm: ``grads`` (overwritten) scaled by
        ``scale``, the decay, Adam and the schedule, elementwise, so a slice
        of the leaves, their moments and their gradients (``parallel/``'s
        model axis) updates exactly as the same slice of the whole would."""
        t = self.tcfg
        step_size, bias2 = self._scalars()
        torch._foreach_mul_(grads, scale)
        torch._foreach_add_(grads, leaves, alpha=t.weight_decay)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.mu, denom)
        torch._foreach_mul_(step, step_size)
        torch._foreach_sub_(leaves, step)
        self.device_count += 1
        self.count += 1


@dataclass
class TrainState:
    params: Dict[str, NeRFParams]   # {'coarse': ..., 'fine': ...}, leaves require grad
    optimizer: Optimizer
    step: int

    def leaves(self) -> List[torch.Tensor]:
        return [leaf for _, leaf in tree_leaves(self.params)]


def checkpoint_state(state: TrainState) -> Dict[str, Any]:
    """A train state as ``train/checkpoint.save_checkpoint`` takes it: params
    and Adam moments as nested numpy arrays, the update count, the step."""
    paths = [p for p, _ in tree_leaves(state.params)]
    opt = state.optimizer
    return {
        "params": params_to_numpy(state.params),
        "mu": params_to_numpy(tree_from_leaves(paths, opt.mu)),
        "nu": params_to_numpy(tree_from_leaves(paths, opt.nu)),
        "count": opt.count,
        "step": state.step,
    }


def make_optimizer(cfg: Config, params) -> Optimizer:
    """One optimizer over both networks' params."""
    return Optimizer(cfg, [leaf for _, leaf in tree_leaves(params)])


def init_train_state(generator: torch.Generator, cfg: Config, device="cuda") -> TrainState:
    """Random coarse and fine params drawn on the CPU from ``generator``
    (coarse first), moved to ``device``, with a fresh optimizer."""
    dev = resolve_device(device)
    params = {"coarse": init_nerf_params(generator, cfg.model, dev),
              "fine": init_nerf_params(generator, cfg.model, dev)}
    for _, leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params=params, optimizer=make_optimizer(cfg, params), step=0)


def loss_fn(params, cfg: Config, rays_o, rays_d, target, generator=None, apply_fn=apply_nerf,
            shard: Optional[RayShard] = None):
    """``(loss, (loss_coarse, loss_fine))`` of one ray batch: the MSE of the
    coarse and of the fine render against ``target [R, 3]``, summed. With a
    generator the render is the training one (jitter if ``cfg.render.perturb``,
    random importance draws); without, it is deterministic. With a
    ``shard`` the rays are that shard of the step's batch (``render_rays``)."""
    result = render_rays(params["coarse"], params["fine"], rays_o, rays_d,
                         cfg.model, cfg.render, generator=generator,
                         perturb=cfg.render.perturb and generator is not None,
                         compute_dtype=torch_dtype(cfg.train.compute_dtype), apply_fn=apply_fn,
                         shard=shard)
    loss_c = torch.mean((result.coarse.rgb - target) ** 2)
    loss_f = torch.mean((result.fine.rgb - target) ** 2)
    return loss_c + loss_f, (loss_c, loss_f)


def _loss_and_update(state: TrainState, cfg: Config, rays_o, rays_d, target, generator,
                     apply_fn) -> Dict[str, torch.Tensor]:
    loss, (loss_c, loss_f) = loss_fn(state.params, cfg, rays_o, rays_d, target, generator,
                                     apply_fn)
    leaves = state.leaves()
    grads = list(torch.autograd.grad(loss, leaves))
    state.optimizer.update(leaves, grads)
    state.step += 1
    return {"loss": loss.detach(), "loss_coarse": loss_c.detach(),
            "loss_fine": loss_f.detach(), "psnr": psnr_from_mse(loss_f.detach())}


def make_ray_train_step(cfg: Config, apply_fn=apply_nerf):
    """Train step over given rays: ``step_fn(state, rays_o [R, 3],
    rays_d [R, 3], target [R, 3], generator=None) -> metrics`` (``loss``,
    ``loss_coarse``, ``loss_fine``, ``psnr``, device scalars); the state is
    updated in place. Without a generator the render is deterministic
    (no jitter, midpoint importance draws)."""

    def step_fn(state: TrainState, rays_o, rays_d, target, generator=None):
        return _loss_and_update(state, cfg, rays_o, rays_d, target, generator, apply_fn)

    return step_fn


def select_rays(image, pose, focal, generator, img_hw: Tuple[int, int], n_rays: int,
                shard: Optional[RayShard] = None):
    """A step's random ray batch of one image: ``(rays_o, rays_d, target)``,
    each ``[n_rays, 3]`` (with a ``shard``, its ``n_rays / count`` rows of
    the batch: the pixel ids are drawn for the whole batch).

    O(n_rays): draw pixel ids (with replacement), then evaluate the camera
    model closed-form for just those pixels, instead of building the H*W ray
    grid and permuting it every step."""
    H, W = img_hw
    idx = torch.randint(0, H * W, (n_rays,), device=image.device, generator=generator)
    if shard is not None:
        if n_rays % shard.count:
            raise ValueError(f"{n_rays} rays do not split into {shard.count} equal shards")
        idx = idx[shard.rows(n_rays // shard.count)]
    i = (idx % W).float()
    j = torch.div(idx, W, rounding_mode="floor").float()
    dirs_cam = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                            -torch.ones_like(i)], dim=-1)
    # written out per output axis (no matmul, so no TF32 question)
    rays_d = (dirs_cam[:, None, :] * pose[:3, :3]).sum(-1)
    rays_o = pose[:3, -1].expand(rays_d.shape)
    target = image.reshape(-1, 3).index_select(0, idx)
    return rays_o, rays_d, target


def make_train_step(cfg: Config, img_hw: Tuple[int, int], apply_fn=apply_nerf):
    """Train step for a fixed image shape: ``step_fn(state, image [H, W, 3],
    pose [4, 4], focal, generator) -> metrics``, all tensors on the state's
    device; the state is updated in place. Its rays: ``select_rays``."""
    ray_step = make_ray_train_step(cfg, apply_fn)

    def step_fn(state: TrainState, image, pose, focal, generator):
        rays_o, rays_d, target = select_rays(image, pose, focal, generator, img_hw,
                                             cfg.train.n_rays)
        return ray_step(state, rays_o, rays_d, target, generator)

    return step_fn


def make_multi_train_step(cfg: Config, img_hw: Tuple[int, int], n_inner: int,
                          apply_fn=apply_nerf, pool=None):
    """``n_inner`` train steps in one launch: ``fn(state, images [K, H, W, 3],
    poses [K, 4, 4], focal, generator) -> metrics`` (each a ``[K]`` tensor),
    with the semantics of ``K = n_inner`` sequential calls of
    ``make_train_step``'s step on the same generator; the state is updated in
    place. The counterpart of the JAX package's ``lax.scan`` of the steps.

    On CPU tensors the K steps run eagerly. On the card they are one CUDA
    graph (``utils/graph.GraphedCall``): the first call for a state,
    generator, image shape and ``focal`` (a Python float inside the step)
    runs its K steps eagerly on a side stream, which fills the kernels'
    caches, then captures them; later calls copy their images and poses
    into the graph's static buffers and replay it. The graph holds the
    addresses of the params, ``mu``, ``nu`` and the device count: the
    trainer only ever writes into them (``load_checkpoint`` too), and a
    state whose tensors moved is captured anew. ``pool`` is the memory pool
    of the capture (``torch.cuda.graph_pool_handle()``, shared by graphs
    that are replayed one at a time on one stream; None: a pool of its
    own). The kernels' launch counters count the first call's launches, not
    the replays' (``ops/_ext.ran``)."""
    step_fn = make_train_step(cfg, img_hw, apply_fn)
    graphed: Dict[str, Any] = {}

    def steps(state: TrainState, images, poses, focal, generator) -> Dict[str, torch.Tensor]:
        per_step = [step_fn(state, images[i], poses[i], focal, generator)
                    for i in range(n_inner)]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    def multi_step(state: TrainState, images, poses, focal, generator):
        if images.shape[0] != n_inner or poses.shape[0] != n_inner:
            raise ValueError(f"{n_inner} steps need {n_inner} images and poses, got "
                             f"{images.shape[0]} and {poses.shape[0]}")
        if images.device.type != "cuda":
            return steps(state, images, poses, focal, generator)
        opt = state.optimizer
        key = (tuple(images.shape), images.dtype, images.device, float(focal),
               tuple(t.data_ptr() for t in state.leaves() + opt.mu + opt.nu
                     + [opt.device_count]))
        if (graphed.get("key") != key or graphed["state"] is not state
                or graphed["generator"] is not generator):
            graphed.clear()
            static_images, static_poses = images.clone(), poses.clone()
            call = GraphedCall(
                lambda: steps(state, static_images, static_poses, focal, generator),
                HostCounters([(state, "step"), (state.optimizer, "count")]), [generator],
                pool)
            graphed.update(key=key, state=state, generator=generator, call=call,
                           images=static_images, poses=static_poses)
        else:
            graphed["images"].copy_(images)
            graphed["poses"].copy_(poses)
        with torch.cuda.device(images.device):       # its streams and graph on that card
            return graphed["call"]()

    return multi_step


def make_eval_render(cfg: Config, n_rays_chunk: int, apply_fn=apply_nerf, device="cuda"):
    """Chunk renderer for validation and full images: fixed chunk shape (the
    last chunk is padded), deterministic sampling, fine output only, no
    autograd graph. ``render_image(params, pose, img_hw, focal) ->
    (rgb [H, W, 3], depth [H, W])``."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.train.compute_dtype)

    @torch.no_grad()
    def render_image(params, pose, img_hw, focal):
        H, W = img_hw
        rays_o, rays_d = generate_rays(pose, W, H, focal, dev)
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        n = H * W
        pad = (-n) % n_rays_chunk
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
            rays_d = torch.cat([rays_d, rays_d.new_ones(pad, 3)])
        rgbs, depths = [], []
        for k in range(0, n + pad, n_rays_chunk):
            res = render_rays(params["coarse"], params["fine"], rays_o[k:k + n_rays_chunk],
                              rays_d[k:k + n_rays_chunk], cfg.model, cfg.render,
                              compute_dtype=dt, apply_fn=apply_fn)
            rgbs.append(res.fine.rgb)
            depths.append(res.fine.depth)
        return (torch.cat(rgbs)[:n].reshape(H, W, 3), torch.cat(depths)[:n].reshape(H, W))

    return render_image


def default_train_apply_fn(cfg: Config, device="cuda"):
    """The MLP evaluator the trainer uses by default: the fused forward and
    backward kernels (``ops/train_kernel.py``) on a CUDA device with the
    architecture they specialize, ``apply_nerf`` otherwise. Decided by the
    requested device and the config alone; a failed build or launch raises."""
    mcfg = cfg.model
    standard = (mcfg.variant == "reference" and mcfg.hidden_dim == 256
                and mcfg.n_layers == 8 and mcfg.color_hidden_dim == 128)
    if torch.device(device).type == "cuda" and standard:
        from nerf_tpu_torch.ops.train_kernel import make_train_apply_fn

        return make_train_apply_fn()
    return apply_nerf


class NeRFTrainer:
    """Training orchestration: epochs, validation, checkpoints, resume,
    loss curves. All compute lives in the step above."""

    def __init__(self, cfg: Config, img_hw: Tuple[int, int], apply_fn=None, device="cuda"):
        if cfg.model.variant in ("mip", "mip360"):
            raise ValueError(f"the trainer does not train the {cfg.model.variant} variant "
                             "(Mip-NeRF, Mip-NeRF 360): its steps sample points, not "
                             "intervals; render it with the torch or cuda engine")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.img_hw = img_hw
        self.apply_fn = (apply_fn if apply_fn is not None
                         else default_train_apply_fn(cfg, self.device))
        self.state = init_train_state(torch.Generator().manual_seed(cfg.train.seed), cfg,
                                      self.device)
        # the steps' draws; on the training device, so a step never syncs
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.step_fn = make_train_step(cfg, img_hw, self.apply_fn)
        self.render_image = make_eval_render(cfg, n_rays_chunk=4096, apply_fn=self.apply_fn,
                                             device=self.device)
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self._device_ds: Optional[Tuple[Any, torch.Tensor, torch.Tensor]] = None
        self._multi_step_cache: Dict[int, Any] = {}
        self._graph_pool = None
        self.sampler_blocked_s = 0.0

    def _multi_step_fn(self, k: int):
        """``make_multi_train_step`` of ``k`` steps, made once per ``k`` (on
        the card each holds its CUDA graph, all of them in one memory pool:
        the trainer replays them one at a time)."""
        fn = self._multi_step_cache.get(k)
        if fn is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            fn = self._multi_step_cache[k] = make_multi_train_step(
                self.cfg, self.img_hw, k, self.apply_fn, self._graph_pool)
        return fn

    # -- checkpointing ------------------------------------------------------

    def save_checkpoint(self, name: str) -> str:
        path = os.path.join(self.cfg.checkpoint_dir, name)
        if not path.endswith(".npz"):
            path += ".npz"
        state = checkpoint_state(self.state)
        meta = {
            "config": self.cfg.to_dict(),
            "train_losses": self.train_losses,
            "val_losses": self.val_losses,
            "step": self.state.step,
        }
        ckpt.save_checkpoint(path, state, meta)
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore params, Adam moments and counts from a trainer checkpoint
        of either package; the file's leaves must match this trainer's."""
        state, meta = ckpt.restore_checkpoint(path)
        own = tree_leaves(self.state.params)
        opt = self.state.optimizer
        loaded = []
        for name in ("params", "mu", "nu"):
            got = dict(tree_leaves(params_from_numpy(state[name], self.device)))
            for tpath, leaf in own:
                if tpath not in got or got[tpath].shape != leaf.shape:
                    raise KeyError(f"checkpoint {path} does not match the model at "
                                   f"{name} {tpath}")
            loaded.append([got[tpath] for tpath, _ in own])
        # in place, as a captured step (make_multi_train_step) reads and
        # writes these tensors at their addresses
        with torch.no_grad():
            for leaves, values in zip(([leaf for _, leaf in own], opt.mu, opt.nu), loaded):
                for leaf, value in zip(leaves, values):
                    leaf.copy_(value)
        opt.set_count(state["count"])
        self.state.step = state["step"]
        self.train_losses = list(meta.get("train_losses", []))
        self.val_losses = list(meta.get("val_losses", []))

    def try_resume(self) -> Optional[str]:
        """Resume from the newest readable checkpoint. A corrupt or
        truncated file (a run cut mid-write on a filesystem without atomic
        rename) is skipped and the next-newest is tried."""
        tried = set()
        while True:
            latest = ckpt.find_latest_checkpoint(self.cfg.checkpoint_dir, exclude=tried)
            if latest is None:
                return None
            try:
                self.load_checkpoint(latest)
                return latest
            except Exception as e:   # whatever a torn file raises: keep resuming
                print(f"checkpoint {latest} unreadable ({e!r}); trying older")
                tried.add(latest)

    # -- loops --------------------------------------------------------------

    def _device_dataset(self, dataset) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images [N, H, W, 3] and poses [N, 4, 4] as device tensors, uploaded
        once: a per-step host-to-device copy of an 800x800 image (7.7 MB)
        would otherwise stand beside an O(n_rays) step."""
        cached = self._device_ds
        if cached is None or cached[0] is not dataset or cached[1].shape[0] != len(dataset):
            images = torch.as_tensor(np.asarray(dataset.images, np.float32), device=self.device)
            poses = torch.as_tensor(np.asarray(dataset.poses, np.float32), device=self.device)
            cached = self._device_ds = (dataset, images, poses)
        return cached[1], cached[2]

    def train_epoch(self, dataset, inner: Optional[int] = None) -> float:
        """One pass over the dataset, one step per image, in chunks of
        ``inner`` images (default 10, at most the dataset's size): a chunk
        of one is ``step_fn``, a longer one ``make_multi_train_step``'s (on
        the card one CUDA graph of its steps). Returns the mean loss of the
        epoch's steps, read once. (The JAX trainer returns the mean of the
        chunks' means, the same where the chunks are of one size.)"""
        images, poses = self._device_dataset(dataset)
        focal = float(dataset.focal)
        n = images.shape[0]
        inner = min(inner if inner is not None else 10, n)
        losses = []
        for i in range(0, n, inner):
            k = min(inner, n - i)
            if k == 1:
                m = self.step_fn(self.state, images[i], poses[i], focal, self.generator)
                losses.append(m["loss"][None])
            else:
                m = self._multi_step_fn(k)(self.state, images[i:i + k], poses[i:i + k], focal,
                                           self.generator)
                losses.append(m["loss"])
        return float(torch.cat(losses).mean())

    def train_streaming(self, dataset, n_steps: int, log_every: int = 100,
                        log_fn=print) -> float:
        """Train from the port's background ray producer
        (``runtime.RayBatchSampler``, C++ on a host thread, seeded with
        ``train.seed``): shuffled ray batches are assembled on the host while
        the card runs the previous step, one ``make_ray_train_step`` step a
        batch on the trainer's generator. On the card each batch goes up
        through one of two pinned host buffers in turn, copied without
        blocking; a buffer is refilled only after its last copy has ended.
        The loss is read at the log points, and after the last step only if
        no step was one. Returns the last logged loss, or the last step's
        where none was logged (appended to ``train_losses``);
        ``sampler_blocked_s`` is the time spent waiting in ``next_batch``."""
        from nerf_tpu_torch.runtime import RayBatchSampler

        step_fn = make_ray_train_step(self.cfg, self.apply_fn)
        n_rays = self.cfg.train.n_rays
        on_card = self.device.type == "cuda"
        staging = [torch.empty(3, n_rays, 3, pin_memory=on_card) for _ in range(2)]
        copied: List[Optional[torch.cuda.Event]] = [None, None]
        last, metrics = float("nan"), None
        with RayBatchSampler(dataset.images, dataset.poses, dataset.focal, n_rays=n_rays,
                             seed=self.cfg.train.seed) as sampler:
            for i in range(n_steps):
                buf = staging[i % 2]
                if copied[i % 2] is not None:
                    copied[i % 2].synchronize()
                for dst, src in zip(buf.numpy(), sampler.next_batch()):
                    dst[...] = src
                rays_o, rays_d, rgb = buf.to(self.device, non_blocking=True)
                if on_card:
                    copied[i % 2] = torch.cuda.Event()
                    copied[i % 2].record()
                metrics = step_fn(self.state, rays_o, rays_d, rgb, self.generator)
                if (i + 1) % log_every == 0:
                    last = float(metrics["loss"])
                    log_fn(f"step {i + 1}/{n_steps} loss={last:.6f}")
            self.sampler_blocked_s = sampler.blocked_s
        if last != last and metrics is not None:   # no log point hit: read once at the end
            last = float(metrics["loss"])
        self.train_losses.append(last)
        return last

    def validate(self, dataset) -> float:
        n = min(len(dataset), self.cfg.train.max_val_images)
        mses = []
        for i in range(n):
            item = dataset[i]
            rgb, _ = self.render_image(self.state.params, item["pose"], self.img_hw,
                                       float(dataset.focal))
            image = torch.as_tensor(item["image"], device=self.device)
            mses.append(float(torch.mean((rgb - image) ** 2)))
        return float(np.mean(mses)) if mses else float("nan")

    def train(self, train_ds, val_ds=None, n_epochs: Optional[int] = None,
              resume: bool = True, log_fn=print) -> None:
        n_epochs = n_epochs if n_epochs is not None else self.cfg.train.n_epochs
        start_epoch = 0
        if resume:
            latest = self.try_resume()
            if latest:
                start_epoch = len(self.train_losses)
                log_fn(f"resumed from {latest} at epoch {start_epoch}")

        for epoch in range(start_epoch, n_epochs):
            t0 = time.perf_counter()
            loss = self.train_epoch(train_ds)
            self.train_losses.append(loss)
            dt = time.perf_counter() - t0
            msg = f"epoch {epoch + 1}/{n_epochs} loss={loss:.6f} ({dt:.2f}s)"

            if val_ds is not None and (epoch + 1) % self.cfg.train.val_frequency == 0:
                val_mse = self.validate(val_ds)
                self.val_losses.append(val_mse)
                msg += (f" val_mse={val_mse:.6f} "
                        f"val_psnr={float(psnr_from_mse(val_mse)):.2f}dB")

            log_fn(msg)
            if (epoch + 1) % self.cfg.train.checkpoint_frequency == 0:
                path = self.save_checkpoint(f"checkpoint_epoch_{epoch + 1}.npz")
                log_fn(f"saved {path}")

    def plot_losses(self, out_path: Optional[str] = None) -> Optional[str]:
        """Loss-curve PNG."""
        if not self.train_losses:
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out_path = out_path or os.path.join(self.cfg.output_dir, "training_losses.png")
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(self.train_losses, label="train loss")
        if self.val_losses:
            xs = np.linspace(0, len(self.train_losses), len(self.val_losses) + 1)[1:]
            ax.plot(xs, self.val_losses, "o-", label="val mse")
        ax.set_xlabel("epoch")
        ax.set_ylabel("MSE")
        ax.set_yscale("log")
        ax.legend()
        ax.set_title("NeRF training")
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
