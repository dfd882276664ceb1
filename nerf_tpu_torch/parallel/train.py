"""Sharded training over a ``torch.distributed`` mesh.

Counterpart of ``nerf_tpu/parallel/train.py``. The JAX package jits the
single-device step under a mesh and lets XLA derive the collectives; here
each rank runs the single-device step's code on its share and names two
collectives:

- **data axis**: a rank renders its contiguous block of the step's rays
  (``render_rays`` with its ``RayShard``: every draw is the whole batch's,
  from the generator every rank holds alike, so the shards together draw
  what the unsharded step draws). Its gradients of all leaves and its three
  losses are flattened into one buffer, all-reduced over the data group and
  divided by its size: one collective a step, the psum XLA inserts. The
  global-norm clip then reads the averaged full gradient, the same on every
  rank, and the metrics are the global ones.
- **model axis** (``tp=True``): a rank holds only its columns of every
  trunk and bottleneck leaf (``tp_param_shardings``), and Adam's ``mu`` and
  ``nu`` the same slices. The MLP's forward and backward are one fused
  kernel each over the whole network (K4, ``csrc/ray_wgmma.cu``; K5,
  ``csrc/mlp_backward_wgmma.cu``) and need whole weight matrices, so the
  step gathers the full leaves first (one all-reduce over the model group
  of a zero-filled buffer that holds each rank's columns in place: x + 0 is
  x, and gloo takes CUDA tensors in ``broadcast`` and ``all_reduce`` only),
  and the update keeps the rank's columns of the full gradient. The
  parameters and moments are held sharded; the compute is whole, as XLA
  gathers the operands of a custom call. The update is elementwise, so a
  1 x 2 mesh updates the same bits as one process.

On the card at the standard architecture each rank's MLP runs the kernels
(``default_train_apply_fn``: K4 forward, K5 backward), elsewhere
``apply_nerf``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from nerf_tpu_torch.config import Config
from nerf_tpu_torch.parallel.mesh import (
    Mesh,
    ray_sharding,
    rank_device,
    replicate,
    shard_rays,
    tp_param_shardings,
)
from nerf_tpu_torch.train.trainer import (
    TrainState,
    default_train_apply_fn,
    loss_fn,
    select_rays,
)
from nerf_tpu_torch.utils.device import resolve_device
from nerf_tpu_torch.utils.metrics import psnr_from_mse
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device="cuda") -> None:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator_address`` (``host:port``). A no-op for one
    process. The backend is ``backend``, else NCCL for a CUDA ``device`` and
    gloo for the CPU; on the card the rank's device (``cuda:(rank %
    count)``) is made current before the first collective. A failure
    raises: nothing changes backend or device on its own."""
    if num_processes is None or num_processes <= 1:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(process_id, dev))
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _leaf_specs(params, mesh: Mesh, tp: bool) -> List[Optional[int]]:
    """Per leaf (``tree_leaves`` order): the axis the model axis splits, or
    None (whole)."""
    specs = [spec for _, spec in tree_leaves(tp_param_shardings(params, mesh))]
    return specs if tp else [None] * len(specs)


def _local(x: torch.Tensor, axis: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's columns (``axis``) of a whole leaf, a tensor of its own;
    the leaf itself where it is whole (``axis`` None)."""
    if axis is None:
        return x
    n_model, m = mesh.shape[1], mesh.coords[1]
    if x.shape[axis] % n_model:
        raise ValueError(f"a leaf of shape {tuple(x.shape)} does not split over "
                         f"{n_model} model ranks on axis {axis}")
    k = x.shape[axis] // n_model
    return x.narrow(axis, m * k, k).clone(memory_format=torch.contiguous_format)


def _own(x: torch.Tensor, axis: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's part of a leaf as a tensor of its own: its columns, or
    a copy of the whole."""
    return _local(x.detach(), axis, mesh) if axis is not None else x.detach().clone()


def _gather(leaves: List[torch.Tensor], specs, mesh: Mesh) -> List[torch.Tensor]:
    """The whole leaves from each rank's columns: one all-reduce over the
    model group of a zero-filled buffer holding every split leaf's columns
    in place. Whole leaves come back as they are."""
    split = [i for i, a in enumerate(specs) if a is not None]
    if not split or not mesh.distributed:     # 1 x 1: every leaf is whole
        return list(leaves)
    n_model, m = mesh.shape[1], mesh.coords[1]
    shapes = []
    for i in split:
        shape = list(leaves[i].shape)
        shape[specs[i]] *= n_model
        shapes.append(shape)
    flat = torch.zeros(sum(torch.Size(s).numel() for s in shapes),
                       dtype=leaves[split[0]].dtype, device=leaves[split[0]].device)
    full = list(leaves)
    offset = 0
    for i, shape in zip(split, shapes):
        whole = flat[offset:offset + torch.Size(shape).numel()].view(shape)
        k = leaves[i].shape[specs[i]]
        whole.narrow(specs[i], m * k, k).copy_(leaves[i])
        full[i] = whole
        offset += whole.numel()
    dist.all_reduce(flat, group=mesh.model_group)
    return full


def shard_train_state(state: TrainState, mesh: Mesh, tp: bool = False) -> TrainState:
    """Place a train state on the mesh: rank 0's params and Adam moments on
    every rank (a broadcast, in place), and with ``tp`` each rank keeps only
    its columns of every leaf ``tp_param_shardings`` splits, its ``mu`` and
    ``nu`` the same columns (a replicated moment beside a split leaf would
    be a fault)."""
    opt = state.optimizer
    replicate(mesh, state.leaves() + opt.mu + opt.nu)
    if not tp:
        return state
    specs = _leaf_specs(state.params, mesh, tp)
    paths = [p for p, _ in tree_leaves(state.params)]
    with torch.no_grad():
        params = [_own(x, a, mesh) for x, a in zip(state.leaves(), specs)]
        sharded = copy.copy(opt)
        sharded.mu = [_own(x, a, mesh) for x, a in zip(opt.mu, specs)]
        sharded.nu = [_own(x, a, mesh) for x, a in zip(opt.nu, specs)]
        sharded.device_count = opt.device_count.clone()
    return TrainState(params=tree_from_leaves(paths, params), optimizer=sharded,
                      step=state.step)


def gather_train_state(state: TrainState, mesh: Mesh, tp: bool = False) -> TrainState:
    """The whole train state on every rank (params and moments gathered over
    the model axis; with ``tp=False`` the state itself), for a checkpoint
    (``trainer.checkpoint_state``)."""
    if not tp:
        return state
    specs = _leaf_specs(state.params, mesh, tp)
    paths = [p for p, _ in tree_leaves(state.params)]
    opt = state.optimizer
    with torch.no_grad():
        params = _gather(state.leaves(), specs, mesh)
        whole = copy.copy(opt)
        whole.mu = _gather(opt.mu, specs, mesh)
        whole.nu = _gather(opt.nu, specs, mesh)
        whole.device_count = opt.device_count.clone()
    return TrainState(params=tree_from_leaves(paths, params), optimizer=whole,
                      step=state.step)


def _average(tensors: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor averaged over the data group: one all-reduce of one
    flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.shape[0]
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _make_shard_update(cfg: Config, mesh: Mesh, apply_fn, tp: bool):
    """``update(state, rays_o, rays_d, target, generator) -> metrics`` on this
    rank's rows of the step's batch."""
    shard = ray_sharding(mesh)

    def update(state: TrainState, rays_o, rays_d, target, generator):
        paths = [p for p, _ in tree_leaves(state.params)]
        specs = _leaf_specs(state.params, mesh, tp)
        leaves = state.leaves()
        if tp:
            with torch.no_grad():
                leaves = [x.requires_grad_(True) for x in _gather(leaves, specs, mesh)]
        params = tree_from_leaves(paths, leaves)
        loss, (loss_c, loss_f) = loss_fn(params, cfg, rays_o, rays_d, target, generator,
                                         apply_fn, shard)
        grads = list(torch.autograd.grad(loss, leaves))
        losses = torch.stack([loss, loss_c, loss_f]).detach()
        if mesh.distributed:
            *grads, losses = _average(grads + [losses], mesh)
        opt = state.optimizer
        scale = opt.clip_scale(grads)
        opt.apply(state.leaves(), [_local(g, a, mesh) for g, a in zip(grads, specs)], scale)
        state.step += 1
        loss, loss_c, loss_f = losses
        return {"loss": loss, "loss_coarse": loss_c, "loss_fine": loss_f,
                "psnr": psnr_from_mse(loss_f)}

    return update


def _apply_fn_for(cfg: Config, mesh: Mesh, apply_fn):
    return apply_fn if apply_fn is not None else default_train_apply_fn(cfg, mesh.device)


def make_sharded_ray_train_step(cfg: Config, mesh: Mesh, apply_fn=None, tp: bool = False):
    """The sharded ``make_ray_train_step``: ``step_fn(state, rays_o, rays_d,
    target, generator=None) -> metrics`` on the step's whole batch, the same
    on every rank; each rank trains on its rows (``shard_rays``)."""
    update = _make_shard_update(cfg, mesh, _apply_fn_for(cfg, mesh, apply_fn), tp)

    def step_fn(state: TrainState, rays_o, rays_d, target, generator=None):
        return update(state, shard_rays(mesh, rays_o), shard_rays(mesh, rays_d),
                      shard_rays(mesh, target), generator)

    return step_fn


def make_sharded_train_step(cfg: Config, img_hw: Tuple[int, int], mesh: Mesh, apply_fn=None,
                            tp: bool = False):
    """The sharded ``make_train_step``: ``step_fn(state, image, pose, focal,
    generator) -> metrics``. Every rank passes the same image, pose, focal
    and generator state (replicated inputs) and a state from
    ``shard_train_state(..., tp)``; the state is updated in place, and the
    metrics are the step's global ones, equal on every rank."""
    update = _make_shard_update(cfg, mesh, _apply_fn_for(cfg, mesh, apply_fn), tp)
    shard = ray_sharding(mesh)

    def step_fn(state: TrainState, image, pose, focal, generator) -> Dict[str, torch.Tensor]:
        rays_o, rays_d, target = select_rays(image, pose, focal, generator, img_hw,
                                             cfg.train.n_rays, shard)
        return update(state, rays_o, rays_d, target, generator)

    return step_fn
