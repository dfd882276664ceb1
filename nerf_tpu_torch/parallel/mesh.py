"""The (data, model) mesh over the ranks of a ``torch.distributed`` group.

Counterpart of ``nerf_tpu/parallel/mesh.py``. Where the JAX package lays
devices out on a ``jax.sharding.Mesh`` and lets XLA place the collectives,
the port runs one process a device and names the collectives itself:

- one JAX device is one rank; rank ``r`` computes on ``cuda:(r % count)``
  (or the CPU), and the ranks are laid out row-major over ``(data, model)``:
  ``rank = d * n_model + m``;
- the **data group** of a rank holds the ranks with its ``m``: they split a
  step's rays in contiguous blocks (``shard_rays``, ``ray_sharding``) and
  average their gradients;
- the **model group** holds the ranks with its ``d``: they split the
  trunk's and the bottleneck's hidden columns (``tp_param_shardings``).

With no process group a mesh is 1 x 1, with no groups, and every function
of ``parallel/`` is the single-device code with no collective. In a process
group every collective runs, a group of one included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nerf_tpu_torch.utils.device import resolve_device
from nerf_tpu_torch.utils.rendering import RayShard
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves


@dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, int]              # (n_data, n_model)
    coords: Tuple[int, int]             # this rank's (d, m)
    data_group: Optional[Any]           # ranks of this m (None: no process group)
    model_group: Optional[Any]          # ranks of this d
    device: torch.device                # this rank's device
    axis_names: ClassVar[Tuple[str, str]] = ("data", "model")

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of ``rank``: ``cuda:(rank % count)``, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device="cuda") -> Mesh:
    """(data, model) mesh of the process group's ranks (with none, 1 x 1).
    Default: every rank on the data axis. Every rank creates every
    subgroup, in the same order, as ``dist.new_group`` requires."""
    if not dist.is_initialized():
        if (n_data or 1) != 1 or n_model != 1:
            raise ValueError(f"a {n_data} x {n_model} mesh needs a process group")
        return Mesh((1, 1), (0, 0), None, None, resolve_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"{world} ranks not divisible by model={n_model}")
        n_data = world // n_model
    need = n_data * n_model
    if need > world:
        raise ValueError(f"need {need} ranks, have {world}")
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    if rank >= need:
        raise ValueError(f"rank {rank} is outside the {n_data} x {n_model} mesh")
    d, m = divmod(rank, n_model)
    return Mesh((n_data, n_model), (d, m), data_groups[m], model_groups[d],
                rank_device(rank, device))


def ray_sharding(mesh: Mesh) -> RayShard:
    """This rank's block of a batch's rows: the leading (ray) axis split over
    the data axis, everything trailing whole."""
    return RayShard(mesh.coords[0], mesh.shape[0])


def replicated(mesh: Mesh) -> RayShard:
    """The whole batch, the shard of a rank that holds every row."""
    return RayShard(0, 1)


def shard_rays(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous row block of ``x`` over the data axis; the rows
    must split evenly, as the JAX sharding requires."""
    n_data = mesh.shape[0]
    if x.shape[0] % n_data:
        raise ValueError(f"{x.shape[0]} rows do not split over {n_data} data ranks")
    return x[ray_sharding(mesh).rows(x.shape[0] // n_data)]


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Rank 0's values of ``tensors`` on every rank, in place (a broadcast
    from rank 0 of the world); without a process group, as they are."""
    if mesh.distributed:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=0)
    return tensors


def tp_param_shardings(params: Any, mesh: Mesh) -> Any:
    """The model-axis layout of a NeRF params tree (one net, or the
    ``{'coarse', 'fine'}`` dict), with the params' nesting: ``1`` for a trunk
    or bottleneck ``w`` (its output columns split over ``model``), ``0`` for
    their ``b``, ``None`` for the heads (whole on every rank). The JAX
    package's ``P(None, "model")``, ``P("model")`` and ``P()``."""

    def spec_for(path):
        names = [p for p in path if isinstance(p, str)]
        if "trunk" in names or "bottleneck" in names:
            return {"w": 1, "b": 0}.get(names[-1])
        return None

    paths = [p for p, _ in tree_leaves(params)]
    return tree_from_leaves(paths, [spec_for(p) for p in paths])
