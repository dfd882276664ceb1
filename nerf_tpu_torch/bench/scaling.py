"""Scaling report: rays/s against the number of devices a frame is split over.

Counterpart of ``nerf_tpu/bench/scaling.py``. A frame's rays are split into
``nd`` contiguous, padded shards; each shard renders on its device with the
single-device code (``sample_points_on_rays`` -> the MLP -> ``volume_render``;
the MLP is K4, ``ops/mlp_kernel``, on a CUDA device at the architecture it
serves, ``apply_nerf`` elsewhere). Every shard is launched before one
synchronisation of each device that holds a shard (``monitor.sync``), and
the frame is stitched on the host from the shards by
``runtime.assemble_tiles``, outside the timed window. In a process
group each rank renders the shards it owns (shard ``i``: rank ``i % world``)
and rank 0 gathers the tiles and stitches them.

``devices`` may name one device more than once, one shard each: that is how
the CPU tests and one card play the JAX package's virtual devices. Such a
row's efficiency is no scaling number, and its log line says so
(``ScalingRow.distinct_devices``). No scaling number has been measured on
one H100.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.bench.suite import write_png
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.models.nerf import apply_nerf
from nerf_tpu_torch.parallel.mesh import rank_device
from nerf_tpu_torch.utils.cameras import generate_rays
from nerf_tpu_torch.utils.device import torch_dtype
from nerf_tpu_torch.utils.monitor import sync
from nerf_tpu_torch.utils.rendering import sample_points_on_rays, volume_render
from nerf_tpu_torch.utils.tree import tree_from_leaves, tree_leaves


@dataclass
class ScalingRow:
    n_devices: int
    render_time_s: float
    rays_per_second: float
    efficiency: float     # vs linear scaling from the first row
    distinct_devices: bool = True   # False: a device holds several shards


class ShardedRows(NamedTuple):
    """A ray-sharded output: the tiles this process holds, each on its
    device, their first rows in the whole batch, and the batch's rows."""
    tiles: List[torch.Tensor]
    offsets: List[int]
    n_rows: int


def _world() -> Tuple[int, int]:
    return (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)


def assemble_frame(rgb_global: ShardedRows, depth_global: ShardedRows, n_rays: int,
                   resolution: Tuple[int, int]) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Stitch a ray-sharded render into host images ``(rgb [H, W, 3], depth
    [H, W])`` with the native tile stitcher (``runtime.assemble_tiles``), one
    tile a shard. In a process group rank 0 gathers every rank's tiles and
    stitches them; the other ranks return None."""
    from nerf_tpu_torch.runtime import assemble_tiles

    w, h = resolution
    mine = [(off, rgb.cpu().numpy(), depth.cpu().numpy().reshape(-1, 1))
            for off, rgb, depth in zip(rgb_global.offsets, rgb_global.tiles, depth_global.tiles)]
    rank, world = _world()
    if world > 1:
        gathered = [None] * world if rank == 0 else None
        dist.gather_object(mine, gathered, dst=0)
        if rank != 0:
            return None
        mine = [tile for part in gathered for tile in part]
    offsets = [off for off, _, _ in mine]

    def stitch(tiles, channels):
        return assemble_tiles(tiles, offsets, rgb_global.n_rows, channels)[:n_rays]

    rgb = stitch([t for _, t, _ in mine], 3).reshape(h, w, 3)
    depth = stitch([t for _, _, t in mine], 1).reshape(h, w)
    return rgb, depth


def _default_apply_fn(cfg: Config, dev: torch.device):
    """K4 on a CUDA device at the architecture it serves, else apply_nerf."""
    m = cfg.model
    if (dev.type == "cuda" and m.hidden_dim == 256 and m.n_layers == 8
            and m.color_hidden_dim == 128):
        from nerf_tpu_torch.ops.mlp_kernel import make_cuda_apply_fn

        return make_cuda_apply_fn()
    return apply_nerf


def _make_sharded_render(params, cfg: Config, devices: Sequence, spp: int, apply_fn=None):
    """``render(rays_o, rays_d) -> (rgb, depth)`` as ``ShardedRows``: the
    rays (``[n, 3]``, ``n`` a multiple of ``len(devices)``) in
    ``len(devices)`` contiguous shards, shard ``i`` on ``devices[i]`` if this
    rank owns it. Launches every owned shard and returns without waiting."""
    devs = [torch.device(d) for d in devices]
    rank, world = _world()
    owned = [i for i in range(len(devs)) if i % world == rank]
    dt = torch_dtype(cfg.train.compute_dtype)
    rcfg = cfg.render
    paths, leaves = zip(*tree_leaves(params))
    on = {d: tree_from_leaves(paths, [x.detach().to(d) for x in leaves])
          for d in {devs[i] for i in owned}}
    fns = {d: apply_fn if apply_fn is not None else _default_apply_fn(cfg, d) for d in on}

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor) -> Tuple[ShardedRows, ShardedRows]:
        n = rays_o.shape[0]
        if n % len(devs):
            raise ValueError(f"{n} rays do not split into {len(devs)} shards")
        k = n // len(devs)
        rgbs, depths = [], []
        for i in owned:
            dev = devs[i]
            ro = rays_o[i * k:(i + 1) * k].to(dev, non_blocking=True)
            rd = rays_d[i * k:(i + 1) * k].to(dev, non_blocking=True)
            pts, z = sample_points_on_rays(ro, rd, rcfg.near, rcfg.far, spp)
            dirs = rd[:, None, :].expand(pts.shape)
            sigma, rgb = fns[dev](on[dev], pts, dirs, cfg.model, compute_dtype=dt)
            out = volume_render(sigma, rgb, z, rd, rcfg)
            rgbs.append(out.rgb)
            depths.append(out.depth)
        offsets = [i * k for i in owned]
        return ShardedRows(rgbs, offsets, n), ShardedRows(depths, offsets, n)

    return render


def scaling_report(
    params,
    cfg: Config,
    resolution: Tuple[int, int] = (800, 600),
    spp: int = 64,
    focal: float = 800.0,
    device_counts: Optional[Sequence[int]] = None,
    apply_fn=None,
    n_frames: int = 2,
    log=print,
    devices: Optional[Sequence] = None,
    frame_path: Optional[str] = None,
    device="cuda",
) -> List[ScalingRow]:
    """Render one frame split over the first ``nd`` of ``devices`` for each
    ``nd`` of ``device_counts`` (default: the powers of two up to their
    number): a warm frame, then ``n_frames`` timed between synchronisations
    (the slowest rank's time in a process group). ``devices`` defaults to
    one device a rank (``device``'s type: ``cuda:(rank % count)``, or the
    CPU). The last row's frame is stitched from its shards and, with
    ``frame_path``, written there as a PNG by rank 0."""
    rank, world = _world()
    devices = (list(devices) if devices is not None
               else [rank_device(r, device) for r in range(world)])
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    if max(device_counts) > len(devices):
        raise ValueError(f"need {max(device_counts)} devices, have {len(devices)}")
    own = rank_device(rank, device)

    w, h = resolution
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    rays_o, rays_d = generate_rays(pose, w, h, focal, own)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)

    rows: List[ScalingRow] = []
    frame = None
    base = None
    for nd in device_counts:
        pad = (-rays_o.shape[0]) % nd
        ro = torch.cat([rays_o, rays_o.new_zeros(pad, 3)]) if pad else rays_o
        rd = torch.cat([rays_d, rays_d.new_ones(pad, 3)]) if pad else rays_d
        shards = devices[:nd]
        render = _make_sharded_render(params, cfg, shards, spp, apply_fn)

        out = render(ro, rd)    # warm: builds the kernels, fills the caches
        sync(out)
        if world > 1:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n_frames):
            out = render(ro, rd)
        sync(out)
        t = (time.perf_counter() - t0) / n_frames
        if world > 1:              # the frame takes as long as its slowest rank
            slowest = torch.tensor([t], dtype=torch.float64, device=own)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
            t = float(slowest)

        rays_s = w * h / t
        eff = 1.0 if base is None else rays_s / (base * nd)
        if base is None:
            base = rays_s
        distinct = len({str(torch.device(d)) for d in shards}) == nd
        rows.append(ScalingRow(nd, t, rays_s, eff, distinct))
        log(f"  {nd} device(s): {t:.3f}s/frame  {rays_s:,.0f} rays/s  "
            f"efficiency {eff:.0%}"
            + ("" if distinct else "  (devices not distinct: not a scaling number)"))
        # image assembly from the shards' tiles, outside the timed window
        frame = assemble_frame(out[0], out[1], w * h, resolution)
    if frame_path is not None and frame is not None:
        rgb, _ = frame
        write_png(frame_path, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        log(f"  assembled frame (native tile stitch) -> {frame_path}")
    return rows
