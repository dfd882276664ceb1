"""Execution engines: the same weights through different execution methods.

Counterpart of ``nerf_tpu/render/engines.py`` for its two render modes:
``benchmark`` (fine network only, ``samples_per_ray`` uniform unperturbed
samples) and ``hierarchical`` (coarse network at ``rcfg.n_coarse`` uniform
depths, ``rcfg.n_fine`` inverse-CDF depths from its weights, fine network
at the merged, sorted ``n_coarse + n_fine`` depths):

- ``torch`` (``TorchEngine``, the ``XLAEngine`` counterpart): plain PyTorch,
  ``sample_points_on_rays`` -> ``apply_nerf`` -> ``volume_render``, and
  ``render_rays`` for the hierarchical mode;
- ``cuda`` (``CudaEngine``, the ``PallasEngine`` counterpart): the fused
  ray kernels (``ops/render_kernel.py``: K1 at uniform depths, K3 at per-ray
  depths) write interleaved per-sample ``(sigma, r, g, b)`` and the
  compositor kernel (``ops/composite_kernel.py``, K2) reduces it per ray;
  with ``fuse_composite=True`` the ray kernels composite in the same pass.
  ``sample_pdf``, the merge and the sort between the passes are plain
  PyTorch. The hierarchical mode with ``use_importance=False`` (a uniform
  fine pass) goes through ``render_rays`` with the per-sample MLP kernel
  (``ops/mlp_kernel.fused_nerf_apply``, K4) and the planar compositor
  (``fused_volume_render``, K6). ``raw_dtype="bfloat16"`` stores the
  interleaved intermediate in bfloat16; ``planar=True`` has the ray kernels
  write four ``[R, S]`` planes for the planar compositor instead. On the CPU
  (tests) the kernels run their plain versions; on the card they launch the
  CUDA kernels;
- ``compressed`` (``CompressedEngine``): the cuda engine's paths on pruned,
  int8- or int16-quantized weights (``ops/quant.quantize_model``), which the
  ray kernels dequantize on chip; its per-sample ``apply_fn`` is the
  dequantize-in-kernel MLP (``quantized_nerf_apply``, K7);
- ``int8`` (``Int8ComputeEngine``): the compressed engine with ``act_bits=8``:
  the trunk's products run as s8 x s8 -> s32 on the tensor cores (K8);
- ``accel`` (``AccelEngine``): the cuda engine whose benchmark mode places
  its depths from an occupancy grid (``ops/occupancy.py``), baked once
  through K4: ``grid_guided_z_vals`` -> K3 -> K2 (composited K3 with
  ``fuse_composite``).

``ENGINE_CLASSES`` and ``available_engines`` are the registry of these five,
named as the JAX package's (``torch`` and ``cuda`` for ``xla`` and
``pallas``); each says in ``description`` which kernels it runs on the card,
and ``device_info()`` labels its benchmark rows. A frame is cut into chunks
of ``chunk_rays`` rays; the last chunk is padded with rays of zero origin
and direction ``(1, 1, 1)`` so every chunk has one shape.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nerf_tpu_torch.config import Config, RenderConfig, default_config
from nerf_tpu_torch.models.nerf import (
    NeRFParams,
    apply_nerf,
    init_nerf_params,
    load_bmild_weights,
    params_from_numpy,
    params_from_torch_state_dict,
)
from nerf_tpu_torch.ops.composite_kernel import (
    fused_volume_render,
    fused_volume_render_interleaved,
)
from nerf_tpu_torch.ops.mlp_kernel import make_cuda_apply_fn, pack_params
from nerf_tpu_torch.ops.occupancy import (
    OccupancyGrid,
    build_occupancy_grid,
    downsample_grid,
    grid_guided_z_vals,
)
from nerf_tpu_torch.ops.quant import make_quantized_apply_fn, quantize_model
from nerf_tpu_torch.ops.render_kernel import (
    composited_to_outputs,
    fused_render_samples,
    fused_render_samples_composited,
    fused_render_zvals_composited,
    fused_render_zvals_planar,
    fused_render_zvals_raw,
)
from nerf_tpu_torch.render.pipeline import render_rays
from nerf_tpu_torch.train.checkpoint import (
    has_checkpoint_meta,
    restore_bare_params,
    restore_checkpoint,
)
from nerf_tpu_torch.utils.cameras import BENCHMARK_FOCAL, generate_rays
from nerf_tpu_torch.utils.device import resolve_device, torch_dtype
from nerf_tpu_torch.utils.monitor import PerformanceMonitor, PerfStats, device_info_string
from nerf_tpu_torch.utils.rendering import sample_pdf, sample_points_on_rays, volume_render


class SharedModel:
    """The one set of weights every engine renders with: ``params`` is
    ``{'coarse': ..., 'fine': ...}`` on ``device``."""

    def __init__(self, cfg: Optional[Config] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else default_config()
        self.params: Optional[Dict[str, NeRFParams]] = None

    def load(self, checkpoint_path: Optional[str] = None, seed: int = 0) -> "SharedModel":
        """Load a reference-format torch ``.pth``, bmild ``.npy`` weights, a
        keystr params ``.npz`` or a trainer checkpoint ``.npz`` of either
        package (its params; the optimizer state is not read); for a missing
        path, random weights from ``seed`` (with a warning, as the JAX
        package does)."""
        cfg, dev = self.cfg, self.device
        if checkpoint_path and checkpoint_path.endswith((".pth", ".pt")):
            ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
            self.params = {
                "coarse": params_from_torch_state_dict(ckpt["coarse_model"], cfg.model, dev),
                "fine": params_from_torch_state_dict(ckpt["fine_model"], cfg.model, dev),
            }
        elif checkpoint_path and checkpoint_path.endswith(".npy"):
            fine = load_bmild_weights(checkpoint_path, dev)
            coarse_path = checkpoint_path.replace("model_fine_", "model_")
            coarse = (load_bmild_weights(coarse_path, dev)
                      if coarse_path != checkpoint_path and os.path.exists(coarse_path)
                      else fine)
            self.params = {"coarse": coarse, "fine": fine}
        elif checkpoint_path and os.path.exists(checkpoint_path):
            if has_checkpoint_meta(checkpoint_path):
                tree = restore_checkpoint(checkpoint_path)[0]["params"]
            else:
                tree = restore_bare_params(checkpoint_path)
            params = params_from_numpy(tree, dev)
            self.params = {"coarse": params["coarse"], "fine": params["fine"]}
        else:
            if checkpoint_path:
                warnings.warn(f"checkpoint {checkpoint_path} not found; using "
                              f"randomly initialized weights (seed {seed})")
            g = torch.Generator().manual_seed(seed)
            self.params = {"coarse": init_nerf_params(g, cfg.model, dev),
                           "fine": init_nerf_params(g, cfg.model, dev)}
        return self


@dataclass
class RenderResult:
    rgb: np.ndarray      # [H, W, 3]
    depth: np.ndarray    # [H, W]
    stats: PerfStats


class Engine:
    """One execution method; subclasses implement ``render_chunk``."""

    name = "base"
    description = "abstract"

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384):
        if shared is None:
            shared = SharedModel().load()
        self.shared = shared
        self.cfg = shared.cfg
        self.device = shared.device
        self.chunk_rays = chunk_rays
        self.compute_dtype = torch_dtype(self.cfg.train.compute_dtype)
        self._warmed: set = set()

    def device_info(self) -> str:
        return device_info_string(self.device)

    def engine_params(self):
        if self.shared.params is None:
            raise RuntimeError("call SharedModel.load first")
        return self.shared.params

    def render_chunk(self, params, ro: torch.Tensor, rd: torch.Tensor, spp: int,
                     rcfg: RenderConfig, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(rgb [N, 3], depth [N])`` for one chunk of rays."""
        raise NotImplementedError

    def _render(self, params, pose, width, height, focal, spp, chunk, rcfg, mode):
        n = width * height
        n_pad = -(-n // chunk) * chunk
        ro, rd = generate_rays(pose, width, height, focal, self.device)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        if n_pad != n:
            ro = torch.cat([ro, ro.new_zeros(n_pad - n, 3)])
            rd = torch.cat([rd, rd.new_ones(n_pad - n, 3)])
        outs = [self.render_chunk(params, ro[i:i + chunk], rd[i:i + chunk], spp, rcfg,
                                  mode)
                for i in range(0, n_pad, chunk)]
        rgb = torch.cat([o[0] for o in outs])[:n].reshape(height, width, 3)
        depth = torch.cat([o[1] for o in outs])[:n].reshape(height, width)
        return rgb, depth

    def render_image(
        self,
        pose,
        resolution: Tuple[int, int],
        samples_per_ray: int = 64,
        focal: float = BENCHMARK_FOCAL,
        mode: str = "benchmark",
        monitor: bool = True,
    ) -> RenderResult:
        """Render one view. The hierarchical mode ignores ``samples_per_ray``
        and takes ``rcfg.n_coarse`` and ``rcfg.n_fine``."""
        if mode not in ("benchmark", "hierarchical"):
            raise ValueError(f"unknown render mode {mode}")
        width, height = resolution
        chunk = min(self.chunk_rays, width * height)
        rcfg = self.cfg.render
        params = self.engine_params()
        args = (params, pose, width, height, focal, samples_per_ray, chunk, rcfg, mode)

        mon = PerformanceMonitor(self.device) if monitor else None
        if mon:
            # one untimed frame per (mode, spp, chunk): the first CUDA call
            # of each kernel builds and loads it
            key = (mode, samples_per_ray, chunk)
            if key not in self._warmed:
                self._render(*args)
                self._warmed.add(key)
            mon.start()
        rgb, depth = self._render(*args)
        stats = mon.stop() if mon else PerfStats()
        return RenderResult(rgb=rgb.cpu().numpy(), depth=depth.cpu().numpy(),
                            stats=stats)


class TorchEngine(Engine):
    name = "torch"
    description = "plain PyTorch: apply_nerf and volume_render, no kernel of the port"

    def render_chunk(self, params, ro, rd, spp, rcfg, mode):
        if mode == "hierarchical":
            res = render_rays(params["coarse"], params["fine"], ro, rd, self.cfg.model,
                              rcfg, compute_dtype=self.compute_dtype)
            return res.fine.rgb, res.fine.depth
        pts, z = sample_points_on_rays(ro, rd, rcfg.near, rcfg.far, spp)
        dirs = rd[:, None, :].expand(pts.shape)
        sigma, rgb = apply_nerf(params["fine"], pts, dirs, self.cfg.model,
                                compute_dtype=self.compute_dtype)
        out = volume_render(sigma, rgb, z, rd, rcfg)
        return out.rgb, out.depth


class CudaEngine(Engine):
    """The kernels' engine. Benchmark mode: K1 -> K2, or K1 composited with
    ``fuse_composite``. Hierarchical mode: K1 (coarse) -> K2 (weights) ->
    ``sample_pdf`` -> sort -> K3 (fine) -> K2, or with ``fuse_composite``
    K1 composited with weights -> ``sample_pdf`` -> sort -> K3 composited.
    ``raw_dtype="bfloat16"``: K1 and K3 store the interleaved intermediate in
    bfloat16 and K2 reads it. ``planar=True`` (which switches
    ``fuse_composite`` off, as in the JAX package): K1 and K3 write planes,
    composited by K6. Hierarchical mode with ``use_importance=False``:
    ``render_rays`` on uniform coarse and fine depths with K4 and K6."""

    name = "cuda"
    description = ("Hopper ray kernel K1 (K3 at per-ray depths) -> compositor K2; "
                   "uniform hierarchical K4 -> K6")

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384,
                 fuse_composite: bool = False, planar: bool = False,
                 raw_dtype: str = "float32"):
        super().__init__(shared, chunk_rays)
        self.planar = planar
        self.fuse_composite = fuse_composite and not planar
        self.raw_dtype = torch_dtype(raw_dtype)
        self._packed = None
        self._apply = make_cuda_apply_fn(self.compute_dtype)   # K4, on packed weights

    def engine_params(self):
        """Both networks packed for the ray kernels (once if they are the
        same weights), again whenever ``shared.params`` holds other
        networks than those last packed: the frame follows
        ``SharedModel.load``, as ``PallasEngine``'s does."""
        params = super().engine_params()
        source = (params, params["coarse"], params["fine"])
        if self._packed is None or any(a is not b for a, b in zip(self._packed[0], source)):
            fine = pack_params(params["fine"], self.cfg.model, self.compute_dtype)
            coarse = (fine if params["coarse"] is params["fine"] else
                      pack_params(params["coarse"], self.cfg.model, self.compute_dtype))
            self._packed = (source, {"coarse": coarse, "fine": fine})
        return self._packed[1]

    def _uniform(self, packed, ro, rd, spp, rcfg, with_weights):
        """One network at uniform depths: ``(RenderOutputs, z)``."""
        mcfg, dt = self.cfg.model, self.compute_dtype
        if self.fuse_composite:
            res = fused_render_samples_composited(
                packed, ro, rd, rcfg.near, rcfg.far, spp, mcfg, dtype=dt,
                with_weights=with_weights, sentinel=rcfg.dist_sentinel,
                eps=rcfg.transmittance_eps)
            out8, w, z = res if with_weights else (res[0], None, res[1])
            return composited_to_outputs(out8, w, rcfg), z
        if self.planar:
            sigma, planes, z = fused_render_samples(packed, ro, rd, rcfg.near, rcfg.far, spp,
                                                    mcfg, dtype=dt, planar=True)
            return fused_volume_render(sigma, planes, z, rd, rcfg), z
        raw, z = fused_render_samples(packed, ro, rd, rcfg.near, rcfg.far, spp, mcfg,
                                      raw=True, dtype=dt, raw_dtype=self.raw_dtype)
        return fused_volume_render_interleaved(raw, z, rd, rcfg), z

    def render_chunk(self, packed, ro, rd, spp, rcfg, mode):
        if mode == "benchmark":
            out, _ = self._uniform(packed["fine"], ro, rd, spp, rcfg, False)
            return out.rgb, out.depth
        if not rcfg.use_importance:
            res = render_rays(packed["coarse"], packed["fine"], ro, rd, self.cfg.model, rcfg,
                              apply_fn=self._apply, composite_fn=fused_volume_render)
            return res.fine.rgb, res.fine.depth
        out_c, z_c = self._uniform(packed["coarse"], ro, rd, rcfg.n_coarse, rcfg, True)
        z_new = sample_pdf(z_c, out_c.weights, rcfg.n_fine, deterministic=True)
        z_f = torch.sort(torch.cat([z_c, z_new], dim=-1), dim=-1).values
        return self._at_depths(packed["fine"], ro, rd, z_f, rcfg)

    def _at_depths(self, packed, ro, rd, z, rcfg):
        """One network at per-ray depths ``z [N, S]`` (K3), composited:
        ``(rgb, depth)``."""
        mcfg, dt = self.cfg.model, self.compute_dtype
        if self.fuse_composite:
            out8 = fused_render_zvals_composited(
                packed, ro, rd, z, mcfg, dtype=dt, sentinel=rcfg.dist_sentinel,
                eps=rcfg.transmittance_eps)
            out = composited_to_outputs(out8, None, rcfg)
        elif self.planar:
            sigma, planes = fused_render_zvals_planar(packed, ro, rd, z, mcfg, dtype=dt)
            out = fused_volume_render(sigma, planes, z, rd, rcfg)
        else:
            raw = fused_render_zvals_raw(packed, ro, rd, z, mcfg, dtype=dt,
                                         raw_dtype=self.raw_dtype)
            out = fused_volume_render_interleaved(raw, z, rd, rcfg)
        return out.rgb, out.depth


class CompressedEngine(CudaEngine):
    """The cuda engine on pruned, intN-quantized weights. The ray kernels
    take the quantized weights as they are and dequantize them on chip
    (int8 weights are a quarter, int16 half of float32's bytes); the
    per-sample path (``use_importance=False``) runs ``quantized_nerf_apply``
    (K7)."""

    name = "compressed"
    description = "pruned intN weights dequantized inside K1/K3 (K7 per sample) -> K2"

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384,
                 bits: int = 8, prune_fraction: float = 0.1,
                 act_bits: Optional[int] = None, pos_bound: float = 12.0, **kw):
        super().__init__(shared, chunk_rays, **kw)
        self.bits = bits
        self.prune_fraction = prune_fraction
        self.act_bits = act_bits
        self.pos_bound = pos_bound
        self._qparams = None
        self._stats: Optional[Dict[str, Any]] = None
        self._apply = make_quantized_apply_fn(self.compute_dtype)   # K7

    def engine_params(self):
        """Both networks quantized once, lazily, from the float32 params
        (pruned, packed in float32, then quantized)."""
        if self._qparams is None:
            self._qparams, self._stats = quantize_model(
                Engine.engine_params(self), self.cfg.model, bits=self.bits,
                prune_fraction=self.prune_fraction, act_bits=self.act_bits,
                pos_bound=self.pos_bound)
        return self._qparams

    def compression_stats(self) -> Dict[str, Any]:
        self.engine_params()
        return self._stats


class Int8ComputeEngine(CompressedEngine):
    """int8 compute: the trunk's products run as s8 x s8 -> s32 tensor-core
    products with quantized activations; the heads stay in bf16."""

    name = "int8"
    description = "int8 compute: s8 x s8 -> s32 trunk inside K1/K3 (K8) -> K2"

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384, **kw):
        kw.setdefault("act_bits", 8)
        super().__init__(shared, chunk_rays, **kw)


class AccelEngine(CudaEngine):
    """Occupancy-grid sample placement (empty-space skipping): the cuda
    engine whose benchmark mode places its ``samples_per_ray`` depths per
    ray from a grid baked once, lazily (in the first frame, the untimed
    warm frame under the monitor), from the fine network: ``grid_guided_z_vals``
    -> K3 -> K2, or the composited K3 with ``fuse_composite``. The bake
    evaluates ``relu(sigma)`` at every cell centre through K4 on the packed
    fine network in bfloat16, whatever ``compute_dtype`` says (the JAX
    engine's bake is bfloat16 too). The hierarchical mode is the cuda
    engine's. Scene constants come from ``cfg.accel``; the constructor's
    arguments override them."""

    name = "accel"
    description = "occupancy grid baked through K4 once; grid-guided depths -> K3 -> K2"

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384,
                 grid_resolution: Optional[int] = None,
                 density_threshold: Optional[float] = None,
                 aabb: Optional[Tuple[float, float]] = None,
                 n_probe: Optional[int] = None,
                 probe_resolution: Optional[int] = None,
                 probe_ray_stride: Optional[int] = None,
                 grid_store: Optional[str] = None,
                 weight_mode: Optional[str] = None, **kw):
        super().__init__(shared, chunk_rays, **kw)
        acfg = self.cfg.accel
        self.grid_resolution = grid_resolution or acfg.grid_resolution
        self.density_threshold = (acfg.density_threshold if density_threshold is None
                                  else density_threshold)
        self.aabb = tuple(aabb if aabb is not None else acfg.aabb)
        self.n_probe = n_probe or acfg.n_probe
        self.probe_resolution = (acfg.probe_resolution if probe_resolution is None
                                 else probe_resolution)
        self.probe_ray_stride = (acfg.probe_ray_stride if probe_ray_stride is None
                                 else probe_ray_stride)
        self.grid_store = grid_store or acfg.grid_store
        self.weight_mode = weight_mode or acfg.weight_mode
        self._grid: Optional[OccupancyGrid] = None

    def occupancy_grid(self) -> OccupancyGrid:
        """The grid the depths are placed from, baked on the first call:
        the dilated mip when ``0 < probe_resolution < grid_resolution``."""
        if self._grid is None:
            fine = self.engine_params()["fine"]
            if fine.w0.dtype != torch.bfloat16:
                fine = pack_params(self.shared.params["fine"], self.cfg.model, torch.bfloat16)
            grid = build_occupancy_grid(
                fine, self.cfg.model, resolution=self.grid_resolution, aabb=self.aabb,
                density_threshold=self.density_threshold,
                apply_fn=make_cuda_apply_fn(torch.bfloat16), store=self.grid_store)
            if self.probe_resolution and self.probe_resolution < grid.resolution:
                grid = downsample_grid(grid, grid.resolution // self.probe_resolution)
            self._grid = grid
        return self._grid

    def render_chunk(self, packed, ro, rd, spp, rcfg, mode):
        if mode != "benchmark":
            return super().render_chunk(packed, ro, rd, spp, rcfg, mode)
        z = grid_guided_z_vals(self.occupancy_grid(), ro, rd, rcfg.near, rcfg.far, spp,
                               n_probe=self.n_probe, ray_stride=self.probe_ray_stride,
                               weight_mode=self.weight_mode)
        return self._at_depths(packed["fine"], ro, rd, z, rcfg)


ENGINE_CLASSES = {
    "torch": TorchEngine,
    "cuda": CudaEngine,
    "compressed": CompressedEngine,
    "int8": Int8ComputeEngine,
    "accel": AccelEngine,
}


def available_engines(shared: SharedModel, names=None) -> Dict[str, Engine]:
    """The probed registry: an engine whose constructor fails is skipped,
    with a message, rather than ending the run."""
    engines = {}
    for name, cls in ENGINE_CLASSES.items():
        if names is not None and name not in names:
            continue
        try:
            engines[name] = cls(shared)
        except Exception as e:
            print(f"engine {name} unavailable: {e}")
    return engines
