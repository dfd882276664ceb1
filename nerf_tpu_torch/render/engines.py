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
  compositor kernel (``ops/composite_kernel.py``, K2) reduces it per ray,
  writing its weights only where the coarse pass reads them;
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
  int8- or int16-quantized weights (``ops/quant.quantize_model``), which each
  kernel call dequantizes on chip once (``ops/dequant_stream.py``) for the
  bf16 ray kernels; its per-sample ``apply_fn`` is ``quantized_nerf_apply``
  (K7), dequantized the same way;
- ``int8`` (``Int8ComputeEngine``): the compressed engine with ``act_bits=8``:
  the trunk's products run as s8 x s8 -> s32 on the tensor cores (K8);
- ``accel`` (``AccelEngine``): the cuda engine whose benchmark mode places
  its depths from an occupancy grid (``ops/occupancy.py``), baked once
  through K4: ``grid_guided_z_vals`` -> K3 -> K2 (composited K3 with
  ``fuse_composite``).

The mip variant (``cfg.model.variant == "mip"``, ``models/mip.py``) takes
its own path by the variant alone, one network for both passes:
``TorchEngine`` runs ``render_mip_rays``; ``CudaEngine`` K1-mip at the
uniform intervals -> K2's edges form (with weights) -> ``mip_resample``
(span ``mip.resample``) -> K3-mip at the fine intervals -> K2's edges form,
at the frame's pixel radius (``utils/cameras.pixel_radius``, threaded from
``_render``). The compressed, int8 and accel engines, and ``planar`` or
``fuse_composite`` on the cuda engine, refuse it.

The mip360 variant (Mip-NeRF 360, ``models/mip360.py``; params ``coarse``
the proposal network, ``fine`` the NeRF network) also takes its own path,
in the hierarchical mode only: ``TorchEngine`` runs ``render_mip360_rays``;
``CudaEngine.mip360_passes`` runs each proposal level as ``resample_360``
(span ``mip360.resample``) -> the proposal entry of the ray kernels' body
(``render_kernel.fused_render_prop_mip360``) -> K2's opaque edges form
(weights), then the NeRF level as ``resample_360`` -> the NeRF pass
(``ops/mip360_kernel.nerf_mip360_raw``) -> K2's opaque edges form. The
engines that refuse the mip variant refuse it too.

``ENGINE_CLASSES`` and ``available_engines`` are the registry of these five,
named as the JAX package's (``torch`` and ``cuda`` for ``xla`` and
``pallas``); each says in ``description`` which kernels it runs on the card,
and ``device_info()`` labels its benchmark rows. A frame is cut into chunks
of ``chunk_rays`` rays; the last chunk is padded with rays of zero origin
and direction ``(1, 1, 1)`` so every chunk has one shape. Under a profiler
a frame records the spans ``engine.rays`` (the rays and the padding), one
``engine.chunk`` a chunk, ``engine.assemble`` (the image from the chunks)
and ``engine.to_host`` (``utils/monitor.span``); the accel engine's chunk
records ``occupancy.z_vals`` around its depth placement.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nerf_tpu_torch.config import Config, RenderConfig, default_config
from nerf_tpu_torch.models.mip import render_mip_rays
from nerf_tpu_torch.models.mip360 import (
    init_mip360_params,
    level_sizes,
    render_mip360_rays,
    resample_360,
)
from nerf_tpu_torch.models.nerf import (
    NeRFParams,
    apply_nerf,
    init_nerf_params,
    load_bmild_weights,
    params_from_numpy,
    params_from_torch_state_dict,
)
from nerf_tpu_torch.ops.composite_kernel import (
    composite_edges,
    composite_edges_360,
    composite_rays,
    composite_weights_360,
    fused_volume_render,
)
from nerf_tpu_torch.ops.mip360_kernel import nerf_mip360_raw, pack_mip360
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
    fused_render_edges_mip_raw,
    fused_render_mip_raw,
    fused_render_prop_mip360,
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
from nerf_tpu_torch.utils.cameras import BENCHMARK_FOCAL, generate_rays, pixel_radius
from nerf_tpu_torch.utils.device import resolve_device, torch_dtype
from nerf_tpu_torch.utils.monitor import (
    PerformanceMonitor,
    PerfStats,
    device_info_string,
    span,
)
from nerf_tpu_torch.utils.rendering import (
    first_level_360,
    mip_resample,
    s_to_t,
    sample_pdf,
    sample_points_on_rays,
    uniform_edges,
    volume_render,
)


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
            if cfg.model.variant == "mip360":
                self.params = init_mip360_params(g, cfg.model, dev)
            else:
                self.params = {"coarse": init_nerf_params(g, cfg.model, dev),
                               "fine": init_nerf_params(g, cfg.model, dev)}
        if cfg.model.variant == "mip":              # one network serves both passes
            self.params["coarse"] = self.params["fine"]
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
                     rcfg: RenderConfig, mode: str, radius: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(rgb [N, 3], depth [N])`` for one chunk of rays; ``radius``: the
        pixels' base radius (``utils/cameras.pixel_radius``), which the mip
        variant's cones take."""
        raise NotImplementedError

    def _render(self, params, pose, width, height, focal, spp, chunk, rcfg, mode):
        n = width * height
        radius = pixel_radius(focal)
        n_pad = -(-n // chunk) * chunk
        with span("engine.rays"):
            ro, rd = generate_rays(pose, width, height, focal, self.device)
            ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
            if n_pad != n:
                ro = torch.cat([ro, ro.new_zeros(n_pad - n, 3)])
                rd = torch.cat([rd, rd.new_ones(n_pad - n, 3)])
        outs = []
        for i in range(0, n_pad, chunk):
            with span("engine.chunk"):
                outs.append(self.render_chunk(params, ro[i:i + chunk], rd[i:i + chunk], spp,
                                              rcfg, mode, radius))
        with span("engine.assemble"):
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
        with span("engine.to_host"):
            rgb, depth = to_host(rgb), to_host(depth)
        return RenderResult(rgb=rgb, depth=depth, stats=stats)


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array. From the card it is copied into page-locked
    memory: one DMA transfer, which a loaded host does not slow as it slows
    the staged copy into pageable memory (the caching host allocator hands
    the buffer out again once the array is gone)."""
    if x.device.type != "cuda":
        return x.cpu().numpy()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out.numpy()


def refuse_mip(cfg: Config, what: str) -> None:
    """Raise for the mip and mip360 variants, which ``what`` does not
    compute."""
    if cfg.model.variant in ("mip", "mip360"):
        raise ValueError(f"{what} does not compute the {cfg.model.variant} variant (Mip-NeRF, "
                         "Mip-NeRF 360); render it with the torch or cuda engine")


def refuse_mip360_benchmark(cfg: Config, mode: str) -> None:
    """Raise for the mip360 variant outside the hierarchical mode: its
    levels are drawn from one another."""
    if cfg.model.variant == "mip360" and mode != "hierarchical":
        raise ValueError("the mip360 variant renders in the hierarchical mode only")


class TorchEngine(Engine):
    name = "torch"
    description = "plain PyTorch: apply_nerf and volume_render, no kernel of the port"

    def render_chunk(self, params, ro, rd, spp, rcfg, mode, radius=None):
        if self.cfg.model.variant == "mip360":
            refuse_mip360_benchmark(self.cfg, mode)
            out = render_mip360_rays(params, ro, rd, radius, self.cfg.model, rcfg,
                                     self.compute_dtype).out
            return out.rgb, out.depth
        if self.cfg.model.variant == "mip":
            res = render_mip_rays(params["fine"], ro, rd, radius, self.cfg.model, rcfg,
                                  self.compute_dtype, spp if mode == "benchmark" else None)
            out = res.coarse if res.fine is None else res.fine
            return out.rgb, out.depth
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
        if self.cfg.model.variant in ("mip", "mip360") and (planar or fuse_composite):
            raise ValueError(f"the {self.cfg.model.variant} variant's kernels write the raw "
                             "form only (no planar or composited output)")
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
            if self.cfg.model.variant == "mip360":
                self._packed = (source, pack_mip360(params, self.cfg.model))
                return self._packed[1]
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
        return composite_rays(raw, z, rd, rcfg, with_weights), z

    def render_chunk(self, packed, ro, rd, spp, rcfg, mode, radius=None):
        if self.cfg.model.variant == "mip360":
            refuse_mip360_benchmark(self.cfg, mode)
            out = self.mip360_passes(packed, ro, rd, rcfg, radius)[0]
            return out.rgb, out.depth
        if self.cfg.model.variant == "mip":
            out, _, _ = self.mip_passes(packed["fine"], ro, rd, spp, rcfg, mode, radius)
            return out.rgb, out.depth
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

    def mip_passes(self, packed, ro, rd, spp, rcfg, mode, radius):
        """The mip variant, one network: K1-mip at the uniform intervals ->
        K2's edges form (with weights) and, in the hierarchical mode,
        ``mip_resample`` (span ``mip.resample``) -> K3-mip at the fine
        intervals -> K2's edges form. The benchmark mode is the first pass
        alone at ``spp`` intervals. Returns ``(outputs, edges [N, S + 1], raw
        [N, 4S])``: the last pass's composite, its edges and its raw
        ``(density, r, g, b)`` an interval."""
        mcfg, dt, raw_dt = self.cfg.model, self.compute_dtype, self.raw_dtype
        n_c = spp if mode == "benchmark" else rcfg.n_coarse
        if mode == "hierarchical" and rcfg.n_fine != n_c:
            raise ValueError(f"Mip-NeRF resamples as many intervals as the coarse pass has: "
                             f"n_fine {rcfg.n_fine} != n_coarse {n_c}")
        edges = uniform_edges(rcfg.near, rcfg.far, n_c + 1, ro.device).expand(ro.shape[0], -1)
        raw = fused_render_mip_raw(packed, ro, rd, radius, rcfg.near, rcfg.far, n_c, mcfg,
                                   dtype=dt, raw_dtype=raw_dt)
        out = composite_edges(raw, edges, rd, rcfg, with_weights=mode == "hierarchical")
        if mode == "hierarchical":
            with span("mip.resample"):
                edges = mip_resample(edges, out.weights, rcfg.resample_padding)
            raw = fused_render_edges_mip_raw(packed, ro, rd, radius, edges, mcfg, dtype=dt,
                                             raw_dtype=raw_dt)
            out = composite_edges(raw, edges, rd, rcfg, with_weights=False)
        return out, edges, raw

    def mip360_passes(self, packed, ro, rd, rcfg, radius):
        """The mip360 variant's levels: each level's normalized edges from the
        level before (``resample_360``, span ``mip360.resample``), in metric
        depth (``s_to_t``); a proposal level's density by the proposal entry
        of the ray kernels' body, its weights by K2's opaque edges form; the
        NeRF level's raw by the NeRF pass, composited by K2's opaque edges
        form. Returns
        ``(outputs, s [N, n_fine + 1], raw [N, 4 n_fine], w [N, n_coarse])``:
        the NeRF level's composite, edges and raw, and the last proposal
        level's weights."""
        mcfg = self.cfg.model
        sizes = level_sizes(rcfg)
        prod, w = 1, None
        for level, k in enumerate(sizes):
            with span("mip360.resample"):
                s = (first_level_360(k, ro.shape[0], ro.device) if level == 0
                     else resample_360(s, w, k, prod, rcfg))
                t = s_to_t(s, rcfg.near, rcfg.far)
            prod *= k
            if level < len(sizes) - 1:
                density = fused_render_prop_mip360(packed["coarse"], ro, rd, radius, t, mcfg)
                w = composite_weights_360(density, t, rd)
        raw = nerf_mip360_raw(packed["fine"], ro, rd, radius, t, mcfg)
        out = composite_edges_360(raw, t, rd, rcfg)
        return out, s, raw, w

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
            out = composite_rays(raw, z, rd, rcfg, with_weights=False)
        return out.rgb, out.depth


class CompressedEngine(CudaEngine):
    """The cuda engine on pruned, intN-quantized weights. The quantized
    weights are the engine's only resident copy of its networks (int8
    weights are a quarter, int16 half of float32's bytes): each kernel call
    dequantizes them on chip once, into scratch that goes with the call
    (``ops/dequant_stream.py``), and the bf16 ray kernels read it; the
    per-sample path (``use_importance=False``) runs ``quantized_nerf_apply``
    (K7) the same way."""

    name = "compressed"
    description = ("pruned intN weights dequantized on chip once a call -> bf16 K1/K3 "
                   "(K7 per sample) -> K2")

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384,
                 bits: int = 8, prune_fraction: float = 0.1,
                 act_bits: Optional[int] = None, pos_bound: float = 12.0, **kw):
        super().__init__(shared, chunk_rays, **kw)
        refuse_mip(self.cfg, f"the {self.name} engine")
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
        refuse_mip(self.cfg, "the accel engine")
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

    def render_chunk(self, packed, ro, rd, spp, rcfg, mode, radius=None):
        if mode != "benchmark":
            return super().render_chunk(packed, ro, rd, spp, rcfg, mode, radius)
        grid = self.occupancy_grid()
        with span("occupancy.z_vals"):
            z = grid_guided_z_vals(grid, ro, rd, rcfg.near, rcfg.far, spp,
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
