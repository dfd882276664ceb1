"""Execution engines: the same weights through different execution methods.

Counterpart of ``nerf_tpu/render/engines.py`` for the benchmark render
(fine network only, uniform unperturbed samples, chunked frame):

- ``torch`` (``TorchEngine``, the ``XLAEngine`` counterpart): plain PyTorch,
  ``sample_points_on_rays`` -> ``apply_nerf`` -> ``volume_render``;
- ``cuda`` (``CudaEngine``, the ``PallasEngine`` counterpart): the fused
  ray kernel (``ops/render_kernel.py``) writes interleaved per-sample
  ``(sigma, r, g, b)`` and the compositor kernel
  (``ops/composite_kernel.py``) reduces it per ray. On the CPU (tests) both
  run their plain versions; on the card they launch the CUDA kernels.

A frame is cut into chunks of ``chunk_rays`` rays; the last chunk is padded
with rays of zero origin and unit direction so every chunk has one shape.
The hierarchical mode, the compressed, int8 and accel engines arrive with
later slices.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
from nerf_tpu_torch.ops.composite_kernel import fused_volume_render_interleaved
from nerf_tpu_torch.ops.mlp_kernel import pack_params
from nerf_tpu_torch.ops.render_kernel import fused_render_samples
from nerf_tpu_torch.train.checkpoint import has_checkpoint_meta, restore_bare_params
from nerf_tpu_torch.utils.cameras import BENCHMARK_FOCAL, generate_rays
from nerf_tpu_torch.utils.device import resolve_device
from nerf_tpu_torch.utils.monitor import PerformanceMonitor, PerfStats
from nerf_tpu_torch.utils.rendering import sample_points_on_rays, volume_render


class SharedModel:
    """The one set of weights every engine renders with: ``params`` is
    ``{'coarse': ..., 'fine': ...}`` on ``device``."""

    def __init__(self, cfg: Optional[Config] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else default_config()
        self.params: Optional[Dict[str, NeRFParams]] = None

    def load(self, checkpoint_path: Optional[str] = None, seed: int = 0) -> "SharedModel":
        """Load a reference-format torch ``.pth``, bmild ``.npy`` weights or
        a keystr params ``.npz``; for a missing path, random weights from
        ``seed`` (with a warning, as the JAX package does)."""
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
                raise NotImplementedError(
                    "trainer checkpoints (with __meta__) are read by the training "
                    "slice (ROADMAP A5); pass a params-only .npz")
            params = params_from_numpy(restore_bare_params(checkpoint_path), dev)
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


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Engine:
    """One execution method; subclasses implement ``render_chunk``."""

    name = "base"

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384):
        if shared is None:
            shared = SharedModel().load()
        self.shared = shared
        self.cfg = shared.cfg
        self.device = shared.device
        self.chunk_rays = chunk_rays
        self.compute_dtype = _dtype(self.cfg.train.compute_dtype)
        self._warmed: set = set()

    def engine_params(self):
        if self.shared.params is None:
            raise RuntimeError("call SharedModel.load first")
        return self.shared.params

    def render_chunk(self, params, ro: torch.Tensor, rd: torch.Tensor, spp: int,
                     rcfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(rgb [N, 3], depth [N])`` for one chunk of rays."""
        raise NotImplementedError

    def _render(self, params, pose, width, height, focal, spp, chunk, rcfg):
        n = width * height
        n_pad = -(-n // chunk) * chunk
        ro, rd = generate_rays(pose, width, height, focal, self.device)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        if n_pad != n:
            ro = torch.cat([ro, ro.new_zeros(n_pad - n, 3)])
            rd = torch.cat([rd, rd.new_ones(n_pad - n, 3)])
        outs = [self.render_chunk(params, ro[i:i + chunk], rd[i:i + chunk], spp, rcfg)
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
        if mode == "hierarchical":
            raise NotImplementedError(
                "hierarchical render arrives with the hierarchical slice "
                "(ROADMAP A4: sample_pdf + kernel B3)")
        if mode != "benchmark":
            raise ValueError(f"unknown render mode {mode}")
        width, height = resolution
        chunk = min(self.chunk_rays, width * height)
        rcfg = self.cfg.render
        params = self.engine_params()
        args = (params, pose, width, height, focal, samples_per_ray, chunk, rcfg)

        mon = PerformanceMonitor(self.device) if monitor else None
        if mon:
            # one untimed frame per (spp, chunk): the first CUDA call builds
            # and loads the kernels
            key = (samples_per_ray, chunk)
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

    def render_chunk(self, params, ro, rd, spp, rcfg):
        pts, z = sample_points_on_rays(ro, rd, rcfg.near, rcfg.far, spp)
        dirs = rd[:, None, :].expand(pts.shape)
        sigma, rgb = apply_nerf(params["fine"], pts, dirs, self.cfg.model,
                                compute_dtype=self.compute_dtype)
        out = volume_render(sigma, rgb, z, rd, rcfg)
        return out.rgb, out.depth


class CudaEngine(Engine):
    name = "cuda"

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384):
        super().__init__(shared, chunk_rays)
        self._packed = None

    def engine_params(self):
        """The fine network packed once for the ray kernel."""
        if self._packed is None:
            self._packed = pack_params(super().engine_params()["fine"],
                                       self.cfg.model, self.compute_dtype)
        return self._packed

    def render_chunk(self, packed, ro, rd, spp, rcfg):
        raw, z = fused_render_samples(packed, ro, rd, rcfg.near, rcfg.far, spp,
                                      self.cfg.model, raw=True)
        out = fused_volume_render_interleaved(raw, z, rd, rcfg)
        return out.rgb, out.depth
