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
  PyTorch. On the CPU (tests) the kernels run their plain versions; on the
  card they launch the CUDA kernels.

A frame is cut into chunks of ``chunk_rays`` rays; the last chunk is padded
with rays of zero origin and unit direction so every chunk has one shape.
The compressed, int8 and accel engines arrive with later slices.
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
from nerf_tpu_torch.ops.render_kernel import (
    composited_to_outputs,
    fused_render_samples,
    fused_render_samples_composited,
    fused_render_zvals_composited,
    fused_render_zvals_raw,
)
from nerf_tpu_torch.render.pipeline import render_rays
from nerf_tpu_torch.train.checkpoint import has_checkpoint_meta, restore_bare_params
from nerf_tpu_torch.utils.cameras import BENCHMARK_FOCAL, generate_rays
from nerf_tpu_torch.utils.device import resolve_device
from nerf_tpu_torch.utils.monitor import PerformanceMonitor, PerfStats
from nerf_tpu_torch.utils.rendering import sample_pdf, sample_points_on_rays, volume_render


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
    K1 composited with weights -> ``sample_pdf`` -> sort -> K3 composited."""

    name = "cuda"

    def __init__(self, shared: Optional[SharedModel] = None, chunk_rays: int = 16384,
                 fuse_composite: bool = False):
        super().__init__(shared, chunk_rays)
        self.fuse_composite = fuse_composite
        self._packed = None

    def engine_params(self):
        """Both networks packed once for the ray kernels (once if they are
        the same weights)."""
        if self._packed is None:
            params = super().engine_params()
            fine = pack_params(params["fine"], self.cfg.model, self.compute_dtype)
            coarse = (fine if params["coarse"] is params["fine"] else
                      pack_params(params["coarse"], self.cfg.model, self.compute_dtype))
            self._packed = {"coarse": coarse, "fine": fine}
        return self._packed

    def _uniform(self, packed, ro, rd, spp, rcfg, with_weights):
        """One network at uniform depths: ``(RenderOutputs, z)``."""
        mcfg = self.cfg.model
        if self.fuse_composite:
            res = fused_render_samples_composited(
                packed, ro, rd, rcfg.near, rcfg.far, spp, mcfg, with_weights=with_weights,
                sentinel=rcfg.dist_sentinel, eps=rcfg.transmittance_eps)
            out8, w, z = res if with_weights else (res[0], None, res[1])
            return composited_to_outputs(out8, w, rcfg), z
        raw, z = fused_render_samples(packed, ro, rd, rcfg.near, rcfg.far, spp, mcfg,
                                      raw=True)
        return fused_volume_render_interleaved(raw, z, rd, rcfg), z

    def render_chunk(self, packed, ro, rd, spp, rcfg, mode):
        if mode == "benchmark":
            out, _ = self._uniform(packed["fine"], ro, rd, spp, rcfg, False)
            return out.rgb, out.depth
        if not rcfg.use_importance:
            raise NotImplementedError(
                "CudaEngine's hierarchical mode with use_importance=False runs the "
                "per-sample kernels K4 + K6, which arrive with ROADMAP A5/B4/B6; "
                "TorchEngine renders it")
        out_c, z_c = self._uniform(packed["coarse"], ro, rd, rcfg.n_coarse, rcfg, True)
        z_new = sample_pdf(z_c, out_c.weights, rcfg.n_fine, deterministic=True)
        z_f = torch.sort(torch.cat([z_c, z_new], dim=-1), dim=-1).values
        mcfg = self.cfg.model
        if self.fuse_composite:
            out8 = fused_render_zvals_composited(
                packed["fine"], ro, rd, z_f, mcfg, sentinel=rcfg.dist_sentinel,
                eps=rcfg.transmittance_eps)
            out = composited_to_outputs(out8, None, rcfg)
        else:
            raw = fused_render_zvals_raw(packed["fine"], ro, rd, z_f, mcfg)
            out = fused_volume_render_interleaved(raw, z_f, rd, rcfg)
        return out.rgb, out.depth
