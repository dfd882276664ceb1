"""Configuration of the PyTorch/CUDA port.

The port's own copy of what rendering and training need from
``nerf_tpu/config.py``: the model architecture, the sampling schedule and
compositing constants, the optimization schedule, the run's directories
(the dataset's ``data_dir`` among them) and the occupancy-grid engine's
scene constants, all with the same names and defaults, so one config dict
(a checkpoint's ``meta["config"]``) describes the same run to both
packages: ``to_dict`` has the JAX package's keys but ``mesh``, which
arrives with the multi-GPU slice; ``from_dict`` ignores it in a dict
written by the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of one NeRF MLP."""

    # "reference": density head + direct color branch, skip concat
    #   [h, posenc] before trunk layer ``skip_layer``, ReLU on density.
    # "bmild": original-NeRF layout (alpha + bottleneck heads, skip concat
    #   [posenc, h] after trunk layer ``skip_layer``, raw density).
    variant: str = "reference"
    pos_freqs: int = 10          # L for position encoding -> 3 + 6L = 63 dims
    dir_freqs: int = 4           # L for direction encoding -> 27 dims
    hidden_dim: int = 256
    n_layers: int = 8
    skip_layer: int = 4
    color_hidden_dim: int = 128
    posenc_pi: bool = True       # bands 2^i * pi (reference) or 2^i (bmild)
    normalize_dirs: bool = False

    @property
    def pos_dim(self) -> int:
        return 3 + 6 * self.pos_freqs

    @property
    def dir_dim(self) -> int:
        return 3 + 6 * self.dir_freqs


@dataclass(frozen=True)
class RenderConfig:
    """Depth range, sampling schedule and compositing constants."""

    near: float = 2.0
    far: float = 6.0
    n_coarse: int = 64
    n_fine: int = 128
    perturb: bool = True              # stratified jitter during training
    use_importance: bool = True       # fine depths by inverse CDF of the coarse weights
    white_background: bool = False
    raw_noise_std: float = 0.0        # density noise during training
    dist_sentinel: float = 1e10       # distance after the last sample
    transmittance_eps: float = 1e-10


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule."""

    learning_rate: float = 3e-4
    lr_decay: float = 0.1             # total decay factor ...
    lr_decay_steps: int = 250_000     # ... reached after this many steps
    weight_decay: float = 1e-6
    grad_clip_norm: float = 1.0
    n_rays: int = 2048                # rays per train step
    chunk_size: int = 8192            # samples per render chunk
    n_epochs: int = 100
    checkpoint_frequency: int = 25    # epochs between checkpoints
    val_frequency: int = 10           # epochs between validations
    max_val_images: int = 5
    seed: int = 0
    compute_dtype: str = "bfloat16"   # matmul input dtype; params stay float32


@dataclass(frozen=True)
class AccelConfig:
    """The occupancy-grid engine's scene constants (``AccelEngine``): the
    JAX package's defaults, tuned there for an object inside a
    ``[-1.5, 1.5]^3`` box. Per scene, not magic numbers."""

    grid_resolution: int = 128
    density_threshold: float = 5.0    # sigma above which a cell is occupied (binary store)
    aabb: Tuple[float, float] = (-1.5, 1.5)   # scene bounds, the same on every axis
    n_probe: int = 96                 # grid probes per ray that place the depths
    probe_resolution: int = 64        # probe a max-pooled mip of this resolution; 0: the grid
    grid_store: str = "density"       # "binary": thresholded {0, 1}; "density": relu(sigma)
    weight_mode: str = "alpha"        # probe pdf: "occupancy", "alpha" or "transmittance"
    probe_ray_stride: int = 4         # probe every k-th ray, its group shares the depths


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    accel: AccelConfig = field(default_factory=AccelConfig)
    data_dir: str = "data/nerf_synthetic/lego"
    checkpoint_dir: str = "checkpoints"
    output_dir: str = "outputs"
    img_wh: Tuple[int, int] = (800, 800)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Config":
        """Build a config from ``to_dict``'s output (either package's):
        unknown sections and fields are ignored, missing ones default."""

        def build(cls, sub):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in (sub or {}).items() if k in names})

        top = {k: d[k] for k in ("data_dir", "checkpoint_dir", "output_dir") if k in d}
        if "img_wh" in d:
            top["img_wh"] = tuple(d["img_wh"])
        accel = build(AccelConfig, d.get("accel"))
        return Config(model=build(ModelConfig, d.get("model")),
                      render=build(RenderConfig, d.get("render")),
                      train=build(TrainConfig, d.get("train")),
                      accel=dataclasses.replace(accel, aabb=tuple(accel.aabb)), **top)


def default_config() -> Config:
    return Config()


def reference_compat_config() -> Config:
    """The reference's numerics: uniform fine pass (no importance sampling),
    no jitter, float32 compute."""
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        render=dataclasses.replace(cfg.render, use_importance=False, perturb=False),
        train=dataclasses.replace(cfg.train, compute_dtype="float32"),
    )


def bmild_config() -> Config:
    """The original-NeRF lego example weights: no pi in the encoding,
    normalized view directions, white background."""
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, variant="bmild", posenc_pi=False, normalize_dirs=True
        ),
        render=dataclasses.replace(cfg.render, white_background=True),
    )
