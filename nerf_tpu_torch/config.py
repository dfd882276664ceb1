"""Configuration of the PyTorch/CUDA port.

The port's own copy of what the benchmark and hierarchical renders need
from ``nerf_tpu/config.py``: the model architecture (all fields, same names
and defaults, so one ``ModelConfig`` dict describes the same network to both
packages), the sampling schedule, the compositing constants and the compute
dtype. Training, occupancy-grid and mesh settings arrive with the slices
that read them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


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
    compute_dtype: str = "bfloat16"   # matmul input dtype; params stay float32


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


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
