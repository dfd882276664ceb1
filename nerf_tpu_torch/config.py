"""Configuration of the PyTorch/CUDA port.

The port's own copy of what rendering and training need from
``nerf_tpu/config.py``: the model architecture, the sampling schedule and
compositing constants, the optimization schedule, the run's directories
(the dataset's ``data_dir`` among them), the device mesh of sharded
training (``parallel/``) and the occupancy-grid engine's scene constants,
all with the same names and defaults, so one config dict (a checkpoint's
``meta["config"]``) describes the same run to both packages: ``to_dict``
has every key of the JAX package's, and ``from_dict`` reads either
package's dict.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple

from nerf_tpu_torch.models.encoding import N_BASIS, encoded_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of one NeRF MLP."""

    # "reference": density head + direct color branch, skip concat
    #   [h, posenc] before trunk layer ``skip_layer``, ReLU on density.
    # "bmild": original-NeRF layout (alpha + bottleneck heads, skip concat
    #   [posenc, h] after trunk layer ``skip_layer``, raw density).
    # "mip": Mip-NeRF (models/mip.py): bmild's layer layout on the integrated
    #   positional encoding of conical frustums (degrees ipe_min_deg ..
    #   ipe_max_deg - 1, no identity), skip concat [h, enc],
    #   density softplus(raw + density_bias), rgb padded by rgb_padding;
    #   one network serves the coarse and the fine pass.
    # "mip360": Mip-NeRF 360 (models/mip360.py): the IPE of contracted
    #   full-covariance Gaussians on the 21 directions of a twice-subdivided
    #   icosahedron (2 x 21 x (ipe_max_deg - ipe_min_deg) features); a
    #   proposal network (prop_layers x prop_hidden_dim, density only) for
    #   the proposal levels and a NeRF network (n_layers x hidden_dim, skip
    #   [h, enc] after layer skip_layer, a bottleneck of bottleneck_dim,
    #   [b, dir_enc] -> color_hidden_dim -> 3) for the last one.
    variant: str = "reference"
    pos_freqs: int = 10          # L for position encoding -> 3 + 6L = 63 dims
    dir_freqs: int = 4           # L for direction encoding -> 27 dims
    hidden_dim: int = 256
    n_layers: int = 8
    skip_layer: int = 4
    color_hidden_dim: int = 128
    posenc_pi: bool = True       # bands 2^i * pi (reference) or 2^i (bmild)
    normalize_dirs: bool = False
    ipe_min_deg: int = 0         # mip: the IPE's degrees, min_deg .. max_deg - 1
    ipe_max_deg: int = 16
    density_bias: float = 0.0    # mip: added to the raw density before the softplus
    rgb_padding: float = 0.0     # mip: rgb = sigmoid * (1 + 2 pad) - pad
    bottleneck_dim: int = 256    # mip360: the NeRF network's bottleneck width
    prop_hidden_dim: int = 256   # mip360: the proposal network's width ...
    prop_layers: int = 4         # ... and depth

    @property
    def pos_dim(self) -> int:
        if self.variant == "mip":
            return 6 * (self.ipe_max_deg - self.ipe_min_deg)
        if self.variant == "mip360":
            return 2 * N_BASIS * (self.ipe_max_deg - self.ipe_min_deg)
        return encoded_dim(3, self.pos_freqs)

    @property
    def dir_dim(self) -> int:
        return encoded_dim(3, self.dir_freqs)


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
    resample_padding: float = 0.01    # mip: added to the blurred coarse weights


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
class MeshConfig:
    """Device-mesh layout for sharded training and rendering
    (``parallel/``): one rank of a process group per device."""

    data_axis: int = -1               # -1: every rank on the data (ray) axis
    model_axis: int = 1               # ranks sharing the trunk's hidden columns
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
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
        mesh = build(MeshConfig, d.get("mesh"))
        return Config(model=build(ModelConfig, d.get("model")),
                      render=build(RenderConfig, d.get("render")),
                      train=build(TrainConfig, d.get("train")),
                      mesh=dataclasses.replace(mesh, axis_names=tuple(mesh.axis_names)),
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


def mip_config() -> Config:
    """Mip-NeRF's Blender configuration (google/mipnerf, configs/blender.gin):
    IPE degrees 0..15, view directions at 4 degrees, unit view directions,
    skip ``[h, enc]`` after layer 4, density bias -1, rgb padding 0.001,
    128 + 128 intervals resampled with padding 0.01, white background."""
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, variant="mip", posenc_pi=False, normalize_dirs=True,
            density_bias=-1.0, rgb_padding=0.001),
        render=dataclasses.replace(cfg.render, n_coarse=128, n_fine=128,
                                   white_background=True),
    )


def mip360_config() -> Config:
    """Mip-NeRF 360's unbounded-scene configuration (google-research/multinerf,
    configs/360.gin; ``Model``, ``PropMLP``, ``NerfMLP``): IPE degrees
    0..11 on the icosahedral basis of two subdivisions (504 features), a
    4 x 256 proposal network at 64 intervals on each of two proposal
    levels, an 8 x 1,024 NeRF network (skip after layer 4, bottleneck 256,
    view layer 128 on directions at 4 degrees) at 32 intervals, density
    bias -1, rgb padding 0.001, disparity spacing between near 0.2 and far
    1e6, no resample padding, background 1. The level count, the dilation
    and the opaque last interval are the variant's own (``models/mip360.py``)."""
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, variant="mip360", hidden_dim=1024, posenc_pi=False, normalize_dirs=True,
            ipe_min_deg=0, ipe_max_deg=12, density_bias=-1.0, rgb_padding=0.001),
        render=dataclasses.replace(
            cfg.render, near=0.2, far=1e6, n_coarse=64, n_fine=32, perturb=False,
            white_background=True, resample_padding=0.0),
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
