"""Procedural multi-view dataset for tests and smoke training.

Counterpart of ``nerf_tpu/data/synthetic.py`` (numpy only, the same
arithmetic, so a seed gives both packages the same views): an analytic
scene, a Lambertian-shaded colored sphere on a white background, rendered
from any camera pose. It gives cheap, multi-view-consistent images a NeRF
fits in a few hundred steps, without shipping data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.utils.cameras import focal_from_angle, spherical_pose


def _render_sphere_view(
    pose: np.ndarray, width: int, height: int, focal: float,
    center=(0.0, 0.0, 0.0), radius: float = 1.0,
) -> np.ndarray:
    """Analytic ray-traced view of a matte sphere with position-dependent
    color, on white. Pure numpy; [H, W, 3] float32."""
    i = np.arange(width, dtype=np.float32)[None, :]
    j = np.arange(height, dtype=np.float32)[:, None]
    dirs = np.stack(
        [
            np.broadcast_to((i - width * 0.5) / focal, (height, width)),
            np.broadcast_to(-(j - height * 0.5) / focal, (height, width)),
            -np.ones((height, width), np.float32),
        ],
        axis=-1,
    )
    rays_d = dirs @ pose[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(pose[:3, -1], rays_d.shape)

    c = np.asarray(center, np.float32)
    oc = rays_o - c
    b = np.sum(oc * rays_d, axis=-1)
    disc = b * b - (np.sum(oc * oc, axis=-1) - radius * radius)
    hit = disc > 0.0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0.0

    p = rays_o + rays_d * t[..., None]
    n = (p - c) / radius
    light = np.asarray([0.5, 0.8, 0.3], np.float32)
    light = light / np.linalg.norm(light)
    lam = np.clip(np.sum(n * light, axis=-1), 0.1, 1.0)
    albedo = 0.5 + 0.5 * n  # position-dependent color
    img = np.where(hit[..., None], albedo * lam[..., None], 1.0)
    return img.astype(np.float32)


def make_procedural_dataset(
    n_views: int = 8,
    img_wh: Tuple[int, int] = (64, 64),
    camera_angle_x: float = 0.6911112070083618,  # lego's angle
    radius: float = 4.0,
    split: str = "train",
    seed: int = 0,
) -> BlenderDataset:
    """Views on a sphere of poses looking at the origin."""
    rng = np.random.default_rng(seed)
    w, h = img_wh
    focal = focal_from_angle(w, camera_angle_x)
    images, poses = [], []
    for k in range(n_views):
        theta = 360.0 * k / n_views + rng.uniform(-5, 5)
        phi = -30.0 + rng.uniform(-10, 10)
        pose = spherical_pose(theta, phi, radius)
        images.append(_render_sphere_view(pose, w, h, focal))
        poses.append(pose)
    return BlenderDataset(
        images=np.stack(images),
        poses=np.stack(poses).astype(np.float32),
        focal=focal,
        split=split,
        img_wh=img_wh,
    )
