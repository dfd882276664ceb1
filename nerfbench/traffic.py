"""The general generator of the benchmark's traffic: camera poses and the
training scene, from a workload file's parameters and the run's seed.

Poses look at the origin from ``radius``, at an azimuth and an elevation
drawn uniformly from the file's ranges (degrees), Blender's convention.
The training scene is an analytic one: a Lambertian sphere of radius 1 at
the origin, colored by its normal, on white, rendered from each pose.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def focal_from_angle(width: int, camera_angle_x: float) -> float:
    return 0.5 * width / math.tan(0.5 * camera_angle_x)


def spherical_pose(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1], rot_phi[1, 2] = np.cos(ph), -np.sin(ph)
    rot_phi[2, 1], rot_phi[2, 2] = np.sin(ph), np.cos(ph)
    rot_th = np.eye(4, dtype=np.float32)
    rot_th[0, 0], rot_th[0, 2] = np.cos(th), -np.sin(th)
    rot_th[2, 0], rot_th[2, 2] = np.sin(th), np.cos(th)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return (flip @ (rot_th @ rot_phi @ trans)).astype(np.float32)


def poses(seed: int, n: int, spec: dict) -> np.ndarray:
    """``[n, 4, 4]`` float32 camera-to-world poses drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(*spec["azimuth_deg"], size=n)
    el = rng.uniform(*spec["elevation_deg"], size=n)
    return np.stack([spherical_pose(a, e, spec["radius"]) for a, e in zip(az, el)])


@dataclass
class Views:
    """A training split as the trainer takes it: images ``[N, H, W, 3]`` and
    poses on the host, one focal."""

    images: np.ndarray
    poses: np.ndarray
    focal: float

    def __len__(self) -> int:
        return self.images.shape[0]

    def part(self, a: int, b: int) -> "Views":
        return Views(self.images[a:b], self.poses[a:b], self.focal)


def sphere_views(seed: int, spec: dict, device) -> Views:
    """``spec['views']`` views of the sphere scene at ``spec['resolution']``
    ``[W, H]``, rendered on ``device``."""
    w, h = spec["resolution"]
    focal = focal_from_angle(w, spec["camera_angle_x"])
    ps = poses(seed, spec["views"], spec)
    light = torch.tensor([0.5, 0.8, 0.3], device=device)
    light = light / light.norm()
    i = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    j = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    cam = torch.stack([(i - w * 0.5) / focal, -(j - h * 0.5) / focal, -torch.ones_like(i)], -1)
    images = []
    for pose in torch.as_tensor(ps, device=device):
        d = cam @ pose[:3, :3].T
        d = d / d.norm(dim=-1, keepdim=True)
        o = pose[:3, 3].expand(d.shape)
        b = (o * d).sum(-1)
        disc = b * b - ((o * o).sum(-1) - 1.0)
        t = -b - torch.sqrt(disc.clamp(min=0.0))
        hit = (disc > 0) & (t > 0)
        n = o + d * t[..., None]
        lam = (n * light).sum(-1).clamp(0.1, 1.0)
        img = torch.where(hit[..., None], (0.5 + 0.5 * n) * lam[..., None], torch.ones_like(n))
        images.append(img)
    return Views(torch.stack(images).cpu().numpy(), ps, focal)


def resolution(spec: dict) -> Tuple[int, int]:
    w, h = spec["resolution"]
    return int(w), int(h)
