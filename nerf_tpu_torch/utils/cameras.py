"""Camera model and ray generation.

Counterpart of ``nerf_tpu/utils/cameras.py``: OpenGL-style camera (x right,
y up, looking down -z); pixel (i, j) maps to direction
``((i - W/2)/f, -(j - H/2)/f, -1)`` rotated by the camera-to-world matrix.
Pose helpers return numpy ``[4, 4]`` float32 matrices, as in the JAX
package; ``generate_rays`` builds the rays on the requested device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nerf_tpu_torch.utils.device import resolve_device

BENCHMARK_FOCAL = 800.0


def focal_from_angle(width: int, camera_angle_x: float) -> float:
    """Blender-synthetic focal length."""
    return 0.5 * width / float(np.tan(0.5 * camera_angle_x))


def generate_rays(pose, width: int, height: int, focal: float,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel rays for a camera-to-world ``pose [4, 4]`` (or [3, 4]).
    Returns ``(rays_o [H, W, 3], rays_d [H, W, 3])``, row-major, float32;
    directions are not normalized."""
    dev = resolve_device(device)
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    i = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    j = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    dirs = torch.stack(
        [
            ((i - width * 0.5) / focal).expand(height, width),
            (-(j - height * 0.5) / focal).expand(height, width),
            -torch.ones(height, width, device=dev),
        ],
        dim=-1,
    )
    rot = pose[:3, :3]
    # written out per output axis, as the einsum "hwc,rc->hwr": no matmul,
    # so no TF32 question on the card
    rays_d = (dirs[..., None, :] * rot).sum(-1)
    rays_o = pose[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def orbit_poses(n_views: int, radius: float = 4.0) -> np.ndarray:
    """Benchmark poses: rotation about +Y at distance ``radius`` on z."""
    poses = np.zeros((n_views, 4, 4), np.float32)
    for k in range(n_views):
        a = 2.0 * np.pi * k / n_views
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 0] = np.cos(a)
        c2w[0, 2] = np.sin(a)
        c2w[2, 0] = -np.sin(a)
        c2w[2, 2] = np.cos(a)
        c2w[2, 3] = radius
        poses[k] = c2w
    return poses


def gate_poses(n_views: int, radius: float = 4.0,
               phi_deg: float = -30.0) -> np.ndarray:
    """Azimuth orbit of ``spherical_pose`` looking at the origin."""
    return np.stack([
        spherical_pose(30.0 + 360.0 * k / max(n_views, 1), phi_deg, radius)
        for k in range(n_views)
    ])


def spherical_pose(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-style look-at-origin pose: azimuth ``theta``, elevation
    ``phi``, distance ``radius``."""
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1] = np.cos(ph); rot_phi[1, 2] = -np.sin(ph)
    rot_phi[2, 1] = np.sin(ph); rot_phi[2, 2] = np.cos(ph)
    rot_th = np.eye(4, dtype=np.float32)
    rot_th[0, 0] = np.cos(th); rot_th[0, 2] = -np.sin(th)
    rot_th[2, 0] = np.sin(th); rot_th[2, 2] = np.cos(th)
    c2w = rot_th @ rot_phi @ trans
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
    )
    return flip @ c2w
