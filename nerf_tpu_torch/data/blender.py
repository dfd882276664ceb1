"""Blender-synthetic (nerf_synthetic) dataset loader.

Counterpart of ``nerf_tpu/data/blender.py``: reads
``transforms_{split}.json``, computes the focal from ``camera_angle_x``,
decodes the PNGs with PIL, resizes with LANCZOS, composites RGBA onto a white
background, and returns images + poses + focal as contiguous numpy arrays on
the host; the trainer uploads them once. The JAX package's native threaded
PNG decoder belongs to its C++ host runtime and has no counterpart here yet.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from nerf_tpu_torch.utils.cameras import focal_from_angle


@dataclass
class BlenderDataset:
    images: np.ndarray          # [N, H, W, 3] float32 in [0, 1]
    poses: np.ndarray           # [N, 4, 4] float32 camera-to-world
    focal: float
    split: str
    img_wh: Tuple[int, int]

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {"image": self.images[i], "pose": self.poses[i], "focal": self.focal}


def _load_image(path: str, img_wh: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.size != img_wh:
        img = img.resize(img_wh, Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 4:
        # RGBA -> white background
        rgb, a = arr[..., :3], arr[..., 3:4]
        arr = rgb * a + (1.0 - a)
    return arr[..., :3]


def load_blender_split(
    data_dir: str, split: str, img_wh: Tuple[int, int] = (800, 800),
    max_images: Optional[int] = None,
) -> BlenderDataset:
    meta_path = os.path.join(data_dir, f"transforms_{split}.json")
    with open(meta_path) as f:
        meta = json.load(f)

    focal = focal_from_angle(img_wh[0], meta["camera_angle_x"])
    frames = meta["frames"]
    if max_images is not None:
        frames = frames[:max_images]

    paths, poses = [], []
    for frame in frames:
        fp = frame["file_path"]
        img_path = os.path.join(data_dir, fp)
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        paths.append(img_path)
        poses.append(np.asarray(frame["transform_matrix"], np.float32))

    images = [_load_image(p, img_wh) for p in paths]

    return BlenderDataset(
        images=np.stack(images) if images else np.zeros((0, img_wh[1], img_wh[0], 3), np.float32),
        poses=np.stack(poses) if poses else np.zeros((0, 4, 4), np.float32),
        focal=focal,
        split=split,
        img_wh=img_wh,
    )


def load_blender_data(
    data_dir: str, img_wh: Tuple[int, int] = (800, 800),
    splits: Tuple[str, ...] = ("train", "val", "test"),
    max_images: Optional[int] = None,
) -> Dict[str, BlenderDataset]:
    """Load all splits."""
    return {s: load_blender_split(data_dir, s, img_wh, max_images) for s in splits}
