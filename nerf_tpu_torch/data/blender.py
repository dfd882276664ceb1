"""Blender-synthetic (nerf_synthetic) dataset loader.

Counterpart of ``nerf_tpu/data/blender.py``: reads
``transforms_{split}.json``, computes the focal from ``camera_angle_x``,
decodes the PNGs, composites RGBA onto a white background, and returns
images + poses + focal as contiguous numpy arrays on the host; the trainer
uploads them once. Two decoders, chosen by ``use_native`` as in the JAX
package: the port's threaded C++ decoder (``runtime.decode_png_batch``,
self-contained: it links no library, and it resizes bilinearly), and PIL
with LANCZOS resampling, the reference's. ``"auto"`` takes the native one
where no resampling is needed, the PNG's size (read from its IHDR, without
PIL) already being ``img_wh``; PIL is imported only where it decodes, and a
machine without it reads a dataset at its PNGs' own size.
"""

from __future__ import annotations

import json
import os
import struct
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
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path} at {img_wh} needs Pillow, which is not installed: read the "
            "dataset at its PNGs' own size (an --image_size equal to it), where the native "
            "decoder needs no Pillow, or pass use_native='always'") from e

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


def png_size(path: str) -> Tuple[int, int]:
    """``(width, height)`` from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def load_blender_split(
    data_dir: str, split: str, img_wh: Tuple[int, int] = (800, 800),
    max_images: Optional[int] = None, use_native: str = "auto",
) -> BlenderDataset:
    """``use_native``: ``"auto"`` decodes with the native decoder when the
    first PNG is already ``img_wh`` (no resampling: the two decoders then
    agree), with PIL otherwise; ``"always"`` / ``"never"`` force either."""
    if use_native not in ("auto", "always", "never"):
        raise ValueError(f"use_native must be auto, always or never, not {use_native!r}")
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

    native = use_native == "always" or (use_native == "auto" and bool(paths)
                                        and png_size(paths[0]) == tuple(img_wh))
    if native:
        from nerf_tpu_torch.runtime import decode_png_batch

        images = list(decode_png_batch(paths, img_wh, white_background=True))
    else:
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
    """Load all splits (``use_native="auto"``)."""
    return {s: load_blender_split(data_dir, s, img_wh, max_images) for s in splits}
