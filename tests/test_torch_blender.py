"""The port's real-data path against the JAX package's, on the CPU: the
Blender loader (``data/blender.load_blender_split``) on a tiny
nerf_synthetic-format directory this test writes, through each decoder,
and ``Config.data_dir``."""

import dataclasses
import json
import sys

import numpy as np
import pytest

from nerf_tpu.config import Config as JConfig
from nerf_tpu.data.blender import load_blender_split as jload
from nerf_tpu_torch.config import Config, default_config
from nerf_tpu_torch.data.blender import load_blender_data, load_blender_split, png_size

W, H = 12, 10           # the PNGs' own size
CAMERA_ANGLE_X = 0.6911112070083618


def write_blender_dir(root, n_train=3, n_val=1, wh=(W, H), seed=0):
    """A nerf_synthetic-format directory: RGBA PNGs (alpha not constant)
    under train/ and val/, and ``transforms_{split}.json`` with extensionless
    file paths, as the published scenes have."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(n):
            rgba = rng.integers(0, 256, (wh[1], wh[0], 4), dtype=np.uint8)
            Image.fromarray(rgba, "RGBA").save(root / split / f"r_{i}.png")
            pose = np.eye(4)
            pose[:3, 3] = rng.normal(size=3) + [0, 0, 4]
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return root


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    return write_blender_dir(tmp_path_factory.mktemp("blender"))


@pytest.mark.parametrize("max_images", [None, 2])
@pytest.mark.parametrize("img_wh", [(W, H), (7, 5)], ids=["own_size", "resized"])
@pytest.mark.parametrize("use_native", ["auto", "always", "never"])
def test_load_blender_split_matches_the_jax_loader(blender_dir, use_native, img_wh, max_images):
    got = load_blender_split(str(blender_dir), "train", img_wh, max_images, use_native)
    ref = jload(str(blender_dir), "train", img_wh, max_images, use_native)
    n = 3 if max_images is None else max_images
    assert got.images.shape == (n, img_wh[1], img_wh[0], 3) and got.images.dtype == np.float32
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.poses, ref.poses)
    assert got.focal == ref.focal and got.split == "train" and got.img_wh == img_wh


def test_auto_at_the_pngs_size_needs_no_pil(blender_dir, monkeypatch):
    assert png_size(str(blender_dir / "train" / "r_0.png")) == (W, H)
    ref = jload(str(blender_dir), "val", (W, H))
    monkeypatch.setitem(sys.modules, "PIL", None)        # any import of PIL now fails
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = load_blender_data(str(blender_dir), (W, H), splits=("train", "val"))
    np.testing.assert_array_equal(got["val"].images, ref.images)
    assert len(got["train"]) == 3
    # a resize needs PIL, and says what to do without it
    with pytest.raises(ImportError, match="own size"):
        load_blender_split(str(blender_dir), "train", (7, 5))
    with pytest.raises(ImportError, match="Pillow"):
        load_blender_split(str(blender_dir), "train", (W, H), use_native="never")


def test_rgba_pngs_written_with_zlib_load_natively_without_pil(tmp_path, monkeypatch):
    # the self-contained decoder reads a directory no PNG library wrote, at
    # its own size, with PIL unimportable: each pixel the composite of its bytes
    from test_torch_png import png_bytes

    rng = np.random.default_rng(7)
    root, frames, want = tmp_path / "scene", [], []
    (root / "train").mkdir(parents=True)
    for i in range(3):
        rgba = rng.integers(0, 256, (H, W, 4))
        rgba[..., 3] = np.where(rng.random((H, W)) < 0.3, 0, rgba[..., 3])
        (root / "train" / f"r_{i}.png").write_bytes(
            png_bytes(rgba, 6, 8, filters="mixed", interlace=i == 2))
        f = rgba.astype(np.float32) / np.float32(255)
        want.append(f[..., :3] * f[..., 3:] + (np.float32(1) - f[..., 3:]))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": np.eye(4).tolist()})
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = load_blender_split(str(root), "train", (W, H), use_native="auto")
    np.testing.assert_array_equal(got.images, np.stack(want))


def test_use_native_names_a_decoder(blender_dir, tmp_path):
    with pytest.raises(ValueError, match="use_native"):
        load_blender_split(str(blender_dir), "train", (W, H), use_native="sometimes")
    (tmp_path / "x.png").write_bytes(b"not a png at all, just bytes")
    with pytest.raises(ValueError, match="not a PNG"):
        png_size(str(tmp_path / "x.png"))


def test_config_keeps_data_dir_and_has_the_jax_keys():
    jcfg = JConfig(data_dir="some/scene")
    got = Config.from_dict(json.loads(json.dumps(jcfg.to_dict())))
    assert got.data_dir == "some/scene"
    assert list(default_config().to_dict()) == list(JConfig().to_dict())
    assert Config().data_dir == JConfig().data_dir
    cfg = dataclasses.replace(default_config(), data_dir="d")
    assert Config.from_dict(cfg.to_dict()) == cfg
    assert JConfig.from_dict(cfg.to_dict()).data_dir == "d"
