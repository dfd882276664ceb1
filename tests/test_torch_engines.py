"""The whole slice: port engines vs the JAX engines on the same trained
weights and camera, plus weight loading and device selection."""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from nerf_tpu.config import default_config as jdefault
from nerf_tpu.models.nerf import init_nerf_params as jinit, params_to_torch_state_dict
from nerf_tpu.render.engines import PallasEngine, SharedModel as JSharedModel, XLAEngine
from nerf_tpu.utils.cameras import focal_from_angle, spherical_pose
from nerf_tpu_torch.config import bmild_config, default_config
from nerf_tpu_torch.models.nerf import params_to_numpy
from nerf_tpu_torch.render.engines import CudaEngine, SharedModel, TorchEngine
from nerf_tpu_torch.utils.cameras import generate_rays
from nerf_tpu_torch.utils.monitor import PerformanceMonitor

PARAMS = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"
W, H, S = 40, 30, 16
POSE = spherical_pose(30.0, -30.0, 4.0)
FOCAL = focal_from_angle(W, 0.6911112070083618)


def _white(cfg, dtype="bfloat16"):
    return dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, white_background=True),
        train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def _psnr(a, b):
    return float(-10.0 * np.log10(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.fixture(scope="module")
def xla_frame():
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    shared = JSharedModel(_white(jdefault(), "float32")).load(str(PARAMS))
    return XLAEngine(shared).render_image(POSE, (W, H), S, focal=FOCAL, monitor=False)


@pytest.mark.parametrize("engine_cls", [TorchEngine, CudaEngine])
def test_frame_matches_xla_engine_f32(xla_frame, engine_cls):
    # float32 compute throughout: rgb atol 1e-4 / >= 60 dB. The residual is
    # sin/cos ulps at the top band (and, for the cuda engine's plain path,
    # z = near + (far-near) t instead of near (1-t) + far t)
    shared = SharedModel(_white(default_config(), "float32"), "cpu").load(str(PARAMS))
    res = engine_cls(shared).render_image(POSE, (W, H), S, focal=FOCAL)
    assert res.rgb.shape == (H, W, 3) and res.depth.shape == (H, W)
    np.testing.assert_allclose(res.rgb, xla_frame.rgb, atol=1e-4, rtol=0)
    assert _psnr(res.rgb, xla_frame.rgb) >= 60.0
    np.testing.assert_allclose(res.depth, xla_frame.depth, atol=1e-3, rtol=0)
    assert res.stats.device_kind == "cpu" and res.stats.wall_time_s > 0


def test_cuda_engine_bf16_matches_pallas_engine():
    # both in bf16, each rounding activations at its own points (the Pallas
    # kernel's epilogue is bf16, its sine a polynomial): >= 40 dB
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    jshared = JSharedModel(_white(jdefault())).load(str(PARAMS))
    ref = PallasEngine(jshared, interpret=True).render_image(POSE, (W, H), S, focal=FOCAL,
                                                             monitor=False)
    shared = SharedModel(_white(default_config()), "cpu").load(str(PARAMS))
    res = CudaEngine(shared).render_image(POSE, (W, H), S, focal=FOCAL, monitor=False)
    assert _psnr(res.rgb, ref.rgb) >= 40.0


def test_chunking_and_padding_do_not_change_the_frame():
    shared = SharedModel(_white(default_config(), "float32"), "cpu").load(None)
    whole = CudaEngine(shared).render_image(POSE, (17, 11), 8, focal=20.0, monitor=False)
    chunked = CudaEngine(shared, chunk_rays=50).render_image(POSE, (17, 11), 8, focal=20.0,
                                                             monitor=False)
    np.testing.assert_allclose(chunked.rgb, whole.rgb, atol=1e-6)
    assert np.isfinite(chunked.depth).all()


def test_hierarchical_mode_is_not_ported_yet():
    shared = SharedModel(default_config(), "cpu").load(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchEngine(shared).render_image(POSE, (4, 4), 8, mode="hierarchical")


def test_shared_model_loaders(tmp_path):
    cfg = default_config()
    with pytest.warns(UserWarning, match="not found"):
        a = SharedModel(cfg, "cpu").load(str(tmp_path / "missing.npz"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = SharedModel(cfg, "cpu").load(None)
    torch.testing.assert_close(a.params["fine"]["trunk"][2]["w"],
                               b.params["fine"]["trunk"][2]["w"])

    # reference-format torch checkpoint, as the JAX package exports it
    jc = jdefault().model
    jp = {k: jax.device_get(jinit(jax.random.PRNGKey(i), jc))
          for i, k in enumerate(("coarse", "fine"))}
    ckpt = {f"{k}_model": {n: torch.tensor(v) for n, v in params_to_torch_state_dict(p).items()}
            for k, p in jp.items()}
    torch.save(ckpt, tmp_path / "final_model.pth")
    pth = SharedModel(cfg, "cpu").load(str(tmp_path / "final_model.pth"))
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(pth.params["fine"]),
                 jax.tree.map(np.asarray, jp["fine"]))

    # bmild .npy: 24 [in, out] arrays
    rng = np.random.default_rng(0)
    shapes = [(63, 256)] + [(256, 256)] * 4 + [(319, 256)] + [(256, 256)] * 2
    arrs = []
    for s in shapes:
        arrs += [rng.normal(size=s).astype(np.float32), np.zeros(s[1], np.float32)]
    for s in [(256, 256), (283, 128), (128, 3), (256, 1)]:
        arrs += [rng.normal(size=s).astype(np.float32), np.zeros(s[1], np.float32)]
    obj = np.empty(24, dtype=object)
    obj[:] = arrs
    np.save(tmp_path / "model_fine_1.npy", obj, allow_pickle=True)
    bm = SharedModel(bmild_config(), "cpu").load(str(tmp_path / "model_fine_1.npy"))
    assert bm.params["fine"]["bottleneck"]["w"].shape == (256, 256)
    assert bm.params["coarse"] is bm.params["fine"]

    # trainer checkpoints wait for the training slice
    np.savez(tmp_path / "ckpt.npz", __meta__=np.zeros(1, np.uint8))
    with pytest.raises(NotImplementedError):
        SharedModel(cfg, "cpu").load(str(tmp_path / "ckpt.npz"))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        SharedModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_rays(POSE, 4, 4, 10.0)


def test_monitor_on_cpu():
    mon = PerformanceMonitor("cpu").start()
    stats = mon.stop()
    assert stats.peak_device_mb is None and stats.peak_host_rss_mb > 0
