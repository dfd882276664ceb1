"""The whole slice: port engines vs the JAX engines on the same trained
weights and camera, in the benchmark and hierarchical modes and with
``fuse_composite``, plus weight loading and device selection."""

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
from nerf_tpu_torch.ops import mlp_kernel
from nerf_tpu_torch.ops.composite_kernel import fused_volume_render
from nerf_tpu_torch.render.engines import CudaEngine, SharedModel, TorchEngine
from nerf_tpu_torch.utils.cameras import generate_rays
from nerf_tpu_torch.utils.monitor import PerformanceMonitor

PARAMS = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"
W, H, S = 40, 30, 16
POSE = spherical_pose(30.0, -30.0, 4.0)
FOCAL = focal_from_angle(W, 0.6911112070083618)
HW, HH = 16, 12                      # hierarchical frames: 64 + 128 samples per ray
HFOCAL = focal_from_angle(HW, 0.6911112070083618)


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


def _trained(cfg):
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    return cfg.load(str(PARAMS))


@pytest.fixture(scope="module")
def xla_hier_frame():
    shared = _trained(JSharedModel(_white(jdefault(), "float32")))
    return XLAEngine(shared).render_image(POSE, (HW, HH), S, focal=HFOCAL,
                                          mode="hierarchical", monitor=False)


@pytest.mark.parametrize("engine", ["torch", "cuda", "cuda_fused"])
def test_hierarchical_frame_matches_xla_engine_f32(xla_hier_frame, engine):
    # float32 compute, coarse 64 + fine 128 depths: the benchmark mode's
    # rgb atol 1e-4 / >= 60 dB holds (the fine depths come from the same
    # sample_pdf arithmetic; the residual is encoding ulps and CDF sums)
    shared = _trained(SharedModel(_white(default_config(), "float32"), "cpu"))
    eng = (TorchEngine(shared) if engine == "torch" else
           CudaEngine(shared, fuse_composite=engine == "cuda_fused"))
    res = eng.render_image(POSE, (HW, HH), 999, focal=HFOCAL, mode="hierarchical")
    assert res.rgb.shape == (HH, HW, 3) and res.depth.shape == (HH, HW)
    np.testing.assert_allclose(res.rgb, xla_hier_frame.rgb, atol=1e-4, rtol=0)
    assert _psnr(res.rgb, xla_hier_frame.rgb) >= 60.0
    np.testing.assert_allclose(res.depth, xla_hier_frame.depth, atol=1e-3, rtol=0)


def test_cuda_engine_bf16_hierarchical_matches_pallas_engine():
    # both in bf16, each rounding at its own points; the bf16 coarse pass
    # moves the fine depths a little on both sides: >= 40 dB
    jshared = _trained(JSharedModel(_white(jdefault())))
    ref = PallasEngine(jshared, interpret=True).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, mode="hierarchical", monitor=False)
    shared = _trained(SharedModel(_white(default_config()), "cpu"))
    res = CudaEngine(shared).render_image(POSE, (HW, HH), S, focal=HFOCAL,
                                          mode="hierarchical", monitor=False)
    assert _psnr(res.rgb, ref.rgb) >= 40.0


@pytest.mark.parametrize("mode", ["benchmark", "hierarchical"])
def test_fused_cuda_engine_matches_fused_pallas_engine(mode):
    # fuse_composite on both sides, bf16: >= 40 dB, and the rgb within the
    # 5e-3 that tests/test_fused_composite.py allows between engines
    jshared = _trained(JSharedModel(_white(jdefault())))
    ref = PallasEngine(jshared, interpret=True, fuse_composite=True).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, mode=mode, monitor=False)
    shared = _trained(SharedModel(_white(default_config()), "cpu"))
    res = CudaEngine(shared, fuse_composite=True).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, mode=mode, monitor=False)
    assert _psnr(res.rgb, ref.rgb) >= 40.0
    assert np.max(np.abs(res.rgb - ref.rgb)) < 5e-3


def test_hierarchical_without_importance(monkeypatch):
    # use_importance=False (a uniform 128-sample fine pass): TorchEngine
    # renders it as XLAEngine does, to the float32 tolerances above, and so
    # does CudaEngine, through render_rays on the per-sample MLP kernel (K4)
    # and the planar compositor (K6), as PallasEngine does
    def uniform_fine(cfg):
        return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                   use_importance=False))

    jshared = _trained(JSharedModel(uniform_fine(_white(jdefault(), "float32"))))
    ref = XLAEngine(jshared).render_image(POSE, (HW, HH), S, focal=HFOCAL, mode="hierarchical",
                                          monitor=False)
    shared = _trained(SharedModel(uniform_fine(_white(default_config(), "float32")), "cpu"))
    res = TorchEngine(shared).render_image(POSE, (HW, HH), S, focal=HFOCAL,
                                           mode="hierarchical", monitor=False)
    np.testing.assert_allclose(res.rgb, ref.rgb, atol=1e-4, rtol=0)
    seen = []
    monkeypatch.setattr("nerf_tpu_torch.render.engines.fused_volume_render",
                        lambda *a: seen.append(a[0].shape[1]) or fused_volume_render(*a))
    cuda = CudaEngine(shared).render_image(POSE, (HW, HH), S, focal=HFOCAL,
                                           mode="hierarchical", monitor=False)
    assert seen == [64, 128]                 # K6's wrapper composited both passes
    np.testing.assert_allclose(cuda.rgb, ref.rgb, atol=1e-4, rtol=0)
    np.testing.assert_allclose(cuda.depth, ref.depth, atol=1e-3, rtol=0)
    # in bf16 against the Pallas engine on the same path (K4 + K6 there too):
    # each rounds at its own points, >= 40 dB
    pallas = PallasEngine(_trained(JSharedModel(uniform_fine(_white(jdefault())))),
                          interpret=True).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, mode="hierarchical", monitor=False)
    bf16 = CudaEngine(_trained(SharedModel(uniform_fine(_white(default_config())), "cpu"))
                      ).render_image(POSE, (HW, HH), S, focal=HFOCAL, mode="hierarchical",
                                     monitor=False)
    assert _psnr(bf16.rgb, pallas.rgb) >= 40.0
    with pytest.raises(ValueError, match="mode"):
        TorchEngine(shared).render_image(POSE, (HW, HH), S, mode="planar")


def test_cuda_engine_packs_both_networks_and_warms_each_mode(monkeypatch):
    shared = SharedModel(_white(default_config()), "cpu").load(None)
    eng = CudaEngine(shared, chunk_rays=64)
    packed = eng.engine_params()
    assert set(packed) == {"coarse", "fine"} and packed["coarse"] is not packed["fine"]
    assert eng.engine_params() is packed
    for net in ("coarse", "fine"):
        torch.testing.assert_close(packed[net].w0[:63],
                                   shared.params[net]["trunk"][0]["w"].bfloat16())
    same = SharedModel(_white(default_config()), "cpu")
    same.params = {"coarse": shared.params["fine"], "fine": shared.params["fine"]}
    calls = []
    monkeypatch.setattr("nerf_tpu_torch.render.engines.pack_params",
                        lambda *a: calls.append(1) or mlp_kernel.pack_params(*a))
    p2 = CudaEngine(same).engine_params()
    assert p2["coarse"] is p2["fine"] and len(calls) == 1
    # one warm-up frame per (mode, spp, chunk): a hierarchical frame after a
    # benchmark frame is warmed too
    eng.render_image(POSE, (8, 8), S, focal=10.0)
    eng.render_image(POSE, (8, 8), S, focal=10.0, mode="hierarchical")
    assert eng._warmed == {("benchmark", S, 64), ("hierarchical", S, 64)}


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

    # a trainer checkpoint (the JAX trainer's format): its params are read,
    # its optimizer state is not
    from nerf_tpu.train import checkpoint as jckpt
    from nerf_tpu.train.trainer import init_train_state as jinit_train_state

    jstate = jinit_train_state(jax.random.PRNGKey(3), jdefault())
    jckpt.save_checkpoint(str(tmp_path / "ckpt.npz"), jstate, {"step": 0})
    ck = SharedModel(cfg, "cpu").load(str(tmp_path / "ckpt.npz"))
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(ck.params["coarse"]),
                 jax.tree.map(np.asarray, jax.device_get(jstate.params["coarse"])))
    # a file with the header but no params is refused
    np.savez(tmp_path / "empty.npz", __meta__=np.frombuffer(b"{}", np.uint8))
    with pytest.raises(KeyError, match="a:params"):
        SharedModel(cfg, "cpu").load(str(tmp_path / "empty.npz"))


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
