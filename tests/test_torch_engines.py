"""The whole slice: port engines vs the JAX engines on the same trained
weights and camera, in the benchmark and hierarchical modes, with
``fuse_composite``, the bf16 and planar intermediates, on quantized
weights (the compressed and int8-compute engines) and with depths placed
from an occupancy grid (the accel engine), plus the registry, weight
loading and device selection."""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from nerf_tpu.config import default_config as jdefault
from nerf_tpu.models.nerf import init_nerf_params as jinit, params_to_torch_state_dict
from nerf_tpu.render import engines as jengines
from nerf_tpu.render.engines import PallasEngine, SharedModel as JSharedModel, XLAEngine
from nerf_tpu.utils.cameras import focal_from_angle, spherical_pose
from nerf_tpu_torch.config import bmild_config, default_config
from nerf_tpu_torch.models.nerf import params_to_numpy
from nerf_tpu_torch.ops import mlp_kernel
from nerf_tpu_torch.ops.composite_kernel import fused_volume_render
from nerf_tpu_torch.ops import quant
from nerf_tpu_torch.render import engines
from nerf_tpu_torch.render.engines import (
    AccelEngine,
    CompressedEngine,
    CudaEngine,
    Int8ComputeEngine,
    SharedModel,
    TorchEngine,
    available_engines,
)
from nerf_tpu_torch.ops.occupancy import build_occupancy_grid as occ_build
from nerf_tpu_torch.utils.cameras import generate_rays
from nerf_tpu_torch.utils.device import torch_dtype
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


def test_cuda_engine_follows_reloaded_weights():
    # SharedModel.load with other weights: the cuda engine's next frame is
    # rendered from them, as PallasEngine's is (it reads shared.params every
    # frame); against TorchEngine on the new weights at this file's float32
    # tolerance
    shared = SharedModel(_white(default_config(), "float32"), "cpu").load(seed=0)
    eng = CudaEngine(shared)
    first = eng.render_image(POSE, (W, H), S, focal=FOCAL, monitor=False)
    shared.load(seed=1)
    again = eng.render_image(POSE, (W, H), S, focal=FOCAL, monitor=False)
    ref = TorchEngine(shared).render_image(POSE, (W, H), S, focal=FOCAL, monitor=False)
    assert np.abs(again.rgb - first.rgb).max() > 1e-2
    np.testing.assert_allclose(again.rgb, ref.rgb, atol=1e-4, rtol=0)
    np.testing.assert_allclose(again.depth, ref.depth, atol=1e-3, rtol=0)
    packed = eng.engine_params()
    assert eng.engine_params() is packed                   # packed once per load


@pytest.mark.parametrize("name", ["compressed", "int8"])
def test_quantized_engines_keep_their_first_quantization(name):
    # the JAX package's CompressedEngine quantizes once, lazily, and keeps
    # it across SharedModel.load; the port's quantized engines do the same
    shared = SharedModel(_white(default_config()), "cpu").load(seed=0)
    eng = engines.ENGINE_CLASSES[name](shared)
    q = eng.engine_params()
    first = eng.render_image(POSE, (8, 6), S, focal=10.0, monitor=False)
    shared.load(seed=1)
    assert eng.engine_params() is q
    again = eng.render_image(POSE, (8, 6), S, focal=10.0, monitor=False)
    np.testing.assert_array_equal(again.rgb, first.rgb)
    jc = jdefault().model
    jshared = JSharedModel(_white(jdefault()))
    jshared.params = {k: jinit(jax.random.PRNGKey(i), jc) for i, k in enumerate(("coarse", "fine"))}
    jeng = jengines.ENGINE_CLASSES[name](jshared, interpret=True)
    jq = jeng.engine_params()
    jshared.params = {k: jinit(jax.random.PRNGKey(i + 2), jc)
                      for i, k in enumerate(("coarse", "fine"))}
    assert jeng.engine_params() is jq


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


# Both packages compute in bf16 on the same quantized weights (bit-equal,
# tests/test_torch_quant.py), each rounding activations at its own points.
# Measured on these 16 x 12 frames: compressed 70.3 dB (benchmark) and 79.1
# dB (hierarchical), int8 60.7 and 71.8 dB between the packages. int8 sits
# lower: where a bf16 activation rounds the other way the row's int8 scale
# moves and its 256 roundings are drawn again, so the engines differ there
# by the route's own quantization noise (~39 dB against float32). Held to
# >= 55 dB and >= 48 dB. Against the float32 engine: the JAX package's own
# bars for these engines, 0.15 a pixel (tests/test_engines.py, compressed)
# and 20 dB.
QUANT_ENGINE_DB = {"compressed": 55.0, "int8": 48.0}


@pytest.mark.parametrize("mode", ["benchmark", "hierarchical"])
@pytest.mark.parametrize("name", ["compressed", "int8"])
def test_quantized_engines_match_jax_engines(xla_hier_frame, name, mode):
    jshared = _trained(JSharedModel(_white(jdefault())))
    ref = jengines.ENGINE_CLASSES[name](jshared, interpret=True).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, mode=mode, monitor=False)
    shared = _trained(SharedModel(_white(default_config()), "cpu"))
    eng = engines.ENGINE_CLASSES[name](shared)
    res = eng.render_image(POSE, (HW, HH), S, focal=HFOCAL, mode=mode, monitor=False)
    assert res.rgb.shape == (HH, HW, 3) and np.isfinite(res.depth).all()
    db = _psnr(res.rgb, ref.rgb)
    print(f"{name} {mode}: {db:.1f} dB against the JAX engine")
    assert db >= QUANT_ENGINE_DB[name]
    f32 = (xla_hier_frame if mode == "hierarchical" else XLAEngine(
        _trained(JSharedModel(_white(jdefault(), "float32")))).render_image(
            POSE, (HW, HH), S, focal=HFOCAL, monitor=False))
    for frame in (res.rgb, ref.rgb):
        assert _psnr(frame, f32.rgb) > 20.0
        if name == "compressed":
            np.testing.assert_allclose(frame, f32.rgb, atol=0.15)
    # the stats report: the sizes and the sparsity the JAX engine reports
    # (its compressed size counts its own wider layout, tests/test_torch_quant.py)
    stats, jstats = eng.compression_stats(), jengines.ENGINE_CLASSES[name](
        jshared, interpret=True).compression_stats()
    assert stats["act_bits"] == jstats["act_bits"] == (8 if name == "int8" else None)
    for net in ("coarse", "fine"):
        assert stats["networks"][net]["original_mb"] == jstats["networks"][net]["original_mb"]
        assert stats["networks"][net]["sparsity"] == pytest.approx(
            jstats["networks"][net]["sparsity"], abs=1e-12)
        assert 3.0 < stats["networks"][net]["compression_ratio"] < 4.5


def test_compressed_engine_quantizes_once_and_uses_k7_without_importance(monkeypatch):
    shared = SharedModel(_white(default_config()), "cpu").load(None)
    eng = CompressedEngine(shared, chunk_rays=64)
    assert (eng.bits, eng.prune_fraction, eng.act_bits, eng.pos_bound) == (8, 0.1, None, 12.0)
    q = eng.engine_params()
    assert eng.engine_params() is q and set(q) == {"coarse", "fine"}
    assert isinstance(q["fine"], quant.QuantizedPackedWeights) and q["fine"].wt_q.dtype == torch.int8
    assert CompressedEngine(shared, bits=16).engine_params()["fine"].wt_q.dtype == torch.int16
    i8 = Int8ComputeEngine(shared)
    assert i8.act_bits == 8 and isinstance(i8.engine_params()["fine"], quant.Int8PackedWeights)
    # quantized from the float32 params, not from bf16-rounded ones
    want = quant.quantize_model(shared.params, shared.cfg.model)[0]["fine"]
    assert torch.equal(q["fine"].wt_q, want.wt_q) and torch.equal(q["fine"].wt_s, want.wt_s)
    with pytest.raises(ValueError, match="int8 compute"):
        CompressedEngine(shared, bits=16, act_bits=8).engine_params()
    # use_importance=False: render_rays on the dequantize-in-kernel MLP (K7's
    # wrapper) and the planar compositor
    cfg = _white(default_config())
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, use_importance=False, n_coarse=8, n_fine=8))
    uni = SharedModel(cfg, "cpu")
    uni.params = shared.params
    seen = []
    monkeypatch.setattr("nerf_tpu_torch.ops.quant.quantized_nerf_apply_plain",
                        lambda q, *a: seen.append(type(q).__name__)
                        or quant.fused_nerf_apply_plain(quant.dequantize(q, a[3]), *a[:3]))
    res = CompressedEngine(uni).render_image(POSE, (8, 6), S, focal=10.0, mode="hierarchical",
                                             monitor=False)
    assert seen == ["QuantizedPackedWeights"] * 2 and np.isfinite(res.rgb).all()


def test_engine_registry():
    assert list(engines.ENGINE_CLASSES) == ["torch", "cuda", "compressed", "int8", "accel"]
    assert engines.ENGINE_CLASSES["int8"] is Int8ComputeEngine
    assert engines.ENGINE_CLASSES["compressed"] is CompressedEngine
    assert engines.ENGINE_CLASSES["accel"] is AccelEngine
    # the JAX registry's names one for one, with the port's for its first two
    assert list(jengines.ENGINE_CLASSES) == ["xla", "pallas", "compressed", "int8", "accel"]
    shared = SharedModel(_white(default_config()), "cpu").load(None)
    got = available_engines(shared, names=["torch", "int8"])
    assert list(got) == ["torch", "int8"] and all(e.shared is shared for e in got.values())
    assert {n: type(e) for n, e in available_engines(shared).items()} == engines.ENGINE_CLASSES

    class Broken(TorchEngine):
        def __init__(self, shared):
            raise RuntimeError("no such device")

    engines.ENGINE_CLASSES["broken"] = Broken
    try:
        assert "broken" not in available_engines(shared)     # skipped, not raised
    finally:
        del engines.ENGINE_CLASSES["broken"]


@pytest.mark.parametrize("mode", ["benchmark", "hierarchical"])
@pytest.mark.parametrize("form", ["raw_bf16", "planar"])
def test_cuda_engine_output_forms_match_pallas_engine(form, mode):
    # CudaEngine(raw_dtype="bfloat16") and CudaEngine(planar=True) route as
    # PallasEngine does; bf16 on both sides, >= 40 dB. On the CPU the planar
    # frame is the interleaved one exactly (the plain compositor stacks the
    # planes); the bf16 intermediate costs at most bf16's rounding of rgb
    kw = {"raw_dtype": "bfloat16"} if form == "raw_bf16" else {"planar": True}
    jshared = _trained(JSharedModel(_white(jdefault())))
    ref = PallasEngine(jshared, interpret=True, **kw).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, mode=mode, monitor=False)
    shared = _trained(SharedModel(_white(default_config()), "cpu"))
    eng = CudaEngine(shared, fuse_composite=True, **kw)
    assert eng.fuse_composite == (form != "planar")          # planar switches it off
    eng = CudaEngine(shared, **kw)
    res = eng.render_image(POSE, (HW, HH), S, focal=HFOCAL, mode=mode, monitor=False)
    assert _psnr(res.rgb, ref.rgb) >= 40.0
    plain = CudaEngine(shared).render_image(POSE, (HW, HH), S, focal=HFOCAL, mode=mode,
                                            monitor=False)
    if form == "planar":
        np.testing.assert_array_equal(res.rgb, plain.rgb)
    else:
        assert np.abs(res.rgb - plain.rgb).max() < 2e-2
        assert _psnr(res.rgb, plain.rgb) >= 45.0


ACCEL_GRID = 32                      # the accel tests' grid: a short bake for the JAX engine


@pytest.mark.parametrize("fuse", [False, True])
def test_accel_engine_matches_jax_accel_engine(fuse):
    # the benchmark mode of both accel engines, bf16, on a 32^3 grid baked by
    # each (the port's through K4's plain version): grid_guided_z_vals -> K3
    # -> K2, or the composited K3; >= 40 dB, as the other bf16 engine tests
    jshared = _trained(JSharedModel(_white(jdefault())))
    ref = jengines.AccelEngine(jshared, interpret=True, grid_resolution=ACCEL_GRID,
                               fuse_composite=fuse).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, monitor=False)
    shared = _trained(SharedModel(_white(default_config()), "cpu"))
    eng = AccelEngine(shared, grid_resolution=ACCEL_GRID, fuse_composite=fuse)
    res = eng.render_image(POSE, (HW, HH), S, focal=HFOCAL, monitor=False)
    assert _psnr(res.rgb, ref.rgb) >= 40.0
    assert np.isfinite(res.depth).all() and res.rgb.std() > 0.05
    grid = eng.occupancy_grid()
    assert grid.resolution == ACCEL_GRID and 0.0 < float((grid.occupancy > 5.0).float().mean()) < 0.5
    # the hierarchical mode is the cuda engine's
    hier = eng.render_image(POSE, (HW, HH), S, focal=HFOCAL, mode="hierarchical", monitor=False)
    want = CudaEngine(shared, fuse_composite=fuse).render_image(
        POSE, (HW, HH), S, focal=HFOCAL, mode="hierarchical", monitor=False)
    np.testing.assert_array_equal(hier.rgb, want.rgb)


def test_accel_engine_bakes_once_in_the_warm_frame(monkeypatch):
    # the first benchmark frame bakes (under the monitor: in its untimed warm
    # frame), the next frames and the hierarchical mode do not; the grid is
    # the dilated mip when 0 < probe_resolution < grid_resolution
    shared = SharedModel(_white(default_config()), "cpu").load(None)
    bakes = []
    monkeypatch.setattr(engines, "build_occupancy_grid",
                        lambda *a, **k: bakes.append(k) or occ_build(*a, **k))
    eng = AccelEngine(shared, chunk_rays=64, grid_resolution=16, probe_resolution=8)
    eng.render_image(POSE, (8, 8), S, focal=10.0, mode="hierarchical")
    assert bakes == [] and eng._grid is None
    real_render = eng._render

    def render(*a):
        calls.append(eng._grid is None)
        return real_render(*a)

    calls = []
    monkeypatch.setattr(eng, "_render", render)
    eng.render_image(POSE, (8, 8), S, focal=10.0)
    assert calls == [True, False] and len(bakes) == 1      # warm frame baked, timed did not
    eng.render_image(POSE, (8, 8), S, focal=10.0)
    eng.render_image(POSE, (8, 8), 2 * S, focal=10.0, monitor=False)
    assert len(bakes) == 1 and bakes[0]["resolution"] == 16
    assert eng.occupancy_grid().resolution == 8 and eng.occupancy_grid() is eng._grid


def test_accel_bake_is_bf16_through_k4_whatever_the_compute_dtype(monkeypatch):
    # the JAX engine bakes with build_occupancy_grid's default bf16 whatever
    # compute_dtype says; the port bakes through K4 on bf16 packed weights
    seen = []
    monkeypatch.setattr(engines, "build_occupancy_grid",
                        lambda p, *a, **k: seen.append(p) or occ_build(p, *a, **k))
    grids = {}
    for dtype in ("bfloat16", "float32"):
        shared = SharedModel(_white(default_config(), dtype), "cpu").load(seed=3)
        eng = AccelEngine(shared, grid_resolution=16, probe_resolution=0)
        grids[dtype] = eng.occupancy_grid().occupancy
        assert eng.engine_params()["fine"].w0.dtype == torch_dtype(dtype)
    assert all(isinstance(p, mlp_kernel.PackedWeights) and p.w0.dtype == torch.bfloat16
               for p in seen)
    torch.testing.assert_close(grids["float32"], grids["bfloat16"], rtol=0, atol=0)


def test_accel_quality_against_truth_matches_the_jax_engine():
    # the JAX suite's gt_quality_report on a small frame: each package's
    # accel frame and uniform frame against float32 truth at 256 uniform
    # samples. The two packages agree to 0.1 dB at each count; at 16 samples
    # the accel frame is no more than 0.5 dB under the uniform one (the JAX
    # package's own gate and count). At 64 samples it is not on a frame this
    # small, in both packages alike: a group of 4 rays that share one probe
    # profile spans a sixth of the width, so the silhouette's rays sample
    # from their neighbours' profiles (chip_smoke.py holds the gate at every
    # count at 200 x 150)
    w, h, pose = 24, 18, spherical_pose(47.0, -30.0, 4.0)
    focal = focal_from_angle(w, 0.6911112070083618)
    kw = dict(grid_resolution=64, probe_resolution=32)
    truth = XLAEngine(_trained(JSharedModel(_white(jdefault(), "float32")))).render_image(
        pose, (w, h), 256, focal=focal, monitor=False).rgb
    jshared = _trained(JSharedModel(_white(jdefault())))
    jacc, juni = jengines.AccelEngine(jshared, interpret=True, **kw), XLAEngine(jshared)
    shared = _trained(SharedModel(_white(default_config()), "cpu"))
    acc, uni = AccelEngine(shared, **kw), CudaEngine(shared)
    for spp in (16, 64):
        db = {name: _psnr(eng.render_image(pose, (w, h), spp, focal=focal, monitor=False).rgb,
                          truth)
              for name, eng in (("jax_accel", jacc), ("jax_uniform", juni), ("accel", acc),
                                ("uniform", uni))}
        assert abs(db["accel"] - db["jax_accel"]) < 0.1, db
        assert abs(db["uniform"] - db["jax_uniform"]) < 0.1, db
        if spp == 16:
            assert db["accel"] >= db["uniform"] - 0.5, db
