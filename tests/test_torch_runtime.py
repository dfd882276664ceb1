"""The port's host runtime (``nerf_tpu_torch/runtime``) and the streaming
trainer on it, on the CPU: the library's build, its batches against the JAX
package's native sampler bit for bit, the camera model against the port's
``generate_rays``, tile assembly, no fallback when the build fails, and
``train_streaming`` (its descent, its determinism, and its first steps
against the JAX package's loss under optax's chain)."""

from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.train.trainer import make_optimizer as jmake_optimizer
from nerf_tpu_torch import runtime
from nerf_tpu_torch.data.synthetic import make_procedural_dataset
from nerf_tpu_torch.train.trainer import (
    NeRFTrainer,
    TrainState,
    make_optimizer,
    make_ray_train_step,
)
from nerf_tpu_torch.utils.cameras import generate_rays
from nerf_tpu_torch.utils.tree import tree_leaves
from test_torch_train import _both_params, _jax_cfg, _jax_loss, tiny_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny config's tensors are too small to share between threads, and
    several test workers' thread pools fighting for the cores slow these
    loops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return make_procedural_dataset(n_views=4, img_wh=(48, 48))


def _scene(seed=1, n=3, h=12, w=16):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    poses[:, :3, 3] = rng.normal(size=(n, 3))
    poses[:, 2, 3] += 4.0
    return images, poses


def _batches(sampler_cls, images, poses, focal, n_rays, seed, n=5):
    with sampler_cls(images, poses, focal, n_rays=n_rays, seed=seed) as s:
        return [s.next_batch() for _ in range(n)]


def test_library_builds_into_build_dir():
    lib = runtime.load_library()
    assert lib is runtime.load_library()
    path = runtime.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "nerf_tpu_torch"
    assert not list((ROOT / "nerf_tpu_torch").rglob("*.so"))


@pytest.mark.parametrize("seed", [7, 0])
def test_sampler_matches_the_jax_packages_native_sampler_bit_for_bit(seed):
    # the same C++ arithmetic and seed handling (seed 0 -> 1): the same
    # batches. The JAX package's numpy fallback draws other batches, so the
    # comparison needs its native library
    from nerf_tpu import runtime as jruntime

    if jruntime.load_library() is None:
        pytest.skip("the JAX package's native runtime does not load here (its numpy "
                    "fallback draws other batches)")
    images, poses = _scene()
    ours = _batches(runtime.RayBatchSampler, images, poses, 20.0, 256, seed)
    theirs = _batches(jruntime.RayBatchSampler, images, poses, 20.0, 256, seed)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.dtype == np.float32 and x.shape == (256, 3)
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(ours[0][1], ours[1][1])       # it samples


def test_sampled_rays_match_the_ports_generate_rays():
    # every sampled ray is a pixel's ray of the image it came from, with that
    # pixel's color (counterpart of tests/test_runtime.py)
    images, poses = _scene(seed=2)
    n, h, w, _ = images.shape
    focal = 20.0
    batches = _batches(runtime.RayBatchSampler, images, poses, focal, 256, seed=7, n=3)
    grids = [tuple(t.reshape(-1, 3).numpy() for t in
                   generate_rays(torch.as_tensor(poses[i]), w, h, focal, "cpu"))
             for i in range(n)]
    for rays_o, rays_d, rgb in batches:
        img = [i for i in range(n) if np.allclose(rays_o[0], grids[i][0][0], atol=1e-6)]
        assert len(img) == 1, "a batch's origin is no camera's"
        ro, rd = grids[img[0]]
        for k in range(0, 256, 17):
            dists = np.linalg.norm(rd - rays_d[k], axis=1)
            pix = int(np.argmin(dists))
            assert dists[pix] < 1e-5, f"ray {k} matches no pixel"
            np.testing.assert_allclose(rays_o[k], ro[pix], atol=1e-6)
            np.testing.assert_array_equal(rgb[k], images[img[0]].reshape(-1, 3)[pix])


def test_assemble_tiles_equals_the_jax_packages():
    from nerf_tpu.runtime import assemble_tiles as jassemble

    rng = np.random.default_rng(3)
    frame = rng.uniform(size=(100, 4)).astype(np.float32)
    cases = [([frame[0:30], frame[30:75], frame[75:100]], [0, 30, 75]),
             ([frame[50:90], frame[0:20]], [50, 0]),                  # out of order, gaps
             ([frame[10:10]], [10])]                                  # an empty tile
    for tiles, offsets in cases:
        ours = runtime.assemble_tiles(tiles, offsets, 100, 4)
        np.testing.assert_array_equal(ours, jassemble(tiles, offsets, 100, 4))
        want = np.zeros_like(frame)
        for t, off in zip(tiles, offsets):
            want[off:off + len(t)] = t
        np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(runtime.assemble_tiles([], [], 5, 3), np.zeros((5, 3)))


def test_assemble_tiles_skips_a_tile_past_the_frame_and_reads_the_next_from_its_own_data():
    tiles = [np.full((10, 2), 1.0, np.float32), np.full((5, 2), 2.0, np.float32)]
    out = runtime.assemble_tiles(tiles, [95, 0], 100, 2)
    assert (out[:5] == 2.0).all() and (out[5:] == 0.0).all()


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        runtime.load_library()
    images, poses = _scene()
    with pytest.raises(RuntimeError):
        runtime.RayBatchSampler(images, poses, 20.0, 64)
    assert runtime._lib is None and not list(tmp_path.glob("*.so"))


def test_train_streaming_descends_and_is_seeded(ds):
    # counterpart of tests/test_train.py::test_streaming_training_with_native_sampler,
    # and two runs from one seed are bit-equal
    def run():
        trainer = NeRFTrainer(tiny_config(), (48, 48), device="cpu")
        logs = []
        first = trainer.train_streaming(ds, n_steps=20, log_every=10, log_fn=logs.append)
        last = trainer.train_streaming(ds, n_steps=180, log_every=90, log_fn=logs.append)
        return trainer, first, last, logs

    a, first, last, logs = run()
    assert last < first, f"no descent: {first} -> {last}"
    assert len(logs) == 4 and logs[-1] == f"step 180/180 loss={last:.6f}"
    assert a.state.step == a.state.optimizer.count == 200 and a.train_losses == [first, last]
    assert a.sampler_blocked_s >= 0.0
    b, first_b, last_b, _ = run()
    assert (first_b, last_b) == (first, last)
    for (_, x), (_, y) in zip(tree_leaves(a.state.params), tree_leaves(b.state.params)):
        assert torch.equal(x, y)


def test_train_streaming_returns_the_last_logged_loss_as_the_jax_trainer_does(ds):
    # the last log point's loss where one was hit (step 4 of 5), else the
    # last step's, read once at the end
    trainer = NeRFTrainer(tiny_config(), (48, 48), device="cpu")
    logs = []
    last = trainer.train_streaming(ds, n_steps=5, log_every=2, log_fn=logs.append)
    assert len(logs) == 2 and logs[-1] == f"step 4/5 loss={last:.6f}"
    assert trainer.state.step == 5 and trainer.train_losses == [last]
    unlogged = trainer.train_streaming(ds, n_steps=3, log_every=10, log_fn=logs.append)
    assert len(logs) == 2 and np.isfinite(unlogged) and trainer.state.step == 8
    assert trainer.train_losses == [last, unlogged]


def test_streamed_steps_match_the_jax_package_under_optax(ds):
    # the slice against the JAX package: the first 5 batches of the port's
    # sampler through the port's deterministic ray step (no generator) and
    # through jax.grad of the JAX package's deterministic loss under optax's
    # chain, from the same parameters: params within 1e-5 (the optax test's
    # tolerance, tests/test_torch_train.py)
    cfg = tiny_config(learning_rate=3e-4)
    jcfg = _jax_cfg(cfg)
    batches = _batches(runtime.RayBatchSampler, ds.images, ds.poses, ds.focal, 96, seed=4)
    jp, tp = _both_params(cfg, 5)
    start = {k: leaf.detach().clone() for k, leaf in tree_leaves(tp)}
    opt = jmake_optimizer(jcfg)

    @jax.jit
    def jstep(params, opt_state, *rays):
        grads = jax.grad(lambda p: _jax_loss(jcfg, rays)(p))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt_state = opt.init(jp)
    state = TrainState(params=tp, optimizer=make_optimizer(cfg, tp), step=0)
    step = make_ray_train_step(cfg)
    for rays in batches:
        jp, opt_state = jstep(jp, opt_state, *rays)
        step(state, *(torch.as_tensor(a) for a in rays))
    ref = dict(tree_leaves(jax.device_get(jp)))
    for k, leaf in tree_leaves(state.params):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0,
                                   err_msg=str(k))
    moved = max(float((leaf.detach() - start[k]).abs().max())
                for k, leaf in tree_leaves(state.params))
    assert state.step == 5 and moved > 1e-3        # 5 steps of up to 3e-4 each, not nothing


# -- the PNG decoder (png.cpp) against the JAX package's native decoder ------

def _write_png16_rgba(path, rgba16):
    """A 16-bit RGBA PNG (colour type 6, depth 16: Pillow writes none), no
    row filter, one zlib stream."""
    import struct
    import zlib

    h, w, _ = rgba16.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba16.astype(">u2").view(np.uint8).reshape(h, -1)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


PNG_KINDS = ("rgb8", "rgba8", "grey", "grey_alpha", "rgba16", "palette_trns")


def _write_png(path, kind, w=13, h=9, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if kind == "rgb8":
        Image.fromarray(rgba[..., :3], "RGB").save(path)
    elif kind == "rgba8":
        Image.fromarray(rgba, "RGBA").save(path)
    elif kind == "grey":
        Image.fromarray(rgba[..., 0], "L").save(path)
    elif kind == "grey_alpha":
        Image.fromarray(rgba[..., :2].copy(), "LA").save(path)
    elif kind == "rgba16":
        _write_png16_rgba(path, rng.integers(0, 65536, (h, w, 4), dtype=np.uint16))
    else:   # 16 palette entries, each with its own alpha (a tRNS chunk)
        img = Image.fromarray((rgba[..., 0] % 16).astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 48, dtype=np.uint8).tolist())
        img.save(path, transparency=bytes(rng.integers(0, 256, 16, dtype=np.uint8).tolist()))
    return path


@pytest.fixture(scope="module")
def jax_decoder():
    from nerf_tpu import runtime as jruntime

    if jruntime.load_library() is None:
        pytest.skip("the JAX package's native runtime does not load here (it would decode "
                    "with PIL)")
    return jruntime.decode_png_batch


@pytest.mark.parametrize("size", [(13, 9), (20, 7)], ids=["own_size", "resized"])
@pytest.mark.parametrize("kind", PNG_KINDS)
def test_decode_png_batch_matches_the_jax_packages_decoder_bit_for_bit(kind, size, tmp_path,
                                                                       jax_decoder):
    paths = [str(_write_png(tmp_path / f"{kind}_{i}.png", kind, seed=i)) for i in range(3)]
    for white in (True, False):
        ref = jax_decoder(paths, size, white_background=white, n_threads=1)
        for threads in (1, 4):
            got = runtime.decode_png_batch(paths, size, white_background=white,
                                           n_threads=threads)
            assert got.shape == (3, size[1], size[0], 3) and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref, err_msg=f"white={white} threads={threads}")
    assert runtime.library_path("nerf_png").exists()
    assert runtime.library_path("nerf_png") != runtime.library_path()


def test_decode_png_batch_at_its_own_size_is_the_composite(tmp_path):
    # no resampling: each pixel is its bytes / 255, composited as rgb a + (1 - a)
    from PIL import Image

    rgba = np.random.default_rng(3).integers(0, 256, (9, 13, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "a.png")
    f = rgba.astype(np.float32) / np.float32(255)
    a = f[..., 3:]
    got = runtime.decode_png_batch([str(tmp_path / "a.png")], (13, 9))
    np.testing.assert_array_equal(got[0], f[..., :3] * a + (np.float32(1) - a))
    got = runtime.decode_png_batch([tmp_path / "a.png"], (13, 9), white_background=False)
    np.testing.assert_array_equal(got[0], f[..., :3])
    assert runtime.decode_png_batch([], (13, 9)).shape == (0, 9, 13, 3)


def test_decode_png_batch_raises_naming_the_files_that_failed(tmp_path):
    good = str(_write_png(tmp_path / "good.png", "rgba8"))
    corrupt = tmp_path / "corrupt.png"
    corrupt.write_bytes(open(good, "rb").read()[:60])
    missing = str(tmp_path / "missing.png")
    with pytest.raises(RuntimeError, match="2 of 3 PNGs") as e:
        runtime.decode_png_batch([good, str(corrupt), missing], (13, 9))
    assert str(corrupt) in str(e.value) and missing in str(e.value) and good not in str(e.value)
    with pytest.raises(ValueError):
        runtime.decode_png_batch(["a\nb.png"], (13, 9))


def test_failed_png_build_raises_and_leaves_the_ray_producer_alone(monkeypatch, tmp_path):
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_png_lib", None)
    monkeypatch.setitem(runtime.LIBRARIES, "nerf_png",
                        (runtime.PNG_SOURCE, ("-DNO_SUCH_HEADER",), ("-lnerf_no_such_library",)))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.decode_png_batch([str(tmp_path / "x.png")], (4, 4))
    assert runtime._png_lib is None and not list(tmp_path.glob("libnerf_png*.so"))
    # the ray producer's library links no libpng
    assert "-lpng" not in runtime.LIBRARIES["nerf_runtime"][2]
