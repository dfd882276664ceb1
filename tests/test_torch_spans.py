"""The port's own profiler spans (``utils/monitor.span``): none is made
while no profiler records; under a CPU profiler each frame, chunk and
kernel wrapper call records exactly one, the occupancy glue and the
kernel wrappers inside their chunk."""

import dataclasses
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_tpu_torch.config import default_config
from nerf_tpu_torch.render.engines import AccelEngine, CompressedEngine, CudaEngine, SharedModel
from nerf_tpu_torch.utils import monitor
from nerf_tpu_torch.utils.cameras import spherical_pose

W, H, CHUNK = 12, 8, 40              # 96 rays: three chunks, the last padded
CHUNKS = 3
POSE = spherical_pose(30.0, -30.0, 4.0)
FOCAL = 10.0
FRAME = ("engine.rays", "engine.assemble", "engine.to_host")

# engine, its arguments, the render mode, whether the fine pass is uniform,
# and the kernel spans of one chunk
PATHS = {
    "hierarchical": (CudaEngine, {}, "hierarchical", True,
                     {"kernel.k1": 1, "kernel.k2": 2, "kernel.k3": 1}),
    "fused": (CudaEngine, {"fuse_composite": True}, "hierarchical", True,
              {"kernel.k1": 1, "kernel.k3": 1}),
    "planar": (CudaEngine, {"planar": True}, "hierarchical", True,
               {"kernel.k1": 1, "kernel.k6": 2, "kernel.k3": 1}),
    "benchmark": (CudaEngine, {}, "benchmark", True, {"kernel.k1": 1, "kernel.k2": 1}),
    "uniform": (CudaEngine, {}, "hierarchical", False, {"kernel.k4": 2, "kernel.k6": 2}),
    "compressed-uniform": (CompressedEngine, {}, "hierarchical", False,
                           {"kernel.k7": 2, "kernel.k6": 2}),
    "accel": (AccelEngine, {"grid_resolution": 16, "probe_resolution": 8}, "benchmark", True,
              {"kernel.k3": 1, "kernel.k2": 1}),
}


def _engine(path):
    cls, kw, _, importance, _ = PATHS[path]
    cfg = default_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, n_coarse=8, n_fine=8, white_background=True, use_importance=importance))
    return cls(SharedModel(cfg, "cpu").load(None), chunk_rays=CHUNK, **kw)


def _frame(engine, path):
    return engine.render_image(POSE, (W, H), 8, focal=FOCAL, mode=PATHS[path][2],
                               monitor=False)


def _traced_frame(path):
    """The span events ``(name, start_us, end_us)`` of one frame after a
    warm frame (the accel engine bakes its grid in its first frame)."""
    engine = _engine(path)
    _frame(engine, path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(engine, path)
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(("engine.", "kernel.", "occupancy."))]


def test_span_is_a_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert monitor.span("a") is monitor.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(monitor.span("a"), torch.profiler.record_function)


@pytest.mark.parametrize("path", ["hierarchical", "accel"])
def test_no_record_function_without_a_profiler(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler recording")

    monkeypatch.setattr(monitor, "record_function", refuse)
    engine = _engine(path)
    for _ in range(2):
        res = _frame(engine, path)
    assert res.rgb.shape == (H, W, 3)


@pytest.mark.parametrize("path", list(PATHS))
def test_one_span_a_frame_a_chunk_and_a_kernel_call(path):
    counts = Counter(name for name, _, _ in _traced_frame(path))
    want = {name: 1 for name in FRAME}
    want["engine.chunk"] = CHUNKS
    if path == "accel":
        want["occupancy.z_vals"] = CHUNKS
    want.update({name: n * CHUNKS for name, n in PATHS[path][4].items()})
    assert dict(counts) == want


@pytest.mark.parametrize("path", ["hierarchical", "accel", "uniform"])
def test_glue_and_dispatch_spans_lie_inside_a_chunk(path):
    events = _traced_frame(path)
    chunks = [(a, b) for name, a, b in events if name == "engine.chunk"]
    inner = [(name, a, b) for name, a, b in events
             if name.startswith(("kernel.", "occupancy."))]
    assert inner and all(any(c0 <= a and b <= c1 for c0, c1 in chunks) for _, a, b in inner)
    frame = {name: (a, b) for name, a, b in events if name in FRAME}
    # in the frame's order: the rays, the chunks, the image, its copy
    assert frame["engine.rays"][1] <= min(a for a, _ in chunks)
    assert max(b for _, b in chunks) <= frame["engine.assemble"][0]
    assert frame["engine.assemble"][1] <= frame["engine.to_host"][0]


def test_the_bake_records_its_k4_calls_in_the_first_chunk():
    engine = _engine("accel")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(engine, "accel")
    names = [e.name for e in prof.events() if e.name.startswith("kernel.")]
    assert names.count("kernel.k4") >= 1
    assert names.count("kernel.k3") == CHUNKS and names.count("kernel.k2") == CHUNKS
