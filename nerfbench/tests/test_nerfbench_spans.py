"""The span readers (``spans.py`` and the six metrics that read the port's
own spans) on a real ``trace.Trace`` of a tiny accel frame rendered by the
program on the CPU, and ``spans.idle_s`` against busy intervals made by
hand."""

import dataclasses

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from nerfbench import harness, spans, trace

READERS = ["frame_idle_ms.render", "frame_idle_ms.accel", "glue_host_ms.accel",
           "glue_idle_ms.accel", "dispatch_host_ms.accel", "dispatch_idle_ms.accel"]
NAMES = [spans.FRAME, spans.GLUE, spans.DISPATCH]
FRAMES = 2


@pytest.fixture(scope="module")
def traced():
    from nerf_tpu_torch.config import default_config
    from nerf_tpu_torch.render.engines import AccelEngine, SharedModel
    from nerf_tpu_torch.utils.cameras import spherical_pose

    cfg = default_config()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, white_background=True))
    engine = AccelEngine(SharedModel(cfg, "cpu").load(None), chunk_rays=64,
                         grid_resolution=16, probe_resolution=8)
    pose = spherical_pose(30.0, -30.0, 4.0)
    engine.render_image(pose, (16, 12), 8, focal=12.0, monitor=False)     # the bake
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(FRAMES):
                engine.render_image(pose, (16, 12), 8, focal=12.0, monitor=False)
    return harness.Traced(trace.Trace(prof, trace.port_kernels(harness.PACKAGE)), FRAMES, {})


def _with(tr, **attrs):
    """A copy of ``tr`` with some attributes replaced."""
    out = object.__new__(trace.Trace)
    out.__dict__.update({**tr.__dict__, **attrs})
    return out


def test_the_cpu_trace_has_no_device_work(traced):
    assert traced.trace.device == [] and traced.trace.busy_intervals() == []


@pytest.mark.parametrize("names", NAMES, ids=["frame", "glue", "dispatch"])
def test_idle_equals_host_without_device_events(traced, names):
    tr = traced.trace
    assert spans.intervals(tr, names)
    assert spans.host_s(tr, names) > 0
    assert spans.idle_s(tr, names) == pytest.approx(spans.host_s(tr, names), rel=1e-12)


@pytest.mark.parametrize("metric", READERS)
def test_readers_on_a_real_trace(traced, metric):
    spec = next(m for m in harness.benchmark()["per_layer"] if m["name"] == metric)
    module = harness.reader(metric)
    assert (module.LAYER, module.UNIT, module.MOVES) == (spec["layer"], spec["unit"],
                                                          spec["moves"])
    value = module.read(traced)
    assert value is not None and value > 0
    # a frame's host time in the span, not the window's
    assert value < traced.trace.window_s * 1e3 / FRAMES


def test_host_and_idle_readers_agree_without_device_events(traced):
    read = {m: harness.reader(m).read(traced) for m in READERS}
    assert read["glue_idle_ms.accel"] == pytest.approx(read["glue_host_ms.accel"])
    assert read["dispatch_idle_ms.accel"] == pytest.approx(read["dispatch_host_ms.accel"])
    assert read["frame_idle_ms.accel"] == read["frame_idle_ms.render"]


def test_intervals_are_merged_clipped_and_disjoint(traced):
    tr = traced.trace
    for names in NAMES:
        ivs = spans.intervals(tr, names)
        assert all(tr.t0 <= a < b <= tr.t1 for a, b in ivs)
        assert all(b0 < a1 for (_, b0), (a1, _) in zip(ivs, ivs[1:]))
    # one glue span a chunk, three chunks a frame
    n_chunks = sum(1 for c in tr.cpu if c[0] == "engine.chunk")
    assert n_chunks == 3 * FRAMES
    assert len(spans.intervals(tr, spans.GLUE)) == n_chunks


def test_readers_read_none_without_the_ports_spans(traced):
    bare = dataclasses.replace(traced, trace=_with(traced.trace, cpu=[
        c for c in traced.trace.cpu if not c[0].startswith(("engine.", "kernel.", "occupancy."))]))
    assert all(harness.reader(m).read(bare) is None for m in READERS)


def test_idle_on_busy_intervals_that_partly_cover_a_span(traced):
    tr = traced.trace
    a, b = spans.intervals(tr, spans.GLUE)[0]
    d = b - a
    # busy from before the span to a quarter in, a tenth in the middle, and
    # from 0.9 to past the span's end: 0.25 + 0.1 + 0.1 of it covered
    made = _with(tr, device=[("k", a - 5.0, a + 0.25 * d), ("k", a + 0.5 * d, a + 0.6 * d),
                             ("k", a + 0.9 * d, b + 5.0)])
    host = spans.host_s(made, spans.GLUE)
    assert spans.idle_s(made, spans.GLUE) == pytest.approx(host - 0.45 * d * 1e-6, rel=1e-9)
    # one interval over the whole window: nothing idle
    full = _with(tr, device=[("k", tr.t0, tr.t1)])
    assert spans.idle_s(full, spans.GLUE) == 0.0
    assert spans.host_s(full, spans.GLUE) == pytest.approx(host)


@pytest.mark.parametrize("given, union", [
    ([], []),
    ([(3.0, 4.0), (1.0, 2.0)], [(1.0, 2.0), (3.0, 4.0)]),
    ([(1.0, 3.0), (2.0, 4.0)], [(1.0, 4.0)]),
    ([(1.0, 2.0), (2.0, 3.0)], [(1.0, 3.0)]),
    ([(1.0, 5.0), (2.0, 3.0), (4.0, 6.0)], [(1.0, 6.0)]),
])
def test_merge_is_the_sorted_disjoint_union(given, union):
    assert spans.merge(given) == union
