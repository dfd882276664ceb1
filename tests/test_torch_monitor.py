"""The port's frame monitor (``nerf_tpu_torch/utils/monitor.py``): its host
memory is the peak resident set over the window, as the JAX package's
``PerformanceMonitor`` polls it, not the process's lifetime peak; and the
device label, the device peak and the profiler trace of the benchmark
suite."""

import json
import os
import resource
import time

import numpy as np
import pytest
import torch

from nerf_tpu_torch.utils.monitor import PerformanceMonitor


def _rss_mb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6


def _lifetime_peak_mb():
    # ru_maxrss is in KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e6


def test_window_peak_is_not_the_lifetime_peak():
    # a ~200 MB array, touched and freed, raises the lifetime peak; a window
    # opened after it around a small allocation reads its own, lower peak
    big = np.ones(200 * 2 ** 20 // 8)
    big[::512] = 2.0
    del big
    mon = PerformanceMonitor("cpu").start()
    small = np.ones(2 ** 20 // 8)
    time.sleep(0.05)                       # a few polls of the thread
    stats = mon.stop()
    del small
    assert stats.peak_device_mb is None and stats.device_kind == "cpu"
    assert stats.peak_host_rss_mb > 0.0
    assert stats.peak_host_rss_mb <= _lifetime_peak_mb() - 100.0, (
        stats.peak_host_rss_mb, _lifetime_peak_mb())


def test_window_peak_sees_an_allocation_inside_it():
    # an allocation of ~100 MB made and freed inside the window counts in
    # its peak, though the resident set at stop is back below it
    mon = PerformanceMonitor("cpu").start()
    before = _rss_mb()
    buf = np.ones(100 * 2 ** 20 // 8)
    time.sleep(0.05)
    del buf
    after = _rss_mb()
    stats = mon.stop()
    assert stats.peak_host_rss_mb >= before + 90.0 > after - 10.0
    assert stats.wall_time_s >= 0.05


def test_device_helpers_on_the_cpu():
    # the JAX label's format, "{PLATFORM} - {kind}"; no device peak on the CPU
    from nerf_tpu_torch.utils.monitor import device_info_string, device_peak_memory_mb

    assert device_info_string("cpu") == "CPU - cpu"
    assert device_info_string(torch.device("cpu")) == "CPU - cpu"
    assert device_peak_memory_mb("cpu") is None
    assert PerformanceMonitor("cpu").start().stop().peak_device_mb is None


def test_engines_describe_themselves_and_label_rows_with_their_device():
    from nerf_tpu_torch.config import default_config
    from nerf_tpu_torch.render.engines import ENGINE_CLASSES, Engine, SharedModel

    shared = SharedModel(default_config(), "cpu")
    descriptions = set()
    for name, cls in ENGINE_CLASSES.items():
        engine = cls(shared)
        assert engine.device_info() == "CPU - cpu"
        assert cls.description != Engine.description and cls.description
        descriptions.add(cls.description)
    assert len(descriptions) == len(ENGINE_CLASSES)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from nerf_tpu_torch.utils.monitor import profile_trace

    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list((tmp_path / "trace").iterdir())
    assert [str(f) for f in files] == [prof.trace_path]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_profile_trace_raises_where_it_cannot_write(tmp_path):
    # unlike the JAX helper, a trace that cannot be written is an error
    from nerf_tpu_torch.utils.monitor import profile_trace

    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        with profile_trace(str(blocker / "trace")):
            pass
