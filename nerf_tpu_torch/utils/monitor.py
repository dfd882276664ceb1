"""Frame timing and peak memory for ``Engine.render_image``.

Counterpart of ``PerfStats``/``PerformanceMonitor`` in
``nerf_tpu/utils/monitor.py``, reduced to what the render needs: wall time
between two ``torch.cuda.synchronize()`` fences, the peak of
``torch.cuda.max_memory_allocated`` over the window as device memory, and
the process's peak resident set from ``resource.getrusage`` as host memory.
The profiler trace and device-info helpers arrive with the benchmark slice.
"""

from __future__ import annotations

import resource
import time
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class PerfStats:
    wall_time_s: float = 0.0
    peak_host_rss_mb: float = 0.0
    peak_device_mb: Optional[float] = None   # None on the CPU
    device_kind: str = "unknown"


class PerformanceMonitor:
    """``mon.start(); ...; stats = mon.stop()``"""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._t0 = 0.0

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def start(self) -> "PerformanceMonitor":
        if self._cuda():
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> PerfStats:
        if self._cuda():
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._t0
        # ru_maxrss is in KiB on Linux
        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e6
        if self._cuda():
            peak = torch.cuda.max_memory_allocated(self.device) / 1e6
            kind = torch.cuda.get_device_name(self.device)
        else:
            peak, kind = None, "cpu"
        return PerfStats(wall_time_s=wall, peak_host_rss_mb=rss_mb,
                         peak_device_mb=peak, device_kind=kind)
