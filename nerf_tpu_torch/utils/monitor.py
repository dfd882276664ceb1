"""Frame timing and peak memory for ``Engine.render_image``.

Counterpart of ``PerfStats``/``PerformanceMonitor`` in
``nerf_tpu/utils/monitor.py``, reduced to what the render needs: wall time
between two ``torch.cuda.synchronize()`` fences, the peak of
``torch.cuda.max_memory_allocated`` over the window as device memory, and
the peak resident set of the process over the window as host memory. The
resident set is polled from ``start`` to ``stop`` on a daemon thread at the
JAX package's 10 ms cadence, read from ``/proc/self/statm`` (no ``psutil``
needed), and once more at each end of the window, so a window shorter than
the cadence still reads its own peak and never the process's lifetime
peak. The profiler trace and device-info helpers arrive with the benchmark
slice.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

_PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")
_POLL_S = 0.01        # the JAX package's cadence


@dataclass
class PerfStats:
    wall_time_s: float = 0.0
    peak_host_rss_mb: float = 0.0
    peak_device_mb: Optional[float] = None   # None on the CPU
    device_kind: str = "unknown"


def _host_rss_mb() -> float:
    """The process's resident set now, in MB (10^6 bytes)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * _PAGE_BYTES / 1e6


class PerformanceMonitor:
    """``mon.start(); ...; stats = mon.stop()``"""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._t0 = 0.0
        self._peak_rss = 0.0
        self._stop_evt: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _sample(self) -> None:
        self._peak_rss = max(self._peak_rss, _host_rss_mb())

    def _poll(self, evt: threading.Event) -> None:
        while not evt.is_set():
            self._sample()
            evt.wait(_POLL_S)

    def start(self) -> "PerformanceMonitor":
        if self._cuda():
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._peak_rss = 0.0
        self._sample()
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._poll, args=(self._stop_evt,), daemon=True)
        self._thread.start()
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> PerfStats:
        if self._cuda():
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._t0
        self._stop_evt.set()
        self._thread.join()
        self._sample()
        if self._cuda():
            peak = torch.cuda.max_memory_allocated(self.device) / 1e6
            kind = torch.cuda.get_device_name(self.device)
        else:
            peak, kind = None, "cpu"
        return PerfStats(wall_time_s=wall, peak_host_rss_mb=self._peak_rss,
                         peak_device_mb=peak, device_kind=kind)
