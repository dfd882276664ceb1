"""Frame timing, peak memory, device labels and profiler traces.

Counterpart of ``nerf_tpu/utils/monitor.py``. ``PerformanceMonitor`` times
a window between two ``torch.cuda.synchronize()`` fences and reads the peak
of ``torch.cuda.max_memory_allocated`` over it as device memory
(``device_peak_memory_mb``) and the peak resident set of the process over
it as host memory. The resident set is polled from ``start`` to ``stop`` on
a daemon thread at the JAX package's 10 ms cadence, read from
``/proc/self/statm`` (no ``psutil`` needed), and once more at each end of
the window, so a window shorter than the cadence still reads its own peak
and never the process's lifetime peak. ``device_info_string`` labels
benchmark rows; ``profile_trace`` writes a ``torch.profiler`` Chrome trace
and, unlike the JAX helper, raises where tracing fails. ``sync`` fences on a
result: it synchronizes the CUDA devices its tensors lie on, and copies
nothing to the host.

``span(name)`` names a stretch of host work in a profiler trace: while a
``torch.profiler`` is recording it is ``record_function(name)``, on the
profiler's clock beside the device's kernels (the trace keeps it in memory
and writes it out with the rest); otherwise it is one shared
``nullcontext`` and costs a check of the profiler's state. A span recorded
into a CUDA graph's capture does not replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator, Optional, Set

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")
_POLL_S = 0.01        # the JAX package's cadence
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span(name): ...``: a ``record_function`` span while a
    profiler records, a shared ``nullcontext`` otherwise."""
    return record_function(name) if torch.autograd._profiler_enabled() else _NO_SPAN


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
        return PerfStats(wall_time_s=wall, peak_host_rss_mb=self._peak_rss,
                         peak_device_mb=device_peak_memory_mb(self.device),
                         device_kind=device_kind(self.device))


def _cuda_devices(result: Any, found: Set[torch.device]) -> None:
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(result) and not isinstance(result, type):
        for f in dataclasses.fields(result):
            _cuda_devices(getattr(result, f.name), found)


def sync(result: Any) -> None:
    """Fence on a computation's completion: ``torch.cuda.synchronize`` once
    for each CUDA device that holds a tensor of ``result`` (tensors, nested
    in tuples, lists, dicts and dataclasses), which waits for every kernel
    queued there, the result's among them. CPU tensors need no fence, and
    nothing is copied to the host."""
    found: Set[torch.device] = set()
    _cuda_devices(result, found)
    for dev in sorted(found, key=lambda d: d.index):
        torch.cuda.synchronize(dev)


def device_peak_memory_mb(device="cuda") -> Optional[float]:
    """Peak bytes allocated on a CUDA device since its last reset, in MB
    (10^6 bytes); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e6


def device_kind(device="cuda") -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def device_info_string(device="cuda") -> str:
    """Label for benchmark rows, as the JAX package's ``"{PLATFORM} -
    {kind}"``: ``"CUDA - NVIDIA H100 80GB HBM3"``, ``"CPU - cpu"``."""
    device = torch.device(device)
    return f"{device.type.upper()} - {device_kind(device)}"


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[profile]:
    """``with profile_trace(log_dir) as prof: ...`` profiles the block
    (CPU activity, and CUDA activity where a card is present) and writes a
    Chrome trace (chrome://tracing, Perfetto) to
    ``log_dir/trace_<pid>_<ns>.json``, whose path it keeps in
    ``prof.trace_path``. It raises where the profiler or the write fails."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
