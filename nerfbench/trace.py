"""The traced run's arithmetic: a ``torch.profiler`` trace of a bounded,
steady part of the run, reduced to device intervals, busy time, time and
launches by kernel name, and idle gaps named by what the host was doing.

The traced part is a CPU span ``nerfbench.window`` between two
``synchronize`` fences; everything is clipped to it. The port's own kernels
are the CUDA ``__global__`` functions of ``nerf_tpu_torch/csrc/*.cu`` and
any ``@triton.jit`` function of the package, found by name in the sources.
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "nerfbench.window"
SPANS = ("Engine.render_image", "NeRFTrainer.train_epoch")   # the drivers' spans
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)")


def port_kernels(package: Path) -> frozenset:
    names = set()
    for src in sorted((package / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    for src in sorted(package.rglob("*.py")):
        names.update(_TRITON.findall(src.read_text()))
    return frozenset(names)


def kernel_name(raw: str) -> str:
    name = raw.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


class Trace:
    """Device events ``(name, start_us, end_us)`` and host ops inside the
    traced window ``[t0, t1]`` (microseconds of the profiler's clock)."""

    def __init__(self, prof, port: frozenset):
        cpu, dev = [], []
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((kernel_name(e.name), *rng, getattr(e, "is_user_annotation", False)))
            else:
                cpu.append((e.name, *rng))
        # a span (record_function) has a mirror on the device's timeline,
        # which is no device work
        spans = {c[0] for c in cpu} & {d[0] for d in dev if d[3]} | {WINDOW, *SPANS}
        dev = [d[:3] for d in dev if not d[3] and d[0] not in spans]
        win = [c for c in cpu if c[0] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0, self.t1 = win[0][1], win[0][2]
        self.cpu = [c for c in cpu if c[0] != WINDOW and c[2] > self.t0 and c[1] < self.t1]
        self.device = sorted((n, max(a, self.t0), min(b, self.t1)) for n, a, b in dev
                             if b > self.t0 and a < self.t1)
        self.port = port

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, a, b in sorted(self.device, key=lambda d: d[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """``{kernel: (seconds, launches)}``."""
        out: Dict[str, Tuple[float, int]] = {}
        for n, a, b in self.device:
            s, c = out.get(n, (0.0, 0))
            out[n] = (s + (b - a) * 1e-6, c + 1)
        return out

    def seconds_of(self, names) -> Tuple[float, int]:
        """Seconds and launches of the named kernels."""
        hits = [v for n, v in self.by_name().items() if n in names]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def glue(self) -> Tuple[float, int]:
        """Seconds and launches of every device operation that is not one of
        the port's kernels (ATen kernels, copies, fills)."""
        hits = [v for n, v in self.by_name().items() if n not in self.port]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Seconds of idle device time by the innermost host op running at
        each gap's middle (``idle`` where none ran)."""
        edges = [self.t0] + [x for iv in self.busy_intervals() for x in iv] + [self.t1]
        host = sorted(self.cpu, key=lambda c: c[1])
        out: Dict[str, float] = {}
        active: List[tuple] = []
        k = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while k < len(host) and host[k][1] <= mid:
                active.append(host[k])
                k += 1
            active = [c for c in active if c[2] >= mid]
            name = max(active, key=lambda c: c[1])[0] if active else "idle"
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
        return sorted(out.items(), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        ops = sorted(((n, s) for n, (s, _) in self.by_name().items()), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:10]]}


def traced(fn: Callable[[], object], port: frozenset) -> Tuple[object, Trace, float]:
    """``(fn(), its Trace, host seconds)`` with ``fn`` run once between two
    fences inside the window span."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t
    return out, Trace(prof, port), host_s
