"""Host spans of a ``trace.Trace``: the port's own ``record_function``
spans (``utils/monitor.span``), on the profiler's clock beside the device.

``intervals`` merges (``merge``) the host intervals of the CPU events that
match, by name or by a prefix ending in ``.``, clipped to the window
``[t0, t1]``;
``host_s`` is their length, and ``idle_s`` their overlap with the window's
idle time, the window less ``busy_intervals()``. ``per_frame_ms`` is what
the readers report: ms a traced frame, or None where the trace holds no
matching span (a program that records none).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

Names = Union[str, Iterable[str]]
FRAME = ("engine.rays", "engine.assemble", "engine.to_host")
GLUE = ("occupancy.z_vals",)
DISPATCH = "kernel."


def _matches(names: Names):
    if isinstance(names, str):
        return lambda n: n.startswith(names)
    wanted = frozenset(names)
    return lambda n: n in wanted


def merge(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def intervals(trace, names: Names) -> List[Tuple[float, float]]:
    """Merged ``(start_us, end_us)`` of the matching host events."""
    match = _matches(names)
    return merge((max(a, trace.t0), min(b, trace.t1)) for n, a, b in trace.cpu
                 if match(n) and b > trace.t0 and a < trace.t1)


def host_s(trace, names: Names) -> float:
    return sum(b - a for a, b in intervals(trace, names)) * 1e-6


def idle_s(trace, names: Names) -> float:
    """Seconds of the matching spans during which the device ran nothing."""
    spans = intervals(trace, names)
    busy = trace.busy_intervals()
    idle = 0.0
    k = 0
    for a, b in spans:
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        idle += b - a
        j = k
        while j < len(busy) and busy[j][0] < b:
            idle -= min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return idle * 1e-6


def per_frame_ms(traced, names: Names, idle: bool) -> Optional[float]:
    if not intervals(traced.trace, names):
        return None
    seconds = (idle_s if idle else host_s)(traced.trace, names)
    return seconds * 1e3 / traced.units
