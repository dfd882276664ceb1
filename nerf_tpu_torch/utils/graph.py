"""CUDA graphs of host loops whose Python has side effects.

``GraphedCall`` runs a function once eagerly, records its launches as one
``torch.cuda.CUDAGraph``, and replays that graph on every later call. It is
the port's counterpart of a ``jax.jit`` of a ``lax.scan``: one launch of
many steps, where eager PyTorch launches every kernel from the host.

What the function does on the host is not in the graph. Host counts of its
state that it advances (a step count, an update count) move once while the
graph is captured, when nothing runs, and not at all on a replay.
``HostCounters`` puts them back after the capture and adds the capture's
advance on each replay, so that they count the steps taken. The kernels'
launch counts are not such counts: a wrapper adds nothing for a launch it
records into a capture (``ops/_ext.ran``), and a replay's launches are seen
only by a profiler trace.

A graph holds the addresses of every tensor its function reads or writes,
and a replay launches the same work on those addresses. So:

- the function's inputs are static buffers, which the caller refills in place
  before each call;
- whatever replaces such a tensor (rather than writing into it) leaves the
  graph working on the old one: the caller keys its graph by the tensors'
  addresses and captures anew when they change;
- a ``torch.Generator`` the function draws from is registered with the graph,
  and a replay advances it as the eager call does;
- graphs that are replayed one at a time on one stream may share one memory
  pool (``torch.cuda.graph_pool_handle()``): a later capture then reuses the
  blocks an earlier one freed, where each graph would otherwise keep its own.
  A graph's outputs may then lie where another graph's temporaries do, which
  is why each call copies them out before it returns.

There is no eager fallback: a capture that fails raises.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch


class HostCounters:
    """Host integers of the state that a captured function advances, each
    the attribute ``name`` of an object, given as ``(object, name)``."""

    def __init__(self, cells: Sequence[Tuple[Any, str]]):
        self.cells = list(cells)

    def read(self) -> List[int]:
        return [getattr(h, n) for h, n in self.cells]

    def write(self, values: Sequence[int]) -> None:
        for (h, n), v in zip(self.cells, values):
            setattr(h, n, v)

    def record(self, fn: Callable[[], Any]) -> Tuple[Any, List[int]]:
        """``(fn(), how far it advanced each counter)``; the counters are put
        back to where they were before it, whether it returns or raises."""
        before = self.read()
        try:
            out = fn()
            after = self.read()
        finally:
            self.write(before)
        return out, [a - b for a, b in zip(after, before)]

    def advance(self, delta: Sequence[int]) -> None:
        self.write([v + d for v, d in zip(self.read(), delta)])


class GraphedCall:
    """``fn()`` (no arguments: it reads static buffers) as a CUDA graph.

    The first call runs ``fn`` eagerly on a side stream and returns its
    result: that call is real work, and it fills whatever ``fn`` caches
    (a host-to-device copy cannot be captured). Then it captures ``fn``
    into ``pool`` (None: a pool of its own) with ``counters`` put back and
    ``generators`` registered. Every later call replays the graph, advances
    the counters by the capture's advance, and returns a copy of the graph's
    outputs (a dict of tensors)."""

    def __init__(self, fn: Callable[[], dict], counters: HostCounters,
                 generators: Sequence[torch.Generator] = (), pool=None):
        self.fn = fn
        self.counters = counters
        self.generators = list(generators)
        self.pool = pool
        self.graph = None
        self.out = None
        self.delta = None

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)

        def run():
            with torch.cuda.graph(graph, pool=self.pool):
                return self.fn()

        self.out, self.delta = self.counters.record(run)
        self.graph = graph

    def __call__(self) -> dict:
        if self.graph is not None:
            self.graph.replay()
            self.counters.advance(self.delta)
            return {k: v.clone() for k, v in self.out.items()}
        caller = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            out = self.fn()
        caller.wait_stream(side)
        for v in out.values():
            v.record_stream(caller)
        self._capture()
        return out
