"""The check catches what it is there for. A run at a tiny size on the CPU,
with the timed path broken underneath, comes out not correct: once for
each fault a cell can have. And the control, the reference one precision
step lower put in the program's place, fails the cell's limits."""

import itertools
import time

import pytest
import torch

from nerfbench.tests import tiny

RENDER_CELLS = ["lego-hier", "ref-hier", "ref-accel32", "ref-int8-hier"]


def chunk_fault(monkeypatch, fault):
    """Wrap every engine's ``render_chunk`` with ``fault(rgb, depth)``."""
    from nerf_tpu_torch.render import engines

    for cls in (engines.CudaEngine, engines.AccelEngine):
        original = cls.render_chunk

        def broken(self, *a, _original=original, **k):
            return fault(*_original(self, *a, **k))

        monkeypatch.setattr(cls, "render_chunk", broken)


def half_left_out(rgb, depth):
    n = rgb.shape[0] // 2
    return (torch.cat([rgb[:n], torch.zeros_like(rgb[n:])]),
            torch.cat([depth[:n], torch.zeros_like(depth[n:])]))


def altered(rgb, depth):
    return rgb + 0.1, depth


@pytest.mark.parametrize("cell", RENDER_CELLS)
@pytest.mark.parametrize("fault", [half_left_out, altered])
def test_a_broken_frame_is_not_correct(monkeypatch, cell, fault):
    chunk_fault(monkeypatch, fault)
    line, out = tiny.execute(cell)
    assert line["correct"] is False, out.checks


@pytest.mark.parametrize("cell", RENDER_CELLS)
def test_a_stale_frame_is_not_correct(monkeypatch, cell):
    from nerf_tpu_torch.render import engines

    original = engines.Engine.render_image
    first = {}

    def stale(self, *a, **k):
        res = original(self, *a, **k)
        return first.setdefault("frame", res)

    monkeypatch.setattr(engines.Engine, "render_image", stale)
    # a clock that moves half a second a reading: the window holds a few
    # frames however slow the CPU is
    clock = itertools.count(0.0, 0.5)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    line, out = tiny.execute(cell, seconds=3.0)
    assert out.notes["frames"] >= 2
    assert line["correct"] is False, out.checks


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from nerf_tpu_torch.train import trainer

    def unchanged(self, leaves, grads):
        self.device_count += 1
        self.count += 1

    monkeypatch.setattr(trainer.Optimizer, "update", unchanged)
    line, out = tiny.execute("ref-train")
    assert line["correct"] is False, out.checks


def test_a_step_on_half_the_batch_is_not_correct(monkeypatch):
    from nerf_tpu_torch.train import trainer

    original = trainer.render_rays

    def half_loss(params, cfg, rays_o, rays_d, target, generator=None, apply_fn=None,
                  shard=None):
        res = original(params["coarse"], params["fine"], rays_o, rays_d, cfg.model,
                       cfg.render, generator=generator, perturb=generator is not None,
                       compute_dtype=getattr(torch, cfg.train.compute_dtype), apply_fn=apply_fn)
        n = target.shape[0] // 2
        loss_c = torch.mean((res.coarse.rgb[:n] - target[:n]) ** 2)
        loss_f = torch.mean((res.fine.rgb[:n] - target[:n]) ** 2)
        return loss_c + loss_f, (loss_c, loss_f)

    monkeypatch.setattr(trainer, "loss_fn", half_loss)
    line, out = tiny.execute("ref-train")
    assert line["correct"] is False, out.checks
