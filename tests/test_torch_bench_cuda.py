"""``bench_cuda.py``, the port's headline line, against ``bench.py``: the
same line, baseline, poses and weights rule, at a small size on the CPU;
and no CPU fallback in its entry point."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import bench_cuda  # noqa: E402
from nerf_tpu.render import engines as jengines  # noqa: E402
from nerf_tpu_torch.render import engines  # noqa: E402

KEYS = {"metric", "value", "unit", "vs_baseline"}


def _record(monkeypatch, module, cls, calls):
    real = getattr(module, cls).render_image

    def render(self, pose, resolution, spp, focal=None, **kw):
        calls.append((np.asarray(pose), tuple(resolution), spp, focal, self.cfg.model.variant))
        return real(self, pose, resolution, spp, focal=focal, **kw)

    monkeypatch.setattr(getattr(module, cls), "render_image", render)


def test_run_on_the_cpu_returns_the_headline_line(capsys):
    line = bench_cuda.run("cpu", 16, 12, 8)
    assert set(line) == KEYS and line["metric"] == "rays_per_second"
    assert line["unit"] == "rays/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / bench_cuda.BASELINE_RAYS_PER_S, 2)
    err = capsys.readouterr()
    assert err.out == ""                                  # progress goes to stderr
    lines = err.err.splitlines()
    assert lines[0].startswith("device: CPU - cpu  config: 16x12@8  network: reference")
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "warm view 0 (load + first render)", "view 1", "view 2", "view 3",
        "bmild frame (seeded random weights)"]


def test_same_line_baseline_and_poses_as_bench_py(monkeypatch, capsys):
    # bench.py on the CPU renders its fallback size through the XLA engine;
    # bench_cuda.run at that size renders the same four poses at the same
    # focal, then its bmild frame at view 1's pose
    monkeypatch.setattr("nerf_tpu.utils.cache.enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(bench, "BMILD", str(ROOT / "no_such_weights.npy"))
    jcalls, calls = [], []
    _record(monkeypatch, jengines, "XLAEngine", jcalls)
    _record(monkeypatch, engines, "CudaEngine", calls)
    assert bench.main() == 0
    want = json.loads(capsys.readouterr().out)
    got = bench_cuda.run("cpu", 80, 60, 16, weights=str(ROOT / "no_such_weights.npy"))
    assert set(got) == set(want) == KEYS
    assert bench_cuda.BASELINE_RAYS_PER_S == bench.BASELINE_RAYS_PER_S
    assert len(jcalls) == 4 and len(calls) == 5
    for (jp, jres, jspp, jf, jvar), (p, res, spp, f, var) in zip(jcalls, calls):
        np.testing.assert_allclose(p, jp, atol=1e-6)
        assert (res, spp, var) == (jres, jspp, jvar) == ((80, 60), 16, "reference")
        assert f == pytest.approx(jf, rel=1e-12)
    np.testing.assert_allclose(calls[4][0], jcalls[1][0], atol=1e-6)
    assert calls[4][4] == "bmild"


def test_lego_weights_choose_the_bmild_network(tmp_path, monkeypatch, capsys):
    # where the weights file exists: bmild_config on it (bench.py:48-51)
    rng = np.random.default_rng(0)
    shapes = ([(63, 256)] + [(256, 256)] * 4 + [(319, 256)] + [(256, 256)] * 2
              + [(256, 256), (283, 128), (128, 3), (256, 1)])
    obj = np.empty(24, dtype=object)
    obj[:] = [a for s in shapes for a in (0.05 * rng.normal(size=s).astype(np.float32),
                                          np.zeros(s[1], np.float32))]
    path = tmp_path / "model_fine_200000.npy"
    np.save(path, obj, allow_pickle=True)
    calls = []
    _record(monkeypatch, engines, "CudaEngine", calls)
    line = bench_cuda.run("cpu", 8, 6, 4, weights=str(path))
    assert set(line) == KEYS and line["value"] > 0
    assert capsys.readouterr().err.splitlines()[0].endswith(f"network: bmild on {path}")
    assert [c[4] for c in calls] == ["bmild"] * 5


def test_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_cuda.main([])


def test_the_script_prints_no_line_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "bench_cuda.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
