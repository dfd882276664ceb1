"""A whole run of each cell at a tiny size on the CPU: the result line's
keys, the module rule, and the refusal without a card."""

import json
import subprocess
import sys

import pytest
import torch

from nerfbench import harness
from nerfbench.tests import tiny

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contracts_keys(cell):
    line, out = tiny.execute(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = [m["name"] for m in harness.metrics_of("end_to_end", cell)]
    assert list(line["metrics"]) == names
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(out.checks)
    assert line["attempted"] > 0 and line["failed"] == 0 and line["correct"] is True
    json.dumps(line)


def test_no_jax_and_no_jax_package_in_a_run():
    code = ("import sys; sys.path.insert(0, '.');"
            "from nerfbench.tests import tiny; from nerfbench import run;"
            "tiny.execute('ref-hier'); tiny.execute('ref-train');"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from nerfbench import run

    monkeypatch.setitem(sys.modules, "nerf_tpu_torch_like", sys)
    assert "nerf_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nerf_tpu.ops", sys)
    assert "nerf_tpu" in run.forbidden_modules()


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show here")
    out = subprocess.run([sys.executable, "nerfbench/run.py", "--workload", "ref-hier",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "nerfbench/run.py", "--workload", "ref-accel32",
                          "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
