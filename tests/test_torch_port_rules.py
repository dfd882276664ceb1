"""Rules of the port: no JAX in it, no CPU fallback in the chip smoke."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nerf_tpu_torch.ops import _ext

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "nerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "nerf_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_kernels_build_for_hopper_without_fast_math():
    flags = " ".join(_ext.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for name in _ext.SOURCES:
        assert (_ext.CSRC / f"{name}.cu").exists()
        assert _ext.library_path(name).parent == ROOT / "build" / "nerf_tpu_torch"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
