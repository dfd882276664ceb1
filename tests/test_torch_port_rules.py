"""Rules of the port: no JAX in it, nothing the card's machine lacks, no CPU
fallback in the chip smoke or the headline benchmark."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nerf_tpu_torch.ops import _ext

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "nerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                 ROOT / "bench_cuda.py"]
FORBIDDEN = ("jax", "jaxlib", "nerf_tpu")
ABSENT_ON_THE_CARD = ("pandas", "PIL", "psutil", "matplotlib")   # the card's machine lacks them
BENCH_FILES = sorted((ROOT / "nerf_tpu_torch" / "bench").rglob("*.py")) + [ROOT / "bench_cuda.py"]
CLI_FILES = sorted((ROOT / "nerf_tpu_torch" / "cli").rglob("*.py"))


def _imported_modules_of(node):
    if isinstance(node, ast.Import):
        yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield node.module


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        yield from _imported_modules_of(node)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_needs_nothing_the_card_lacks(path):
    # importing a module of the port needs none of them; the benchmark
    # files use none but matplotlib, for the suite's chart, inside a function;
    # the command line uses none at all, and only asks importlib whether
    # matplotlib is there (the loss plot and the chart are drawn elsewhere)
    tree = ast.parse(path.read_text(), str(path))
    top = [m for node in tree.body for m in _imported_modules_of(node)
           if m.split(".")[0] in ABSENT_ON_THE_CARD]
    absent = (ABSENT_ON_THE_CARD if path in CLI_FILES
              else ABSENT_ON_THE_CARD[:-1] if path in BENCH_FILES else ())
    anywhere = [m for m in _imported_modules(path) if m.split(".")[0] in absent]
    assert not top and not anywhere, f"{path.name} imports {top + anywhere}"
    if path in CLI_FILES:
        named = [(node.lineno, node.value) for node in ast.walk(tree)
                 if isinstance(node, ast.Constant) and isinstance(node.value, str)
                 and node.value.split(".")[0] in ABSENT_ON_THE_CARD]
        looked_up = [(call.lineno, call.args[0].value) for call in ast.walk(tree)
                     if isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                     and call.func.attr == "find_spec" and call.args
                     and isinstance(call.args[0], ast.Constant)]
        assert named == looked_up and all(m == "matplotlib" for _, m in named), (
            f"{path.name} names {named} outside importlib.util.find_spec('matplotlib')")


def test_kernels_build_for_hopper_without_fast_math():
    flags = " ".join(_ext.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert set(_ext.SOURCES) == {p.stem for p in _ext.CSRC.glob("*.cu")}
    for name in _ext.SOURCES:
        assert (_ext.CSRC / f"{name}.cu").exists()
        assert _ext.library_path(name).parent == ROOT / "build" / "nerf_tpu_torch"
    # the variants: one more library per quantized weight route of each
    # source of the ray kernels (the WMMA body's and the Hopper kernels'),
    # from the same source with a definition, each under its own name
    assert _ext.LIBRARIES == _ext.SOURCES + tuple(_ext.VARIANTS)
    for source in ("render_samples", "ray_wgmma"):
        assert sorted(d for s, d in _ext.VARIANTS.values() if s == source) == [
            f"-DNERF_WQ={i}" for i in (1, 2, 3)]
    assert {s for s, _ in _ext.VARIANTS.values()} == {"render_samples", "ray_wgmma"}
    paths = {_ext.library_path(n) for n in _ext.LIBRARIES}
    assert len(paths) == len(_ext.LIBRARIES) == 13


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


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    # a library is named by a hash of its source, the shared headers and the
    # flags, so an edit of the MLP body rebuilds every kernel that includes it
    for path in _ext.CSRC.iterdir():
        shutil.copy(path, tmp_path / path.name)
    monkeypatch.setattr(_ext, "CSRC", tmp_path)
    before = {n: _ext.library_path(n).name for n in _ext.SOURCES}
    with open(tmp_path / "mlp_body.cuh", "a") as f:
        f.write("// edited\n")
    assert all(_ext.library_path(n).name != before[n] for n in _ext.SOURCES)
    # and a variant follows its source
    before = {n: _ext.library_path(n).name for n in _ext.LIBRARIES}
    with open(tmp_path / "render_samples.cu", "a") as f:
        f.write("// edited\n")
    changed = {n for n in _ext.LIBRARIES if _ext.library_path(n).name != before[n]}
    assert changed == {"render_samples", *(n for n, (s, _) in _ext.VARIANTS.items()
                                           if s == "render_samples")}


def test_default_train_apply_fn_follows_device_and_config_only():
    # the kernels for a CUDA device and the standard architecture, apply_nerf
    # otherwise; the choice never tries the device, so nothing can fall back
    import dataclasses

    from nerf_tpu_torch.config import ModelConfig, bmild_config, default_config
    from nerf_tpu_torch.models.nerf import apply_nerf
    from nerf_tpu_torch.train.trainer import NeRFTrainer, default_train_apply_fn

    cfg = default_config()
    assert default_train_apply_fn(cfg, "cpu") is apply_nerf
    fn = default_train_apply_fn(cfg, "cuda")          # no device needed to choose
    assert fn is not apply_nerf and fn.__qualname__.startswith("make_train_apply_fn")
    narrow = dataclasses.replace(cfg, model=ModelConfig(hidden_dim=64))
    assert default_train_apply_fn(narrow, "cuda") is apply_nerf
    assert default_train_apply_fn(bmild_config(), "cuda") is apply_nerf
    assert NeRFTrainer(narrow, (8, 8), device="cpu").apply_fn is apply_nerf


def test_trainer_raises_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from nerf_tpu_torch.config import default_config
    from nerf_tpu_torch.train.trainer import NeRFTrainer, init_train_state, make_eval_render

    with pytest.raises(RuntimeError, match="CUDA"):
        NeRFTrainer(default_config(), (8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(torch.Generator().manual_seed(0), default_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_render(default_config(), 64)


def test_wrappers_take_the_plain_version_only_for_cpu_tensors(monkeypatch):
    # the choice between a kernel and its plain version is made by the
    # tensor's device alone: anything but a CPU tensor goes to the launcher
    # (which launches or raises), never to the plain version
    from nerf_tpu_torch.config import RenderConfig
    from nerf_tpu_torch.ops import composite_kernel, mlp_kernel, quant, render_kernel, train_kernel

    calls = []
    meta = torch.empty(4, 3, device="meta")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a tensor that is not on the CPU")

    monkeypatch.setattr(mlp_kernel, "fused_nerf_apply_plain", plain)
    monkeypatch.setattr(train_kernel, "packed_grads_plain", plain)
    monkeypatch.setattr(composite_kernel, "fused_volume_render_plain", plain)
    monkeypatch.setattr(mlp_kernel, "_launch", lambda *a: calls.append("mlp_forward"))
    monkeypatch.setattr(train_kernel, "_launch", lambda *a: calls.append("mlp_backward"))
    monkeypatch.setattr(
        composite_kernel, "_launch_planar",
        lambda *a: calls.append("composite_planar") or (torch.empty(4, 8, device="meta"), meta))
    mlp_kernel.mlp_forward(None, meta, meta, None)
    train_kernel.packed_grads(None, meta, meta, meta[:, 0], meta, None)
    composite_kernel.fused_volume_render(meta, (meta,) * 3, meta, meta, RenderConfig())
    assert calls == ["mlp_forward", "mlp_backward", "composite_planar"]
    # the quantized MLP and the ray kernels on quantized weights, in every
    # output form
    q = quant.QuantizedPackedWeights(*[None] * len(quant.QuantizedPackedWeights._fields))
    monkeypatch.setattr(quant, "quantized_nerf_apply_plain", plain)
    monkeypatch.setattr(render_kernel, "fused_render_samples_plain", plain)
    monkeypatch.setattr(render_kernel, "fused_render_zvals_plain", plain)
    monkeypatch.setattr(quant, "_launch",
                        lambda *a: calls.append("mlp_quant") or torch.empty(4, 4, device="meta"))
    monkeypatch.setattr(
        render_kernel, "_launch",
        lambda *a, **k: calls.append("planar" if k.get("planar") else str(k.get("raw_dtype")))
        or torch.empty(4, 4, 8, device="meta"))
    del calls[:]
    quant.quantized_nerf_apply(q, meta, meta, None)
    render_kernel.fused_render_samples(q, meta, meta, 2.0, 6.0, 8, None, raw=True,
                                       raw_dtype=torch.bfloat16)
    render_kernel.fused_render_samples(q, meta, meta, 2.0, 6.0, 8, None, planar=True)
    render_kernel.fused_render_zvals_raw(q, meta, meta, torch.empty(4, 8, device="meta"), None,
                                         raw_dtype=torch.bfloat16)
    render_kernel.fused_render_zvals_planar(q, meta, meta, torch.empty(4, 8, device="meta"), None)
    assert calls == ["mlp_quant", "torch.bfloat16", "planar", "torch.bfloat16", "planar"]
