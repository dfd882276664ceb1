"""Rules of the port: no JAX in it, nothing the card's machine lacks, no CPU
fallback in the chip smoke or the headline benchmark, and a counterpart for
every public name of the JAX package."""

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
# the port needs none of them: the card's machine has no matplotlib, and the
# others (present there when probed) are not to be relied on
ABSENT_ON_THE_CARD = ("pandas", "PIL", "psutil", "matplotlib")
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
    # the one variant: the Hopper MLP kernels on the int8-compute route (they
    # take int8 and int16 weights in their bf16 build, after dequant_stream),
    # from the same source with a definition, under its own name
    assert _ext.LIBRARIES == _ext.SOURCES + tuple(_ext.VARIANTS)
    assert _ext.VARIANTS == {"ray_wgmma_i8": ("ray_wgmma", "-DNERF_WQ=3")}
    paths = {_ext.library_path(n) for n in _ext.LIBRARIES}
    assert len(paths) == len(_ext.LIBRARIES) == 7


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


CSRC_FILES = sorted(p.name for p in _ext.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


@pytest.mark.parametrize("name", _ext.LIBRARIES)
@pytest.mark.parametrize("edited", CSRC_FILES)
def test_library_name_follows_what_it_includes(tmp_path, monkeypatch, name, edited):
    # a library is named by a hash of its source, the headers it includes
    # and the flags: an edit of a file renames (rebuilds) exactly the
    # libraries built from it or from a source that includes it
    for path in _ext.CSRC.iterdir():
        shutil.copy(path, tmp_path / path.name)
    monkeypatch.setattr(_ext, "CSRC", tmp_path)
    source = _ext._source_and_flags(name)[0]
    builds_from_it = edited == source.name or (
        edited.endswith(".cuh") and f'#include "{edited}"' in source.read_text())
    before = _ext.library_path(name).name
    with open(tmp_path / edited, "a") as f:
        f.write("// edited\n")
    assert (_ext.library_path(name).name != before) == builds_from_it


# public functions whose `device` is the device of what they make, given
# by every caller: None is torch's own default there, not a choice of the CPU
DEVICE_OF_THE_CALLER = {("utils/rendering.py", "draw")}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_every_entry_point_defaults_to_the_card(path):
    # a parameter named device or devices: no default, "cuda", or None where
    # a "cuda" device parameter beside it decides (scaling_report)
    rel = str(path.relative_to(ROOT / "nerf_tpu_torch")) if "nerf_tpu_torch" in path.parts \
        else path.name
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) or \
                node.name.startswith("_") and node.name != "__init__":
            continue
        a = node.args
        params = a.posonlyargs + a.args + a.kwonlyargs
        defaults = ([None] * (len(a.posonlyargs + a.args) - len(a.defaults)) + list(a.defaults)
                    + list(a.kw_defaults))
        named = {p.arg: d for p, d in zip(params, defaults)}
        for name, default in named.items():
            if name not in ("device", "devices") or default is None:
                continue
            value = ast.literal_eval(default)
            if value == "cuda" or (value is None and named.get("device") is not None
                                   and ast.literal_eval(named["device"]) == "cuda"
                                   and name != "device"):
                continue
            if (rel, node.name) not in DEVICE_OF_THE_CALLER:
                bad.append(f"{node.name}({name}={value!r}) at line {node.lineno}")
    assert not bad, f"{path.name}: {bad}"


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
    # the mip variant's ray kernels (K1-mip, K3-mip) and K2's edges form
    from nerf_tpu_torch.config import mip_config

    packed = mlp_kernel.PackedWeights(*[None] * len(mlp_kernel.PackedWeights._fields))
    monkeypatch.setattr(render_kernel, "fused_render_mip_plain", plain)
    monkeypatch.setattr(render_kernel, "fused_render_edges_mip_plain", plain)
    monkeypatch.setattr(composite_kernel, "composite_edges_plain", plain)
    monkeypatch.setattr(render_kernel, "_launch_mip", lambda *a, **k: calls.append(
        "edges" if k.get("edges") is not None else "uniform") or torch.empty(4, 32, device="meta"))
    monkeypatch.setattr(composite_kernel, "_launch_edges", lambda *a: calls.append(
        "composite_edges") or (torch.empty(4, 8, device="meta"), None))
    del calls[:]
    mip = mip_config()
    render_kernel.fused_render_mip_raw(packed, meta, meta, 1e-3, 2.0, 6.0, 8, mip.model)
    render_kernel.fused_render_edges_mip_raw(packed, meta, meta, 1e-3,
                                             torch.empty(4, 9, device="meta"), mip.model)
    composite_kernel.composite_edges(torch.empty(4, 32, device="meta"),
                                     torch.empty(4, 9, device="meta"), meta, mip.render, False)
    assert calls == ["uniform", "edges", "composite_edges"]
    # the accel engine's grid-guided depths
    from nerf_tpu_torch.ops import occupancy

    grid = occupancy.OccupancyGrid(torch.empty(8, device="meta"), meta[0], meta[0], 2)
    monkeypatch.setattr(occupancy, "grid_guided_z_vals_plain", plain)
    monkeypatch.setattr(occupancy, "_launch", lambda *a: calls.append("occupancy"))
    del calls[:]
    occupancy.grid_guided_z_vals(grid, meta, meta, 2.0, 6.0, 8, n_probe=16, ray_stride=2)
    assert calls == ["occupancy"]


def test_mip360_wrappers_take_the_plain_version_only_for_cpu_tensors(monkeypatch):
    # Mip-NeRF 360's proposal entry, NeRF pass and K2's opaque edges form:
    # anything but a CPU tensor goes to the launcher, never to the plain version
    from nerf_tpu_torch.config import mip360_config
    from nerf_tpu_torch.ops import composite_kernel, mip360_kernel, render_kernel

    calls = []
    meta = torch.empty(4, 3, device="meta")
    edges = torch.empty(4, 9, device="meta")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a tensor that is not on the CPU")

    for mod, name in ((render_kernel, "fused_render_prop_mip360_plain"),
                      (mip360_kernel, "nerf_mip360_plain"),
                      (composite_kernel, "composite_weights_360_plain"),
                      (composite_kernel, "composite_edges_360_plain")):
        monkeypatch.setattr(mod, name, plain)
    monkeypatch.setattr(render_kernel, "_launch_prop", lambda *a: calls.append("prop")
                        or torch.empty(4, 8, device="meta"))
    monkeypatch.setattr(mip360_kernel, "_launch", lambda *a: calls.append("nerf")
                        or torch.empty(4, 32, device="meta"))
    monkeypatch.setattr(composite_kernel, "_launch_edges_360", lambda x, e, d, weights: calls.append(
        "k2 weights" if weights else "k2 raw") or torch.empty(4, 8 if weights else 8, device="meta"))
    cfg = mip360_config()
    render_kernel.fused_render_prop_mip360(None, meta, meta, 1e-3, edges, cfg.model)
    mip360_kernel.nerf_mip360_raw(None, meta, meta, 1e-3, edges, cfg.model)
    composite_kernel.composite_weights_360(torch.empty(4, 8, device="meta"), edges, meta)
    composite_kernel.composite_edges_360(torch.empty(4, 32, device="meta"), edges, meta,
                                         cfg.render)
    assert calls == ["prop", "nerf", "k2 weights", "k2 raw"]


# -- every public name of the JAX package has a counterpart ------------------

JAX_ROOT = ROOT / "nerf_tpu"
JAX_MODULES = sorted(p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py"))
# (module, name or Class.member) of the JAX package -> its name in the port
RENAMED = {
    ("render/engines.py", "PallasEngine"): "CudaEngine",
    ("render/engines.py", "XLAEngine"): "TorchEngine",
    ("ops/mlp_kernel.py", "make_pallas_apply_fn"): "make_cuda_apply_fn",
    ("train/trainer.py", "TrainState.opt_state"): "TrainState.optimizer",
}
_TPU_LAYOUT = ("the TPU kernels' weight layout (a fused head, frequency rows); pack_params "
               "lays the weights out for the CUDA kernels: heads split, bands evaluated inside")
_OPERANDS = ("the Pallas kernels' operand lists and in-kernel weight views; the CUDA kernels "
             "take the weights as they are and a weight stream (ops/ray_wgmma.py)")
_HOOKS = ("a hook that the JAX Engine's jitted render_chunk composes; the port's engines "
          "override render_chunk")
# (module, name or Class.member) of the JAX package -> why the port has none
NOT_PORTED = {
    **{("ops/mlp_kernel.py", f"PackedWeights.{f}"): _TPU_LAYOUT
       for f in ("bhead", "f_dir", "f_pos", "whead")},
    **{("ops/quant.py", f"{c}.{f}"): _TPU_LAYOUT
       for c in ("QuantizedPackedWeights", "Int8PackedWeights")
       for f in ("bhead", "f_dir", "f_pos", "whead_q", "whead_s")},
    **{("ops/mlp_kernel.py", n): _OPERANDS for n in ("packed_weight_arrays", "packed_w_dict")},
    **{("ops/quant.py", n): _OPERANDS for n in ("quant_weight_arrays", "quant_w_dict",
                                                "int8_weight_arrays", "int8_w_dict",
                                                "quant_reprs")},
    **{("render/engines.py", f"{c}.{h}"): _HOOKS
       for c in ("Engine", "PallasEngine")
       for h in ("apply_fn", "composite_fn", "composited_sample_eval_fn",
                 "composited_zvals_eval_fn", "raw_composite_fn", "raw_sample_eval_fn",
                 "raw_zvals_eval_fn", "sample_eval_fn", "zvals_eval_fn")},
    **{("render/engines.py", n): _HOOKS
       for n in ("Engine.z_sampler", "AccelEngine.z_sampler", "XLAEngine.apply_fn",
                 "CompressedEngine.apply_fn")},
    **{("render/engines.py", f"{c}.is_available"): (
        "available_engines probes an engine by constructing it") for c in ("Engine", "PallasEngine")},
    ("bench/suite.py", "UnifiedBenchmarkSuite.to_dataframe"): (
        "pandas, which the port does not depend on; summarize computes its "
        "aggregates"),
    ("utils/cache.py", "enable_compilation_cache"): (
        "the JAX compile cache; the port caches its libraries under build/nerf_tpu_torch, "
        "named by a hash of their sources"),
}


def _public_names(path):
    """Public names a module defines (functions, classes, assignments; an
    import defines none) and, for a class, ``Class.member`` for each public
    method and class-level attribute or field. ``__version__`` counts."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.ClassDef):
            names.add(node.name)
            for member in node.body:
                if isinstance(member, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(f"{node.name}.{member.name}")
                targets = (member.targets if isinstance(member, ast.Assign)
                           else [member.target] if isinstance(member, ast.AnnAssign) else [])
                names.update(f"{node.name}.{t.id}" for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
    return {n for n in names
            if n == "__version__" or not any(part.startswith("_") for part in n.split("."))}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_of_the_jax_package_has_a_counterpart(module):
    # the port's module of the same path defines each public name of the JAX
    # module, under the same name or the one RENAMED gives (a renamed class's
    # members under the new class); the names it lacks are exactly those
    # NOT_PORTED lists for the module, so neither a missing name nor a stale
    # entry goes unnoticed
    port = ROOT / "nerf_tpu_torch" / module
    theirs = _public_names(JAX_ROOT / module)
    ours = _public_names(port) if port.exists() else set()
    renamed = {old: new for (m, old), new in RENAMED.items() if m == module}

    def in_the_port(name):
        cls, _, member = name.rpartition(".")
        return renamed.get(name, f"{renamed.get(cls, cls)}.{member}" if cls else name)

    missing = {n for n in theirs if in_the_port(n) not in ours}
    listed = {n for m, n in NOT_PORTED if m == module}
    assert missing == listed, (f"nerf_tpu/{module}: no counterpart for {sorted(missing - listed)}; "
                               f"listed but not missing: {sorted(listed - missing)}")
