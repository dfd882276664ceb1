"""What every run shares: the files found by name, the program's config
built from a configuration file, the configuration's weights, the
per-layer readers, and the checks.

``BENCHMARK.json`` at the checkout's root names the cells; a cell ``X``
is ``workloads/X.json`` (its driver, traffic parameters, engine, the
frames or steps it checks and the limits of its checks), its configuration
``configs/<config>.json``, its driver ``drivers/<driver>.py`` and each
per-layer metric ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PACKAGE = ROOT / "nerf_tpu_torch"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Tuple[dict, dict, dict]:
    """``(BENCHMARK.json's entry, workload file, configuration file)``."""
    entries = [w for w in benchmark()["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    if workload["config"] != entry["config"] or workload["traffic"] != entry["traffic"]:
        raise SystemExit(f"workloads/{name}.json disagrees with BENCHMARK.json")
    return entry, workload, config


def metrics_of(kind: str, name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name``
    reports."""
    spec = benchmark()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    out = []
    for m in spec[kind]:
        cells = m.get("workloads")
        if cells is None and kind == "per_layer":
            moved = e2e[m["moves"]]
            cells = moved.get("workloads")
        if cells is None or name in cells:
            out.append(m)
    return out


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"nerfbench_driver_{name}")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "nerfbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def program_config(config: dict, seed: int = 0):
    """The port's ``Config`` for a configuration file (its model, render,
    train and accel sections), with ``train.seed = seed``."""
    from nerf_tpu_torch.config import (AccelConfig, Config, ModelConfig, RenderConfig,
                                       TrainConfig)

    accel = dict(config.get("accel", {}))
    if "aabb" in accel:
        accel["aabb"] = tuple(accel["aabb"])
    return Config(model=ModelConfig(**config["model"]),
                  render=RenderConfig(**config["render"]),
                  train=TrainConfig(**{**config.get("train", {}),
                                       "compute_dtype": config["compute_dtype"], "seed": seed}),
                  accel=AccelConfig(**accel))


def weights(config: dict, device, seed: int = 0) -> dict:
    """``{'coarse', 'fine'}`` float32 networks for both sides, as the
    configuration's ``weights`` section says: ``kind`` ``file``, a params
    ``.npz`` in the port's keystr layout (``"['fine']['trunk'][3]['w']"``);
    or ``seeded``, made on ``device`` from ``seed`` by ``recipe``
    ``glorot_uniform`` (every ``w`` uniform within ``sqrt(6 / (fan_in +
    fan_out))``, every ``b`` zero: the published code's Dense layers), in
    one draw for both networks."""
    import torch

    spec = config["weights"]
    if spec["kind"] == "seeded":
        return seeded_weights(config["model"], spec["recipe"], seed, device)
    data = np.load(HERE / spec["file"])
    nets: dict = {}
    for key in data.files:
        parts = [p.strip("'") for p in key.strip("[]").split("][")]
        node = nets
        for part, nxt in zip(parts[:-1], parts[1:]):
            default = [] if nxt.isdigit() else {}
            if part.isdigit():
                part = int(part)
                while len(node) <= part:
                    node.append(None)
                if node[part] is None:
                    node[part] = default
            else:
                node.setdefault(part, default)
            node = node[part]
        node[parts[-1]] = torch.as_tensor(data[key], dtype=torch.float32, device=device)
    return nets


def layer_shapes(model: dict) -> Dict[str, Any]:
    """``[fan_in, fan_out]`` of each layer of one network of ``model``: the
    reference variant concatenates the encoding before trunk layer
    ``skip_layer``, bmild after it (so layer ``skip_layer + 1`` is wide)."""
    pos = 3 * (1 + 2 * model["pos_freqs"])
    dirs = 3 * (1 + 2 * model["dir_freqs"])
    h, skip = model["hidden_dim"], model["skip_layer"]
    wide = skip + (0 if model["variant"] == "reference" else 1)
    shapes = {"trunk": [[pos if i == 0 else h + (pos if i == wide else 0), h]
                        for i in range(model["n_layers"])],
              "density": [h, 1], "color0": [h + dirs, model["color_hidden_dim"]],
              "color1": [model["color_hidden_dim"], 3]}
    if model["variant"] == "bmild":
        shapes["bottleneck"] = [h, h]
    return shapes


def seeded_weights(model: dict, recipe: str, seed: int, device) -> dict:
    import torch

    if recipe != "glorot_uniform":
        raise SystemExit(f"no weight recipe {recipe!r}")
    shapes = layer_shapes(model)
    flat = [s for net in ("coarse", "fine") for k in sorted(shapes)
            for s in (shapes[k] if k == "trunk" else [shapes[k]])]
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(a * b for a, b in flat), generator=g, device=device)
    it = iter(torch.split(draw, [a * b for a, b in flat]))

    def layer(shape):
        fan_in, fan_out = shape
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return {"w": ((next(it) * 2 - 1) * lim).view(fan_in, fan_out),
                "b": torch.zeros(fan_out, device=device)}

    nets = {}
    for net in ("coarse", "fine"):
        nets[net] = {k: ([layer(s) for s in shapes[k]] if k == "trunk" else layer(shapes[k]))
                     for k in sorted(shapes)}
    return nets


@dataclass
class Traced:
    """What a per-layer reader reads: the trace of the traced part, how many
    frames or steps it holds, and their operations by kernel key."""

    trace: Any
    units: int
    flops: Dict[str, float]


@dataclass
class Outcome:
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]          # name -> (value, limit)
    memory_peak_bytes: int
    traced: Optional[Traced] = None
    notes: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Tuple[float, float]]:
    """Each compared number beside its limit (the workload file's)."""
    return {k: (float(values[k]), float(limits[k])) for k in limits}
