"""Run one cell of the benchmark once and print its result line.

    python3 nerfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of a
bounded part after the window. Each number the check compares is printed
beside its limit, last on standard error and last in the line. Without a
CUDA device, or with fewer than the cell asks for, it exits non-zero and
prints no result; so it does if JAX or the JAX package is loaded when the
window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CHECKOUT / "build" / "nerfbench" / sub)
os.environ["USE_FLAX"] = "0"
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(name: str, seed: int, seconds: float, trace_on: bool, device="cuda",
            t_start: float = T_START, workload_overrides=None, config_overrides=None):
    """Set up, run and check one cell: ``(result line dict, Outcome)``. The
    overrides (tests: a tiny cell on the CPU) update the workload file's
    keys and the configuration file's sections."""
    from nerfbench import harness

    entry, workload, config = harness.cell(name)
    workload = {**workload, **(workload_overrides or {})}
    for key, value in (config_overrides or {}).items():
        config = {**config, key: {**config[key], **value} if isinstance(value, dict) else value}
    out = harness.driver(workload["driver"]).run(workload, config, seed, seconds, trace_on,
                                                 device, t_start)
    # a cell may report a driver's quantity under a name of its own
    names = workload.get("report_as", {})
    out.metrics = {names.get(k, k): v for k, v in out.metrics.items()}
    import torch

    dev = torch.device(device)
    if trace_on:
        metrics = {}
        for m in harness.metrics_of("per_layer", name):
            value = harness.reader(m["name"]).read(out.traced) if out.traced else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                   for m in harness.metrics_of("end_to_end", name)}
    on_card = dev.type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": entry["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": info}
    if trace_on and out.traced is not None:
        tr = out.traced.trace
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from nerfbench import harness

    entry = harness.cell(args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"nerfbench: {entry['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    line, out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"nerfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps({"notes": out.notes}), file=sys.stderr)
    for k, (v, lim) in out.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
