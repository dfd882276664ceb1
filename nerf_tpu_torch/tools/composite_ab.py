"""Time K2 bodies against each other on one card.

    python3 -m nerf_tpu_torch.tools.composite_ab NAME=path.cu [NAME=path.cu ...]

Each copy of ``csrc/composite.cu`` is built with the package's flags next to
the package's headers and bound with ctypes. At 16,384 rays and every case of
``cases`` (S in ``SAMPLE_COUNTS``, a float32 or bfloat16 raw, broadcast or
per-ray depths, with or without the weights), each copy's K2 entry
(``composite_rays``) runs in turns, forward then backward (A, B, B, A),
each turn ``REPS`` launches, device time per launch by
torch.profiler, one trace per case; beside them an empty kernel's, the
launch floor. Each copy's output is held against the plain version (rgb and
acc absolute, depth relative, weights absolute: 1e-5) and bit for bit
against the first copy's. Prints the card's name and power limit, then one
JSON line per case. Needs a CUDA device and ``nvcc``.

``inputs``, ``cases`` and ``device_ms_in_turns`` are also ``chip_smoke.py``'s.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from nerf_tpu_torch.ops import _ext, composite_kernel

ROOT = Path(__file__).resolve().parents[2]
RAYS = 16384
REPS = 20
TOL = 1e-5
SAMPLE_COUNTS = (1, 16, 32, 45, 64, 128, 192, 200)


def inputs(n, S, raw_dtype, per_ray_z, dev, seed):
    """``(raw [n, 4S], z [n, S], rays_d [n, 3])``: sigma in [0, 50) with a
    zero every 7th sample and an opaque one (1e6) mid-ray on every 5th ray,
    rgb in [0, 1), sorted depths in [2, 6) per ray or one broadcast row of
    uniform ones, directions from a normal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sigma = torch.rand(n, S, device=dev, generator=g) * 50.0
    sigma[:, ::7] = 0.0
    sigma[::5, S // 2] = 1e6
    rgb = torch.rand(n, S, 3, device=dev, generator=g)
    raw = torch.cat([sigma[..., None], rgb], -1).reshape(n, 4 * S).to(raw_dtype).contiguous()
    if per_ray_z:
        z = torch.sort(2.0 + 4.0 * torch.rand(n, S, device=dev, generator=g), -1).values
    else:
        z = torch.linspace(2.0, 6.0, S, device=dev).expand(n, S)
    return raw, z, torch.randn(n, 3, device=dev, generator=g)


def cases(raw_dtypes=(torch.float32, torch.bfloat16)):
    """(S, raw dtype, per-ray z, with weights) of every timed case."""
    return [(S, dt, per_ray, with_w) for dt in raw_dtypes for S in SAMPLE_COUNTS
            for per_ray in (False, True) for with_w in (True, False)]


def _device_events(prof):
    """(name, start us, duration us) of every GPU kernel in a trace, by start."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            out.append((name, e.time_range.start, e.time_range.elapsed_us()))
    return sorted(out, key=lambda t: t[1])


def device_ms_in_turns(turns, reps=REPS, tries=3):
    """``turns``: ``[(label, fn, kernel names)]``, each ``fn()`` one launch of
    a kernel whose name begins with one of the turn's names. Runs every turn
    ``reps`` times in order in one torch.profiler trace (each once before
    it, untraced) and returns ``{label: [ms per launch in each of its
    turns]}``. A trace can drop kernel records: one that does not hold
    exactly one event per launch is taken again, up to ``tries`` traces in
    all; then None."""
    for _, fn, _ in turns:
        fn()
    torch.cuda.synchronize()
    names = tuple({n for _, _, kn in turns for n in kn})
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _, fn, _ in turns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = [e for e in _device_events(prof) if e[0].startswith(names)]
        if len(events) != reps * len(turns):
            continue
        res = {}
        for i, (label, _, kn) in enumerate(turns):
            mine = events[i * reps:(i + 1) * reps]
            if any(not e[0].startswith(tuple(kn)) for e in mine):
                break
            res.setdefault(label, []).append(sum(e[2] for e in mine) / reps / 1e3)
        else:
            return res
    return None


def launch_floor_ms(reps=200):
    """Device ms of an empty kernel (``composite_empty``): the floor under
    any launch's device time."""
    lib = _ext.load("composite")
    dev = torch.device("cuda")
    t = device_ms_in_turns([("empty", lambda: _ext.check(
        lib, lib.composite_empty(_ext.stream_ptr(dev)), "composite_empty launch"),
        ("empty_kernel",))], reps)
    return None if t is None else t["empty"][0]


def composited_errors(out, w, ref_out, ref_w):
    """(rgb/acc max abs, depth max rel, w max abs; 0 where w is None)."""
    e_rgb_acc = (out[:, [0, 1, 2, 4]] - ref_out[:, [0, 1, 2, 4]]).abs().max().item()
    e_depth = ((out[:, 3] - ref_out[:, 3]).abs().max() / ref_out[:, 3].abs().max()).item()
    e_w = (w - ref_w).abs().max().item() if w is not None else 0.0
    return e_rgb_acc, e_depth, e_w


def build(copies, out: Path):
    """Each ``name -> source`` built beside the headers into ``out`` and bound."""
    out.mkdir(parents=True, exist_ok=True)
    for header in _ext.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    procs = {}
    for name, src in copies.items():
        shutil.copy(src, out / f"{name}.cu")
        cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"build": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                                    if "registers" in ln or "spill" in ln
                                                    or "Function properties" in ln]}),
              flush=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.composite_rays.argtypes = composite_kernel._ARGTYPES
        lib.composite_rays.restype = ctypes.c_int
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def main(argv):
    copies = dict(arg.split("=", 1) for arg in argv)
    if not copies or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(copies, ROOT / "build" / "composite_ab")
    dev = torch.device("cuda")
    sent, eps = 1e10, 1e-10

    def launch(lib, raw, z, rd, with_w):
        n, S = z.shape
        out = torch.empty(n, 8, device=dev)
        w = torch.empty(n, S, device=dev) if with_w else None
        err = lib.composite_rays(_ext.ptr(raw), int(raw.dtype == torch.bfloat16), _ext.ptr(z),
                                 z.stride(0), _ext.ptr(rd), n, S, sent, eps, _ext.ptr(out),
                                 None if w is None else _ext.ptr(w), _ext.stream_ptr(dev))
        _ext.check(lib, err, "composite_rays launch")
        return out, w

    print(json.dumps({"launch_floor_ms": launch_floor_ms()}), flush=True)
    for i, (S, dt, per_ray, with_w) in enumerate(cases()):
        raw, z, rd = inputs(RAYS, S, dt, per_ray, dev, seed=i)
        ref_out, ref_w = composite_kernel.fused_volume_render_interleaved_plain(raw, z, rd, sent,
                                                                               eps)
        errors, equal, got0 = {}, {}, None
        for name, lib in libs.items():
            out, w = launch(lib, raw, z, rd, with_w)
            torch.cuda.synchronize()
            errors[name] = composited_errors(out, w, ref_out, ref_w if with_w else None)
            if got0 is None:
                got0 = (out, w)
            equal[name] = torch.equal(out, got0[0]) and (w is None or torch.equal(w, got0[1]))
        run = lambda lib: (lambda: launch(lib, raw, z, rd, with_w))
        order = [(name, run(lib), ("composite_rays",)) for name, lib in libs.items()]
        ms = device_ms_in_turns(order + order[::-1])
        print(json.dumps({"rays": RAYS, "samples": S, "raw": str(dt).split(".")[-1],
                          "z": "per-ray" if per_ray else "broadcast", "with_weights": with_w,
                          "device_ms_turns": ms, "order": [o[0] for o in order + order[::-1]],
                          "errors": errors, "tol": TOL, "bit_equal_to_first": equal}),
              flush=True)
        if any(max(e) > TOL for e in errors.values()):
            raise SystemExit(f"K2 copies off the plain version at S = {S}: {errors}")


if __name__ == "__main__":
    main(sys.argv[1:])
