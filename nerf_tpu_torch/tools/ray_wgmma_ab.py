"""Time several copies of ``csrc/ray_wgmma.cu`` against each other on one card.

    python3 -m nerf_tpu_torch.tools.ray_wgmma_ab NAME=path.cu [NAME=path.cu ...]

ptxas schedules the Hopper body differently after small edits of its
consumer loop, so an edit is judged by timing the edited source beside the
one it changes, in one process on one card. Each copy is built for the bf16
route (``-DNERF_WQ=0``) next to the package's headers and bound with
ctypes. On the trained weights of ``results/convergence/final_params.npz``
and 16,384 camera rays, the raw K1 (64 depths) and K3 (192 sorted random
depths) and, in the copies that have them, the composited K1 (with its
weights) and K3 run by CUDA events in turns (the copies forward, then
backward, three times); each raw output is compared bit for bit with the
first copy's. A copy without the composited entry (no
``ray_wgmma_composited_lanes``) is called with the raw-only signature.
Prints the card's name and power limit, then one JSON line per kernel: the
median ms per copy. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from nerf_tpu_torch.config import default_config
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.ops import _ext, ray_wgmma
from nerf_tpu_torch.ops.mlp_kernel import net_args, pack_params
from nerf_tpu_torch.train.checkpoint import restore_bare_params
from nerf_tpu_torch.utils.cameras import focal_from_angle, generate_rays, spherical_pose

ROOT = Path(__file__).resolve().parents[2]
RAYS = 16384
# the raw-only signature: ray_wgmma.ARGTYPES without (composited, dz,
# sentinel, eps) and w
RAW_ARGTYPES = ray_wgmma.ARGTYPES[:18] + [ctypes.c_int] + [ctypes.c_void_p] * 2


def build(copies, out: Path):
    """Each ``name -> source`` built beside the headers into ``out``: the
    bound libraries, and whether each has the composited entry."""
    out.mkdir(parents=True, exist_ok=True)
    for header in _ext.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    procs = {}
    for name, src in copies.items():
        shutil.copy(src, out / f"{name}.cu")
        cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, "-DNERF_WQ=0", "-o", str(out / f"{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        composited = hasattr(lib, "ray_wgmma_composited_lanes")
        lib.ray_wgmma_render.argtypes = ray_wgmma.ARGTYPES if composited else RAW_ARGTYPES
        lib.ray_wgmma_render.restype = ctypes.c_int
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        libs[name] = (lib, composited)
    return libs


def call_ms(fn, reps):
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv):
    copies = dict(arg.split("=", 1) for arg in argv)
    if not copies or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(copies, ROOT / "build" / "ray_wgmma_ab")
    dev = torch.device("cuda")
    cfg = default_config().model
    fine = restore_bare_params(str(ROOT / "results" / "convergence" / "final_params.npz"))["fine"]
    packed = pack_params(params_from_numpy(fine, dev), cfg, torch.bfloat16)
    stream = ray_wgmma.stream_for(packed, cfg)
    weights = _ext.pointer_array(packed)
    w, h = 800, 600
    ro, rd = generate_rays(spherical_pose(47.0, -30.0, 4.0), w, h,
                           focal_from_angle(w, 0.6911112070083618), dev)
    pick = torch.randperm(w * h, generator=torch.Generator().manual_seed(1))[:RAYS].to(dev)
    ro, rd = ro.reshape(-1, 3)[pick].contiguous(), rd.reshape(-1, 3)[pick].contiguous()
    g = torch.Generator(device=dev).manual_seed(0)
    z3 = torch.sort(2.0 + 4.0 * torch.rand(RAYS, 192, device=dev, generator=g), -1).values

    def launch(name, S, z, composited, out, wts):
        lib, has_comp = libs[name]
        args = [_ext.ptr(ro), _ext.ptr(rd), None if z is None else _ext.ptr(z),
                0 if z is None else z.stride(0), RAYS, S, 2.0 if z is None else 0.0,
                4.0 if z is None else 0.0, _ext.ptr(stream), weights, None, *net_args(cfg), 0]
        if has_comp:
            args += [int(composited), 4.0 / (S - 1) if z is None else 0.0, 1e10, 1e-10,
                     _ext.ptr(out), None if wts is None else _ext.ptr(wts)]
        else:
            args += [_ext.ptr(out)]
        _ext.check(lib, lib.ray_wgmma_render(*args, _ext.stream_ptr(dev)), f"{name} launch")

    for kernel, S, z, composited, reps in (("K1", 64, None, False, 20), ("K3", 192, z3, False, 8),
                                           ("K1 composited", 64, None, True, 20),
                                           ("K3 composited", 192, z3, True, 8)):
        names = [n for n, (_, has_comp) in libs.items() if has_comp or not composited]
        outs = {n: torch.empty(RAYS, 8, device=dev) if composited
                else torch.empty(RAYS * S, 4, device=dev) for n in names}
        wts = torch.empty(RAYS, S, device=dev) if composited and z is None else None
        for n in names:
            launch(n, S, z, composited, outs[n], wts)
        torch.cuda.synchronize()
        times = {n: [] for n in names}
        for n in (names + names[::-1]) * 3:
            times[n].append(call_ms(lambda: launch(n, S, z, composited, outs[n], wts), reps))
        print(json.dumps({"kernel": kernel, "rays": RAYS, "samples": S,
                          "median_ms": {n: float(np.median(t)) for n, t in times.items()},
                          "ms": times, "bit_equal_to_first": {
                              n: bool(torch.equal(outs[n], outs[names[0]])) for n in names},
                          "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
