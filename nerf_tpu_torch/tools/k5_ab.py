"""Time several copies of ``csrc/mlp_backward_wgmma.cu`` against each other on one card.

    python3 -m nerf_tpu_torch.tools.k5_ab NAME=path.cu [NAME=path.cu ...]

A change of the training backward's row pass K5a is judged by timing the
edited source beside the one it changes, in one process on one card. Each
copy is built next to the package's headers and bound with ctypes. Per copy:
ptxas's registers and spills, and the count of each SASS opcode family of
``bwd_rows_wgmma_kernel`` that stores (``sass_stores``). On the trained
weights and seeded samples of ``k5_digest``, K5a alone on one full pass
(65,536 rows), a train step's K5 (the coarse pass of 131,072 samples and
the fine pass of 393,216: 8 passes of K5a + K5b), and that step's K5a and
K5b launches each on their own, run by CUDA events in turns
(the copies forward, then backward, three times). Then each copy's
``k5_digest.digests`` is compared with the first copy's: the scratch image
and the partials of every pass, bit for bit. Prints the card's name and
power limit, then one JSON line per copy and one with the medians. Needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from nerf_tpu_torch.config import default_config
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.ops import _ext, ray_wgmma, train_kernel
from nerf_tpu_torch.ops.mlp_kernel import net_args, pack_params
from nerf_tpu_torch.tools import k5_digest
from nerf_tpu_torch.train.checkpoint import restore_bare_params

ROOT = Path(__file__).resolve().parents[2]
ROWS_KERNEL = "bwd_rows_wgmma_kernel"


def sass_stores(so: Path, kernel: str = ROWS_KERNEL) -> dict:
    """Opcode families of ``kernel``'s SASS in the library ``so`` that store:
    STG (global), STS (shared), ST (generic), the bulk copies (UBLKCP), and
    SYNCS / BAR for the barriers around them."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    body = next((part for part in sass.split("Function : ")[1:]
                 if kernel in part.splitlines()[0]), "")
    ops = Counter(m.group(1).split(".")[0] for m in
                  re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", body))
    return {k: ops.get(k, 0) for k in ("STG", "STS", "ST", "UBLKCP", "BAR", "SYNCS")}


def build(copies, out: Path):
    """Each ``name -> source`` built beside the headers into ``out``: name ->
    (bound library, ptxas lines, path)."""
    out.mkdir(parents=True, exist_ok=True)
    for header in _ext.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    procs = {}
    for name, src in copies.items():
        shutil.copy(src, out / f"{name}.cu")
        cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, (argtypes, restype) in train_kernel._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Function properties" in ln]
        libs[name] = (lib, ptxas, out / f"{name}.so")
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
    libs = build(copies, ROOT / "build" / "k5_ab")
    dev = torch.device("cuda")
    cfg = default_config().model
    fine = restore_bare_params(str(ROOT / "results" / "convergence" / "final_params.npz"))["fine"]
    packed = pack_params(params_from_numpy(fine, dev), cfg, torch.bfloat16)
    stream = ray_wgmma.bwd_stream(packed, cfg)
    weights = _ext.pointer_array(packed)
    jobs = train_kernel.jobs_tensor(cfg).to(dev)
    step = [k5_digest.samples(n, dev) for n in (131072, 393216)]
    rows = train_kernel.PASS_ROWS
    scratch = torch.empty(train_kernel.scratch_elems(rows), dtype=torch.bfloat16, device=dev)
    partials = torch.empty(6 * 8, train_kernel.GRAD_FLOATS, device=dev)

    def k5a(lib, inputs, p0, p1):
        pos, dirs, dsig, drgb = inputs
        err = lib.bwd_rows_wgmma(_ext.ptr(pos[p0:p1]), _ext.ptr(dirs[p0:p1]),
                                 _ext.ptr(dsig[p0:p1]), _ext.ptr(drgb[p0:p1]), p1 - p0,
                                 _ext.ptr(stream), weights, *net_args(cfg), _ext.ptr(scratch),
                                 _ext.stream_ptr(dev))
        _ext.check(lib, err, "bwd_rows_wgmma launch")

    def timed(events, kernel):
        """``kernel()`` between two recorded events, appended to ``events``
        (None: untimed)."""
        if events is None:
            return kernel()
        events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()
        kernel()
        events[-1][1].record()

    def k5_step(lib, a_events=None, b_events=None):
        slot = 0
        for inputs in step:
            for p0, p1 in train_kernel.pass_bounds(inputs[0].shape[0]):
                timed(a_events, lambda: k5a(lib, inputs, p0, p1))
                splits = train_kernel.n_splits(p1 - p0)
                timed(b_events, lambda: _ext.check(lib, lib.wgrad_wgmma(
                    _ext.ptr(scratch), p1 - p0, _ext.ptr(jobs), jobs.shape[0], splits,
                    _ext.ptr(partials), slot, train_kernel.GRAD_FLOATS, _ext.stream_ptr(dev)),
                    "wgrad_wgmma launch"))
                slot += splits

    def in_step_ms(lib, reps=5):
        """K5a's and K5b's device ms a step, each launch in the step's order."""
        k5_step(lib)
        a_events, b_events = [], []
        for _ in range(reps):
            k5_step(lib, a_events, b_events)
        torch.cuda.synchronize()
        return [sum(a.elapsed_time(b) for a, b in ev) / reps for ev in (a_events, b_events)]

    names = list(libs)
    times = {n: {"k5a_pass_ms": [], "k5_step_ms": [], "k5a_step_ms": [], "k5b_step_ms": []}
             for n in names}
    for n in (names + names[::-1]) * 3:
        lib = libs[n][0]
        times[n]["k5a_pass_ms"].append(call_ms(lambda: k5a(lib, step[1], 0, rows), 20))
        times[n]["k5_step_ms"].append(call_ms(lambda: k5_step(lib), 5))
        for key, ms in zip(("k5a_step_ms", "k5b_step_ms"), in_step_ms(lib)):
            times[n][key].append(ms)
    del scratch, partials
    torch.cuda.empty_cache()
    first = None
    for n in names:
        lib, ptxas, so = libs[n]
        dig = k5_digest.digests(lib, dev)
        first = dig if first is None else first
        staging = ([lib.bwd_rows_staging(i) for i in (0, 1)]
                   if hasattr(lib, "bwd_rows_staging") else None)
        print(json.dumps({
            "copy": n, "source": copies[n], "ptxas": ptxas, "sass_stores": sass_stores(so),
            "rows_smem_bytes": lib.bwd_rows_smem_bytes(), "ring_stages": lib.bwd_rows_stages(),
            "staging_piece_bytes_and_depth": staging,
            "median_ms": {k: float(np.median(v)) for k, v in times[n].items()}, "ms": times[n],
            "bit_equal_to_first": dig == first,
            "passes_bit_equal_to_first": {r: [a == b for a, b in zip(d["passes"],
                                                                    first[r]["passes"])]
                                          for r, d in dig.items()},
            "nvidia_smi": smi}), flush=True)
    print(json.dumps({"median_ms": {n: {k: float(np.median(v)) for k, v in times[n].items()}
                                    for n in names}, "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
