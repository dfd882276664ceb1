"""Digests of what the training backward K5 writes, to hold two builds to the same bytes.

    python3 -m nerf_tpu_torch.tools.k5_digest OUT.json

On the trained weights of ``results/convergence/final_params.npz`` and seeded
samples on camera rays, at a train step's coarse pass (131,072 samples), its
fine pass (393,216) and a ragged 65,537, each pass of at most
``train_kernel.PASS_ROWS`` rows runs as ``train_kernel._launch`` runs it: the
row pass K5a into a scratch first filled with 0xFF bytes, so that a byte it
leaves unwritten shows, then the weight-gradient pass K5b into partials. The
SHA-256 of each pass's scratch image (padding rows included) and partials,
and of the gradients summed over the passes, are written to ``OUT.json``.
Two builds agree bit for bit when their digests do: ``chip_smoke.py
--k5-reference OUT.json`` compares its own build's with a file another
commit wrote. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import torch

from nerf_tpu_torch.config import default_config
from nerf_tpu_torch.models.nerf import params_from_numpy
from nerf_tpu_torch.ops import _ext, ray_wgmma, train_kernel
from nerf_tpu_torch.ops.mlp_kernel import net_args, pack_params
from nerf_tpu_torch.train.checkpoint import restore_bare_params
from nerf_tpu_torch.utils.cameras import focal_from_angle, generate_rays, spherical_pose

ROOT = Path(__file__).resolve().parents[2]
SHAPES = (131072, 393216, 65537)   # a train step's coarse and fine pass, and a ragged one
SEED = 24


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def samples(n: int, dev: torch.device, seed: int = SEED):
    """``n`` samples on camera rays of an 800 x 600 view at 192 sorted random
    depths each, and cotangents of a loss's scale: positions, directions,
    dsigma, drgb."""
    w, h, S = 800, 600, 192
    ro, rd = generate_rays(spherical_pose(47.0, -30.0, 4.0), w, h,
                           focal_from_angle(w, 0.6911112070083618), dev)
    g = torch.Generator(device=dev).manual_seed(seed + n)
    rays = -(-n // S)
    pick = torch.randperm(w * h, device=dev, generator=g)[:rays]
    ro, rd = ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick]
    z = torch.sort(2.0 + 4.0 * torch.rand(rays, S, device=dev, generator=g), -1).values
    pos = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)[:n].contiguous()
    dirs = rd[:, None, :].expand(rays, S, 3).reshape(-1, 3)[:n].contiguous()
    dsig = torch.randn(n, device=dev, generator=g) / n
    drgb = torch.randn(n, 3, device=dev, generator=g) / n
    return pos, dirs, dsig, drgb


def digests(lib=None, dev: torch.device = torch.device("cuda")) -> dict:
    """``{rows: {"passes": [{"rows", "scratch", "partials"}], "grads"}}`` of
    the bound build ``lib`` (``train_kernel.load()`` if None)."""
    lib = train_kernel.load() if lib is None else lib
    cfg = default_config().model
    fine = restore_bare_params(str(ROOT / "results" / "convergence" / "final_params.npz"))["fine"]
    packed = pack_params(params_from_numpy(fine, dev), cfg, torch.bfloat16)
    stream = ray_wgmma.bwd_stream(packed, cfg)
    jobs = train_kernel.jobs_tensor(cfg).to(dev)
    out = {}
    for n in SHAPES:
        pos, dirs, dsig, drgb = samples(n, dev)
        passes, parts = [], []
        for p0, p1 in train_kernel.pass_bounds(n):
            rows = p1 - p0
            scratch = torch.full((train_kernel.scratch_elems(rows),), -1, dtype=torch.int16,
                                 device=dev)
            err = lib.bwd_rows_wgmma(
                _ext.ptr(pos[p0:p1]), _ext.ptr(dirs[p0:p1]), _ext.ptr(dsig[p0:p1]),
                _ext.ptr(drgb[p0:p1]), rows, _ext.ptr(stream), _ext.pointer_array(packed),
                *net_args(cfg), _ext.ptr(scratch), _ext.stream_ptr(dev))
            _ext.check(lib, err, "bwd_rows_wgmma launch")
            splits = train_kernel.n_splits(rows)
            partials = torch.full((splits, train_kernel.GRAD_FLOATS), float("nan"), device=dev)
            err = lib.wgrad_wgmma(_ext.ptr(scratch), rows, _ext.ptr(jobs), jobs.shape[0], splits,
                                  _ext.ptr(partials), 0, train_kernel.GRAD_FLOATS,
                                  _ext.stream_ptr(dev))
            _ext.check(lib, err, "wgrad_wgmma launch")
            passes.append({"rows": rows, "scratch": sha(scratch), "partials": sha(partials)})
            parts.append(partials)
            del scratch
        out[str(n)] = {"passes": passes, "grads": sha(torch.cat(parts).sum(0))}
        torch.cuda.empty_cache()
    return out


def main(argv):
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    result = {"device": torch.cuda.get_device_name(0), "digests": digests()}
    Path(argv[0]).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
