"""The two readings the mip cells' limits are set from, in one process on the
card: ``readings.py``'s procedure for the driver ``mip_render_loop``.

    python3 nerfbench/tools/readings_mip.py --workload mip-hier --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults coarse_edges,...] [--seconds 2] \
        [--out readings.jsonl]

For each of ``--seeds``: a run of the cell as the benchmark makes it (a
short window), its compared numbers. For each of ``--control-seeds``: the
control, ``reference/mip.py`` put in the program's place with every
product's operands rounded to float8 e4m3 (``check.control`` ``fp8``), held
against the reference as the run holds the program (operands rounded to
bf16) on that seed's frames and probe rays, by the same numbers; beside it
(``--witness 1``) the reference in plain float32 products held against it
the same way. For each of ``--faults`` (``FAULTS``): a run on the first of
``--seeds`` with the program's fine pass broken in that way, which has to
come out not correct. One JSON line a reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from nerfbench import harness, run, traffic  # noqa: E402
from nerfbench.reference import mip as ref_mip  # noqa: E402
from nerfbench.reference import nerf as ref_nerf  # noqa: E402


FAULTS = ("coarse_edges", "no_blur", "no_padding", "k3_uniform", "k3_density_dropped")


def broken(fault: str, config: dict):
    """``(name, replacement)`` of the attribute of ``render/engines.py`` that
    plants ``fault`` in the mip path: the fine pass at the coarse edges; the
    resampler without its blur, or without its padding; K3-mip at uniform
    edges whatever edges it is given; K3-mip's density without its
    product (the head's bias alone)."""
    from nerf_tpu_torch.render import engines

    resample, k3 = engines.mip_resample, engines.fused_render_edges_mip_raw
    near, far = config["render"]["near"], config["render"]["far"]

    def k3_uniform(packed, ro, rd, radius, edges, *a, **k):
        t = torch.linspace(near, far, edges.shape[1], device=edges.device)
        return k3(packed, ro, rd, radius, t.expand_as(edges).contiguous(), *a, **k)

    def k3_density_dropped(*a, **k):
        raw = k3(*a, **k).clone()
        raw[:, 0::4] = torch.nn.functional.softplus(
            torch.tensor(config["model"]["density_bias"]))
        return raw

    return {
        "coarse_edges": ("mip_resample", lambda edges, w, pad: edges),
        "no_blur": ("mip_resample", lambda edges, w, pad: ref_mip.sorted_piecewise_constant_pdf(
            edges, w + pad, edges.shape[1])),
        "no_padding": ("mip_resample", lambda edges, w, pad: resample(edges, w, 0.0)),
        "k3_uniform": ("fused_render_edges_mip_raw", k3_uniform),
        "k3_density_dropped": ("fused_render_edges_mip_raw", k3_density_dropped),
    }[fault]


def control(workload, config, seed, dev, witness=False):
    drv = harness.driver("mip_render_loop")
    seq = traffic.poses(seed, workload["check"]["frames"], workload)
    net = drv.nets_of(config, seed, dev)["fine"]
    ref = drv.reference_frames(workload, config, net, seq)
    rnd = None if witness else ref_nerf.fp8_rounding
    ctl = drv.reference_frames(workload, config, net, seq, rnd=rnd)
    gaps = harness.driver("render_loop").gaps(ctl, ref)
    rays = [drv.probe_rays(workload, pose, seed + k, dev) for k, pose in enumerate(seq)]
    ctl_probe = [drv.reference_probe(workload, config, net, ro, rd, rnd=rnd) for ro, rd in rays]
    gaps.update(drv.probe_gaps(ctl_probe, [
        drv.reference_probe(workload, config, net, ro, rd, at=edges)
        for (ro, rd), (edges, _) in zip(rays, ctl_probe)]))
    return gaps


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="", help=f"comma-separated, of {', '.join(FAULTS)}")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    p.add_argument("--witness", type=int, choices=(0, 1), default=1,
                   help="also read the control seeds against plain float32 products")
    a = p.parse_args()
    dev = torch.device("cuda")
    _, workload, config = harness.cell(a.workload)
    if workload["driver"] != "mip_render_loop" or workload["check"]["control"] != "fp8":
        raise SystemExit("readings_mip reads the mip_render_loop cells, whose control is fp8")
    out = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(s, kind):
        t = time.time()
        line, res = run.execute(a.workload, s, a.seconds, False, t_start=t)
        emit({"workload": a.workload, "kind": kind, "seed": s, "correct": line["correct"],
              "gaps": res.notes["gaps"], "metrics": {k: v["value"] for k, v in line["metrics"].items()},
              "notes": {k: v for k, v in res.notes.items() if k != "gaps"},
              "seconds": time.time() - t})

    seeds = [int(x) for x in a.seeds.split(",") if x]
    for s in seeds:
        program(s, "program")
    from nerf_tpu_torch.render import engines

    for fault in [x for x in a.faults.split(",") if x]:
        name, replacement = broken(fault, config)
        original = getattr(engines, name)
        setattr(engines, name, replacement)
        try:
            program(seeds[0], f"fault:{fault}")
        finally:
            setattr(engines, name, original)
    for s in [int(x) for x in a.control_seeds.split(",") if x]:
        t = time.time()
        for witness in (False, True)[:2 if a.witness else 1]:
            emit({"workload": a.workload, "seed": s, "gaps": control(workload, config, s, dev, witness),
                  "kind": "float32" if witness else "fp8", "seconds": time.time() - t})


if __name__ == "__main__":
    main()
