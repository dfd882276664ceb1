"""The two readings the mip360 cell's limits are set from, in one process on
the card: ``readings_mip.py``'s procedure for the driver
``mip360_render_loop``.

    python3 nerfbench/tools/readings_mip360.py --workload mip360-frames --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults no_dilation,...] [--seconds 2] \
        [--out readings.jsonl]

For each of ``--seeds``: a run of the cell as the benchmark makes it (a
short window), its compared numbers. For each of ``--control-seeds``: the
control, ``reference/mip360.py`` put in the program's place with every
product's operands rounded to float8 e4m3 (``check.control`` ``fp8``), held
against the reference as the run holds the program (operands rounded to
bf16) on that seed's frames and probe rays, by the same numbers; beside it
(``--witness 1``) the reference in plain float32 products held against it
the same way. For each of ``--faults`` (``FAULTS``): a run on the first of
``--seeds`` with the program's levels broken in that way, which has to come
out not correct. One JSON line a reading, each with ``correct`` as the
harness decides it from the gaps and the workload's limits
(``harness.checks``). The tool exits 1 if an fp8 control or a planted fault
comes out correct.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from nerfbench import harness, run, traffic  # noqa: E402
from nerfbench.reference import nerf as ref_nerf  # noqa: E402

FAULTS = ("no_dilation", "one_proposal_level", "nerf_density_dropped")


def broken(fault: str, config: dict):
    """``(name, replacement)`` of the attribute of ``render/engines.py`` that
    plants ``fault`` in the mip360 path: the levels drawn without dilating
    the step function; the NeRF level drawn from the first proposal level's
    weights (the second one's ignored); the NeRF pass's density without its
    product (the head's bias alone)."""
    from nerf_tpu_torch.render import engines
    from nerf_tpu_torch.utils.rendering import sample_intervals

    resample, nerf = engines.resample_360, engines.nerf_mip360_raw
    first = {}

    def no_dilation(s, w, n, prod, rcfg):
        return sample_intervals(s, w, n, rcfg.resample_padding)

    def one_proposal_level(s, w, n, prod, rcfg):
        if prod == rcfg.n_coarse:          # the second proposal level's edges
            first["s"], first["w"] = s, w
        else:                              # the NeRF level's
            s, w = first["s"], first["w"]
        return resample(s, w, n, prod, rcfg)

    def nerf_density_dropped(*a, **k):
        raw = nerf(*a, **k).clone()
        raw[:, 0::4] = torch.nn.functional.softplus(
            torch.tensor(config["model"]["density_bias"]))
        return raw

    return {"no_dilation": ("resample_360", no_dilation),
            "one_proposal_level": ("resample_360", one_proposal_level),
            "nerf_density_dropped": ("nerf_mip360_raw", nerf_density_dropped)}[fault]


def control(workload, config, seed, dev, witness=False):
    drv = harness.driver("mip360_render_loop")
    seq = traffic.poses(seed, workload["check"]["frames"], workload)
    nets = drv.nets_of(config, seed, dev)
    ref = drv.reference_frames(workload, config, nets, seq)
    rnd = None if witness else ref_nerf.fp8_rounding
    ctl = drv.reference_frames(workload, config, nets, seq, rnd=rnd)
    gaps = harness.driver("render_loop").gaps(ctl, ref)
    rays = [drv.probe_rays(workload, pose, seed + k, dev) for k, pose in enumerate(seq)]
    ctl_probe = [drv.reference_probe(workload, config, nets, ro, rd, rnd=rnd) for ro, rd in rays]
    gaps.update(drv.probe_gaps(ctl_probe, [
        drv.reference_probe(workload, config, nets, ro, rd, at=probe[1])
        for (ro, rd), probe in zip(rays, ctl_probe)]))
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
    if workload["driver"] != "mip360_render_loop" or workload["check"]["control"] != "fp8":
        raise SystemExit("readings_mip360 reads the mip360_render_loop cells, whose control is fp8")
    out = open(a.out, "a") if a.out else None
    limits = workload["check"]["limits"]
    wrong = []

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(s, kind):
        t = time.time()
        line, res = run.execute(a.workload, s, a.seconds, False, t_start=t)
        if kind != "program" and line["correct"]:
            wrong.append(f"{kind} on seed {s}")
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
            gaps = control(workload, config, s, dev, witness)
            ok = harness.Outcome({}, 0, 0, harness.checks(gaps, limits), 0).correct
            if ok and not witness:
                wrong.append(f"the fp8 control on seed {s}")
            emit({"workload": a.workload, "seed": s, "gaps": gaps, "correct": ok,
                  "kind": "float32" if witness else "fp8", "seconds": time.time() - t})
    if wrong:
        raise SystemExit(f"readings_mip360: correct where it must not be: {', '.join(wrong)}")


if __name__ == "__main__":
    main()
