"""The two readings each limit is set from, in one process on the card.

    python3 nerfbench/tools/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 2] [--out chiprun_out/x.jsonl]

For each of ``--seeds``: a run of the cell as the benchmark makes it (a
short window), its compared numbers. For each of ``--control-seeds``: the
control, the plain reference put in the program's place one precision step
lower (the workload's ``check.control``: ``fp8`` rounds every product's
operands to float8 e4m3, ``int4`` quantizes the weights to 4 bits), held
against the reference as the run holds the program (products on operands
rounded as the configuration states, bf16) on that seed's frames or steps
by the same numbers; for a training cell also the fault that leaves half of
each step's rays out of the loss. Beside them (``--witness 1``), the
reference in plain float32 products held against it the same way, a record
of what the configuration's own rounding does. One JSON line a reading.
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


def control_render(name, workload, config, seed, dev, witness=False):
    drv = harness.driver("render_loop")
    seq = traffic.poses(seed, workload["check"]["frames"], workload)
    nets = harness.weights(config, dev, seed)
    ref = drv.reference_frames(workload, config, nets, seq)
    if witness:
        ctl = drv.reference_frames(workload, config, nets, seq, rnd=None)
    elif workload["check"]["control"] == "fp8":
        ctl = drv.reference_frames(workload, config, nets, seq, rnd=ref_nerf.fp8_rounding)
    else:
        ctl = drv.reference_frames(workload, config, nets, seq, bits=4)
    return drv.gaps(ctl, ref)


def control_train(name, workload, config, seed, dev, fault=None):
    drv = harness.driver("train_loop")
    views = traffic.sphere_views(seed, workload, dev)
    nets = harness.weights(config, dev, seed)
    chunk = workload["chunk"]
    ref = drv.reference_run(views, config, nets, seed, chunk, dev)
    if fault == "float32":
        ctl = drv.reference_run(views, config, nets, seed, chunk, dev, rnd=None)
    elif fault == "half_batch":
        ctl = drv.reference_run(views, config, nets, seed, chunk, dev,
                                keep=config["train"]["n_rays"] // 2)
    else:
        ctl = drv.reference_run(views, config, nets, seed, chunk, dev, rnd=ref_nerf.fp8_rounding)
    init, chunks, _ = ctl
    prog_chunks = [(loss, {"params": params, "mu": mu}) for loss, params, mu in chunks]
    return drv.compare(init, prog_chunks, ref)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    p.add_argument("--witness", type=int, choices=(0, 1), default=1,
                   help="also read the control seeds against plain float32 products")
    a = p.parse_args()
    dev = torch.device("cuda")
    _, workload, config = harness.cell(a.workload)
    out = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for s in [int(x) for x in a.seeds.split(",") if x]:
        t = time.time()
        line, res = run.execute(a.workload, s, a.seconds, False, t_start=t)
        emit({"workload": a.workload, "kind": "program", "seed": s, "correct": line["correct"],
              "gaps": res.notes["gaps"], "metrics": {k: v["value"] for k, v in line["metrics"].items()},
              "notes": {k: v for k, v in res.notes.items() if k != "gaps"},
              "seconds": time.time() - t})
    for s in [int(x) for x in a.control_seeds.split(",") if x]:
        t = time.time()
        if workload["driver"] == "train_loop":
            for fault in (None, "half_batch", "float32")[:3 if a.witness else 2]:
                g = control_train(a.workload, workload, config, s, dev, fault)
                emit({"workload": a.workload, "kind": fault or workload["check"]["control"],
                      "seed": s, "gaps": g, "seconds": time.time() - t})
        else:
            for witness in (False, True)[:2 if a.witness else 1]:
                g = control_render(a.workload, workload, config, s, dev, witness)
                emit({"workload": a.workload, "seed": s, "gaps": g,
                      "kind": "float32" if witness else workload["check"]["control"],
                      "seconds": time.time() - t})


if __name__ == "__main__":
    main()
