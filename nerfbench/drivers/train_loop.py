"""Graphed training: ``NeRFTrainer.train_epoch`` over whole epochs.

Set-up makes the views from the seed, builds the trainer, writes the
configuration's weights into its params (in place, as a checkpoint's
load does: a start from the seed's own init leaves a network dead on about
half of all seeds, where no check can see the step's arithmetic), and
drives that same trainer through its first two calls of
``train_epoch`` on views ``0..k-1`` and ``k..2k-1`` (``k`` the trainer's
chunk of steps; the first call runs eagerly and captures the chunk's CUDA
graph, the second replays it, as every call of the window does), then one
whole epoch, which uploads the views. The window runs whole epochs until
``seconds`` have passed; each ends at the trainer's own loss read.

The reference (``reference/train.py``) starts from the same weights and
follows the same ``2k`` steps on the same views and draws. The checks:
each checked call's mean loss, and per leaf the norm of the first moment
(the gradients as the optimizer took them) and of the params' change after
each call, against the reference's, over the leaves whose gradient is not
nought to rounding.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from nerfbench import flops, harness, trace, traffic
from nerfbench.reference import nerf as ref_nerf
from nerfbench.reference import train as ref_train


def leaf_table(params) -> dict:
    return {p: t.detach().clone() for p, t in ref_nerf.leaves(params)}


def snapshot(state) -> dict:
    """The program's params and first moments by leaf path."""
    table = leaf_table(state.params)
    by_id = {id(t): p for p, t in ref_nerf.leaves(state.params)}
    mu = {by_id[id(leaf)]: m.detach().clone()
          for leaf, m in zip(state.leaves(), state.optimizer.mu)}
    return {"params": table, "mu": mu}


def norm_gaps(prog: dict, ref: dict, counted) -> list:
    """Per counted leaf, ``|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    norms = {p: float(ref[p].norm()) for p in counted}
    med = float(np.median(list(norms.values())))
    return [abs(float(prog[p].norm()) - norms[p]) / max(norms[p], med, 1e-30) for p in counted]


def reference_run(views, config: dict, nets: dict, seed: int, chunk: int, device,
                  rnd="config", keep=None):
    """The reference's ``2 chunk`` steps from ``nets``, its
    products on operands rounded as the configuration states (``rnd``:
    another rounding, the control's): ``(initial params, [(mean loss,
    params, first moments)] a chunk, largest gradient norm a leaf)``."""
    if rnd == "config":
        rnd = ref_nerf.rounding_of(config)
    ref_nerf.disable_tf32()
    torch.set_float32_matmul_precision("highest")
    model, render = config["model"], config["render"]
    train = {**config["train"], "n_rays": config["train"]["n_rays"]}
    nets = ref_nerf.map_params(lambda t: t.detach().clone(), nets)
    init = leaf_table(nets)
    tr = ref_train.Trainer(nets, seed, model, render, train, device, rnd, keep)
    images = torch.as_tensor(views.images[:2 * chunk], device=device)
    poses = torch.as_tensor(views.poses[:2 * chunk], device=device)
    chunks = []
    for c in range(2):
        losses = [tr.step(images[i], poses[i], views.focal)
                  for i in range(c * chunk, (c + 1) * chunk)]
        mu = dict(zip(tr.paths, (m.detach().clone() for m in tr.opt.mu)))
        params = dict(zip(tr.paths, (p.detach().clone() for p in tr.params)))
        chunks.append((float(np.mean(losses)), params, mu))
    return init, chunks, dict(zip(tr.paths, tr.grad_norms))


def leaf_name(path) -> str:
    return "/".join(str(p) for p in path)


def compare(init_prog: dict, prog_chunks, ref) -> dict:
    """The gaps between the program's checked calls and the reference's:
    ``loss_gap`` (a call's mean loss, relative), and per counted leaf the first moment's and the
    params' change's norm gaps: the worst leaf (``moment_gap``,
    ``update_gap``, named in ``*_leaf``) and the median leaf
    (``*_median``), worst over the calls. A leaf counts where the reference's gradient reaches a thousandth
    of the median leaf's."""
    init_ref, ref_chunks, grad_norms = ref
    med = float(np.median(list(grad_norms.values())))
    counted = [p for p, n in grad_norms.items() if n >= 1e-3 * med]
    out = {"loss_gap": 0.0, "moment_gap": 0.0, "update_gap": 0.0,
           "moment_gap_median": 0.0, "update_gap_median": 0.0}
    prev_p, prev_r = init_prog, init_ref
    for (loss_p, snap), (loss_r, params_r, mu_r) in zip(prog_chunks, ref_chunks):
        out["loss_gap"] = max(out["loss_gap"], abs(loss_p - loss_r) / abs(loss_r))
        m = norm_gaps(snap["mu"], mu_r, counted)
        dp = {p: snap["params"][p] - prev_p[p] for p in counted}
        dr = {p: params_r[p] - prev_r[p] for p in counted}
        u = norm_gaps(dp, dr, counted)
        if max(m) > out["moment_gap"]:
            out["moment_gap"], out["moment_gap_leaf"] = max(m), leaf_name(counted[m.index(max(m))])
        if max(u) > out["update_gap"]:
            out["update_gap"], out["update_gap_leaf"] = max(u), leaf_name(counted[u.index(max(u))])
        out["moment_gap_median"] = max(out["moment_gap_median"], float(np.median(m)))
        out["update_gap_median"] = max(out["update_gap_median"], float(np.median(u)))
        prev_p, prev_r = snap["params"], params_r
    out["leaves_counted"] = len(counted)
    return out


def run(workload: dict, config: dict, seed: int, seconds: float, trace_on: bool, device,
        t_start: float) -> harness.Outcome:
    from nerf_tpu_torch.train.trainer import NeRFTrainer

    dev = torch.device(device)
    cfg = harness.program_config(config, seed)
    views = traffic.sphere_views(seed, workload, dev)
    w, h = traffic.resolution(workload)
    chunk = workload["chunk"]
    nets = harness.weights(config, dev, seed)
    trainer = NeRFTrainer(cfg, (h, w), device=dev)
    with torch.no_grad():
        for (path, leaf), (_, value) in zip(ref_nerf.leaves(trainer.state.params),
                                            ref_nerf.leaves(nets)):
            leaf.copy_(value)
    init_prog = leaf_table(trainer.state.params)
    prog_chunks = []
    for c in range(2):
        loss = trainer.train_epoch(views.part(c * chunk, (c + 1) * chunk))
        prog_chunks.append((loss, snapshot(trainer.state)))
    trainer.train_epoch(views)

    def epoch():
        with record_function("NeRFTrainer.train_epoch"):
            return trainer.train_epoch(views)

    epochs = 0
    t_begin = time.perf_counter()
    setup_s = time.time() - t_start
    while True:
        epoch()
        epochs += 1
        t1 = time.perf_counter()
        if t1 - t_begin >= seconds:
            break
    window_s = t1 - t_begin
    steps = epochs * len(views)

    traced = None
    if trace_on:
        _, tr, _ = trace.traced(epoch, trace.port_kernels(harness.PACKAGE))
        per_step = flops.step_flops(config["model"], config["train"]["n_rays"],
                                    config["render"])
        traced = harness.Traced(tr, len(views), {**per_step, "total": sum(per_step.values())})

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    values = compare(init_prog, prog_chunks,
                     reference_run(views, config, nets, seed, chunk, dev))
    return harness.Outcome(
        metrics={"train_step_ms": window_s * 1e3 / steps, "setup_s": setup_s},
        attempted=steps, failed=0,
        checks=harness.checks(values, workload["check"]["limits"]),
        memory_peak_bytes=int(peak), traced=traced,
        notes={"epochs": epochs, "window_s": window_s, "gaps": values,
               "check_s": time.perf_counter() - t_check,
               "losses": [c[0] for c in prog_chunks]})
