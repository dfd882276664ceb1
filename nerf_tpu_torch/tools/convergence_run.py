"""Training-convergence run on the card: the port's counterpart of
``scripts/convergence_run.py``.

    python3 -m nerf_tpu_torch.tools.convergence_run [--steps 12000]
        [--out results/convergence_torch] [--img 400] [--views 40]
        [--val-every 500] [--device cuda] [--seed 3]

Trains the full NeRF (reference architecture, white background, 2,048 rays
a step, 64 coarse + 128 fine samples with importance sampling, Adam 3e-4
with per-step decay, gradient clip 1.0, bf16 compute and float32 params:
the default ``Config``) on the procedural multi-view scene, ``--views``
training views and 8 held out, at ``--img`` x ``--img``. Each epoch is
``NeRFTrainer.train_epoch`` (on the card, chunks of 10 steps, each one CUDA
graph of the K4 forward and K5 backward kernels); ``validate`` runs where
``step % val_every < steps per epoch`` and after the last epoch, as in the
JAX script. Writes under ``--out``:

  trajectory.json    the JAX script's keys (config, trajectory of step,
                     train_loss, val_mse, val_psnr_db, wall_time_s); config
                     adds ``seed``, and ``device`` is the card's name and
                     power limit as nvidia-smi gives them; ``timing`` splits
                     the wall clock into training (its first epoch apart:
                     it holds the kernels' build at first use and the
                     graph's capture; ms per step is the later epochs')
                     and validation (ms per view), and
                     ``train_losses`` holds every epoch's mean loss
  final_rgb.png      a held-out view rendered with the final weights
  final_depth.png    its depth, normalized to [0, 255]
  ground_truth.png   that view
  final_params.npz   the trained params, keyed by keystr paths as
                     ``results/convergence/final_params.npz``
  psnr_curve.png     val PSNR and train loss over the steps, only where
                     matplotlib is installed (one line says so otherwise)

The quality bar is the JAX run's: >= 28 dB val PSNR after the last epoch;
the exit code is 1 below it. ``--seed`` (default 3, the chip smoke's) seeds
the params and the steps' draws: at the default ``Config`` seed 0 the port's
fine network starts with a density of 0 on every sample and never trains.
``--device`` defaults to the card and raises without one; ``cpu`` runs the
kernels' plain versions (the tests shrink the run to seconds).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerf_tpu_torch.bench.suite import write_png
from nerf_tpu_torch.config import Config, RenderConfig, TrainConfig
from nerf_tpu_torch.data.synthetic import make_procedural_dataset
from nerf_tpu_torch.models.nerf import params_to_numpy
from nerf_tpu_torch.train.checkpoint import save_bare_params
from nerf_tpu_torch.train.trainer import NeRFTrainer
from nerf_tpu_torch.utils.device import resolve_device

QUALITY_BAR_DB = 28.0
DEFAULT_SEED = 3


def _print(line: str) -> None:
    print(line, flush=True)


def device_label(dev: torch.device) -> str:
    """The card's ``name, power.limit`` line from nvidia-smi, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    return lines[dev.index or 0].strip()


def validation_steps(steps: int, views: int, val_every: int):
    """The steps after which the run validates (the JAX script's rule)."""
    n_epochs = (steps + views - 1) // views
    return [(e + 1) * views for e in range(n_epochs)
            if ((e + 1) * views) % val_every < views or e == n_epochs - 1]


def recipe(img: int = 400, seed: int = DEFAULT_SEED) -> Config:
    """The JAX script's ``Config``: white background, 2,048 rays a step, the
    default model, sampling and schedule; ``seed`` for the params and draws."""
    return Config(render=RenderConfig(white_background=True),
                  train=TrainConfig(n_rays=2048, seed=seed), img_wh=(img, img))


def run(steps: int = 12000, out: str = "results/convergence_torch", img: int = 400,
        views: int = 40, val_every: int = 500, device="cuda", seed: int = DEFAULT_SEED,
        cfg: Optional[Config] = None, log: Callable[[str], None] = _print) -> Dict:
    """Train and validate as the module docstring says; write the files
    under ``out`` and return the trajectory dict. ``cfg`` defaults to
    ``recipe(img, seed)`` (the tests pass a narrower one; its ``img_wh``
    is the views' size)."""
    dev = resolve_device(device)             # raises before anything is made without a card
    os.makedirs(out, exist_ok=True)
    cfg = cfg if cfg is not None else recipe(img, seed)
    wh = tuple(cfg.img_wh)
    label = device_label(dev)
    log(f"device: {label}")
    train_ds = make_procedural_dataset(views, wh, seed=0, split="train")
    val_ds = make_procedural_dataset(8, wh, seed=123, split="val")

    trainer = NeRFTrainer(cfg, (wh[1], wh[0]), device=dev)
    steps_per_epoch = len(train_ds)
    n_epochs = (steps + steps_per_epoch - 1) // steps_per_epoch
    val_at = set(validation_steps(steps, steps_per_epoch, val_every))
    val_views = min(len(val_ds), cfg.train.max_val_images)

    traj, epoch_s = [], []
    val_s = 0.0
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        t = time.perf_counter()
        loss = trainer.train_epoch(train_ds)    # reads the loss: the epoch has ended
        epoch_s.append(time.perf_counter() - t)
        step = (epoch + 1) * steps_per_epoch
        if step in val_at:
            t = time.perf_counter()
            val_mse = trainer.validate(val_ds)
            val_s += time.perf_counter() - t
            val_psnr = float(10 * np.log10(1.0 / max(val_mse, 1e-12)))
            traj.append({"step": step, "train_loss": loss, "val_mse": val_mse,
                         "val_psnr_db": val_psnr})
            dt = time.perf_counter() - t0
            log(f"step {step:6d}  loss {loss:.6f}  val_mse {val_mse:.6f}  "
                f"val_psnr {val_psnr:.2f} dB  ({dt:.0f}s, {step / dt:.1f} steps/s incl. val)")
        trainer.train_losses.append(loss)
    wall = time.perf_counter() - t0
    later = epoch_s[1:] or epoch_s            # the first epoch builds and captures

    result = {
        "config": {"img_wh": list(wh), "views": views, "n_rays": cfg.train.n_rays,
                   "samples": [cfg.render.n_coarse, cfg.render.n_fine],
                   "importance": cfg.render.use_importance, "steps": steps,
                   "device": label, "seed": cfg.train.seed},
        "trajectory": traj,
        "wall_time_s": wall,
        "train_losses": list(trainer.train_losses),
        "timing": {"train_s": sum(epoch_s), "first_epoch_s": epoch_s[0],
                   "ms_per_step": 1e3 * sum(later) / (len(later) * steps_per_epoch),
                   "validate_s": val_s, "validations": len(traj), "val_views": val_views,
                   "val_ms_per_view": 1e3 * val_s / (len(traj) * val_views)},
    }
    with open(os.path.join(out, "trajectory.json"), "w") as f:
        json.dump(result, f, indent=2)

    if importlib.util.find_spec("matplotlib") is not None:
        _plot(traj, wh, views, os.path.join(out, "psnr_curve.png"))
    else:
        log("matplotlib is not installed: no psnr_curve.png")

    item = val_ds[0]
    rgb, depth = trainer.render_image(trainer.state.params, item["pose"], (wh[1], wh[0]),
                                      float(val_ds.focal))
    rgb, d = rgb.float().cpu().numpy(), depth.float().cpu().numpy()
    write_png(os.path.join(out, "final_rgb.png"), (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    write_png(os.path.join(out, "ground_truth.png"),
              (np.clip(item["image"], 0, 1) * 255).astype(np.uint8))
    dn = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
    write_png(os.path.join(out, "final_depth.png"), (dn * 255).astype(np.uint8))
    save_bare_params(os.path.join(out, "final_params.npz"), params_to_numpy(trainer.state.params))
    return result


def _plot(traj, wh, views, path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots(figsize=(8, 5))
    steps = [t["step"] for t in traj]
    ax1.plot(steps, [t["val_psnr_db"] for t in traj], "o-", color="tab:blue", label="val PSNR")
    ax1.set_xlabel("optimizer step")
    ax1.set_ylabel("val PSNR (dB)", color="tab:blue")
    ax1.axhline(QUALITY_BAR_DB, color="tab:blue", ls=":", lw=1, label="28 dB bar")
    ax2 = ax1.twinx()
    ax2.plot(steps, [t["train_loss"] for t in traj], "s--", color="tab:red", alpha=0.6,
             label="train loss")
    ax2.set_ylabel("train MSE", color="tab:red")
    ax2.set_yscale("log")
    ax1.set_title(f"NeRF convergence (port), procedural scene {wh[0]}x{wh[1]}, {views} views")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--out", default="results/convergence_torch")
    ap.add_argument("--img", type=int, default=400)
    ap.add_argument("--views", type=int, default=40)
    ap.add_argument("--val-every", type=int, default=500)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    args = ap.parse_args(argv)
    result = run(args.steps, args.out, args.img, args.views, args.val_every, args.device,
                 args.seed)
    final = result["trajectory"][-1]["val_psnr_db"]
    print(f"FINAL val PSNR {final:.2f} dB "
          f"({'PASS' if final >= QUALITY_BAR_DB else 'FAIL'} vs {QUALITY_BAR_DB:g} dB bar)",
          flush=True)
    return 0 if final >= QUALITY_BAR_DB else 1


if __name__ == "__main__":
    sys.exit(main())
