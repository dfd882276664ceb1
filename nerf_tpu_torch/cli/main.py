"""The port's command line: train -> benchmark pipeline, render, compare,
export and a smoke run.

Counterpart of ``nerf_tpu/cli/main.py``, with its subcommands, option names,
defaults and help, on the port's entry points; ``--device`` (default
``cuda``) on every subcommand, and without a CUDA device only ``--device
cpu`` runs (``utils/device.resolve_device`` raises; nothing falls back to
the CPU). Run it as ``python -m nerf_tpu_torch.cli`` or ``nerf-tpu-torch``:

    nerf-tpu-torch train      --data_dir D --epochs N [--no_resume]
    nerf-tpu-torch benchmark  --checkpoint C [--resolutions ...] [--samples ...]
    nerf-tpu-torch render     --weights {bmild|PATH} --width W --height H --samples S
    nerf-tpu-torch compare    --checkpoint C [--size 128]
    nerf-tpu-torch export     --checkpoint C --out M.pth
    nerf-tpu-torch smoke
    nerf-tpu-torch scale      --checkpoint C [--resolution 400x300] [--devices 1 2]
    nerf-tpu-torch pipeline   --data_dir D --epochs N     # train then benchmark

The engines keep the registry's names (``render/engines.py``): ``torch``
and ``cuda`` for the JAX package's ``xla`` and ``pallas``. The card's
machine has no matplotlib, so the loss plot and the benchmark chart are
drawn only where it is installed (``importlib.util.find_spec``), and
``compare`` writes its grid as one image with ``bench/suite.write_png``: an
RGB row over a min-max-normalized depth row, one tile per engine.

``train`` and ``scale`` take the multi-host flags (``--coordinator_address``,
``--num_processes``, ``--process_id``): with ``--num_processes`` above 1
every process joins one ``torch.distributed`` group (NCCL on the card, gloo
with ``--device cpu``; ``parallel/train.initialize_distributed``), ``train``
runs the sharded step (``parallel/``) and rank 0 writes the checkpoint, and
``scale`` splits each frame's shards over the ranks. Not here: the JAX
package's ``NERF_TPU_PLATFORM`` override and compilation cache, which are
JAX's own and have no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

# The original-NeRF lego example weights; the same variable as the JAX
# package's, so one environment serves both.
BMILD_DEFAULT = os.environ.get(
    "NERF_TPU_EXAMPLE_WEIGHTS",
    "/root/reference/data/lego_example_weights/model_fine_200000.npy",
)


def _parse_resolutions(vals: List[str]):
    out = []
    for v in vals:
        w, h = v.lower().split("x")
        out.append((int(w), int(h)))
    return out


def _has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _config_for(weights: Optional[str]):
    from nerf_tpu_torch.config import bmild_config, default_config

    return bmild_config() if (weights or "").endswith(".npy") else default_config()


def _to_uint8(image: np.ndarray) -> np.ndarray:
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def _depth_to_uint8(d: np.ndarray) -> np.ndarray:
    """The raw ``sum(w z)`` depth, min-max normalized, as 8 bits."""
    dn = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
    return (dn * 255).astype(np.uint8)


def _maybe_init_distributed(args) -> bool:
    """Join the process group of the multi-host flags before any other work
    on the device; True if this call made it (the caller then closes it).
    A no-op for one process."""
    if getattr(args, "num_processes", 0) and args.num_processes > 1:
        from nerf_tpu_torch.parallel.train import initialize_distributed

        initialize_distributed(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=args.device,
        )
        return True
    return False


def _close_distributed(owned: bool) -> None:
    if owned:
        import torch.distributed as dist

        dist.destroy_process_group()


def cmd_train(args) -> int:
    owned = _maybe_init_distributed(args)
    try:
        return _train(args)
    finally:
        _close_distributed(owned)


def _train(args) -> int:
    from nerf_tpu_torch.config import default_config
    from nerf_tpu_torch.data.blender import load_blender_data
    from nerf_tpu_torch.data.synthetic import make_procedural_dataset
    from nerf_tpu_torch.train.trainer import NeRFTrainer

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        data_dir=args.data_dir,
        checkpoint_dir=args.checkpoint_dir,
        output_dir=args.output_dir,
        train=dataclasses.replace(
            cfg.train, n_epochs=args.epochs,
            n_rays=args.n_rays or cfg.train.n_rays,
        ),
    )
    w = h = args.image_size
    if os.path.isdir(args.data_dir) and os.path.exists(
        os.path.join(args.data_dir, "transforms_train.json")
    ):
        data = load_blender_data(args.data_dir, (w, h), splits=("train", "val"))
        train_ds, val_ds = data["train"], data["val"]
    else:
        print(f"no blender dataset at {args.data_dir}; using procedural scene")
        train_ds = make_procedural_dataset(n_views=20, img_wh=(w, h), seed=0)
        val_ds = make_procedural_dataset(n_views=4, img_wh=(w, h), seed=1,
                                         split="val")

    if getattr(args, "num_processes", 0) and args.num_processes > 1:
        return _train_distributed(args, cfg, train_ds, (h, w))

    trainer = NeRFTrainer(cfg, (h, w), device=args.device)
    if args.streaming_steps:
        if not args.no_resume:
            trainer.try_resume()
        trainer.train_streaming(train_ds, n_steps=args.streaming_steps)
    else:
        trainer.train(train_ds, val_ds, n_epochs=args.epochs,
                      resume=not args.no_resume)
    path = trainer.save_checkpoint("final_model.npz")
    if _has_matplotlib():
        trainer.plot_losses()
    else:
        print("matplotlib is not installed: no loss plot")
    print(f"final checkpoint: {path}")
    return 0


def _train_distributed(args, cfg, train_ds, img_hw) -> int:
    """The multi-process train loop: every rank runs this same program on
    the mesh of ``cfg.mesh`` (default: every rank on the data axis), with
    the same replicated inputs (params from seed 0, the steps' draws from
    seed 1); rank 0 logs and writes the checkpoint, in the JAX package's
    format."""
    import torch
    import torch.distributed as dist

    from nerf_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_train_state
    from nerf_tpu_torch.parallel.train import gather_train_state
    from nerf_tpu_torch.train.checkpoint import save_checkpoint
    from nerf_tpu_torch.train.trainer import checkpoint_state, init_train_state

    h, w = img_hw
    pid, world = dist.get_rank(), dist.get_world_size()
    print(f"[proc {pid}/{world}] global devices: {world}")

    n_data = None if cfg.mesh.data_axis < 0 else cfg.mesh.data_axis
    tp = cfg.mesh.model_axis > 1
    mesh = make_mesh(n_data=n_data, n_model=cfg.mesh.model_axis, device=args.device)
    state = shard_train_state(init_train_state(torch.Generator().manual_seed(0), cfg,
                                               mesh.device), mesh, tp=tp)
    step = make_sharded_train_step(cfg, (h, w), mesh, tp=tp)

    n_views = train_ds.images.shape[0]
    n_steps = args.streaming_steps or args.epochs * n_views
    if n_steps <= 0:
        raise SystemExit("distributed training needs n_steps > 0 "
                         "(set --epochs or --streaming_steps)")
    generator = torch.Generator(device=mesh.device).manual_seed(1)   # the same on every rank
    images = torch.as_tensor(np.asarray(train_ds.images, np.float32), device=mesh.device)
    poses = torch.as_tensor(np.asarray(train_ds.poses, np.float32), device=mesh.device)
    focal = float(train_ds.focal)
    loss = float("nan")
    for i in range(n_steps):
        v = i % n_views
        metrics = step(state, images[v], poses[v], focal, generator)
        if pid == 0 and ((i + 1) % 100 == 0 or i + 1 == n_steps):
            loss = float(metrics["loss"])
            print(f"step {i + 1}/{n_steps} loss={loss:.6f}", flush=True)
    if loss != loss:
        loss = float(metrics["loss"])
    print(f"PROC {pid} FINAL LOSS {loss:.8f}", flush=True)
    whole = gather_train_state(state, mesh, tp)        # every rank takes part
    if pid == 0:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        path = os.path.join(args.checkpoint_dir, "final_model.npz")
        save_checkpoint(path, checkpoint_state(whole),
                        {"config": cfg.to_dict(), "distributed": True})
        print(f"final checkpoint: {path}")
    return 0


def cmd_benchmark(args) -> int:
    from nerf_tpu_torch.bench.suite import UnifiedBenchmarkSuite

    ckpt = args.checkpoint
    suite = UnifiedBenchmarkSuite(_config_for(ckpt), output_dir=args.output_dir,
                                  device=args.device)
    suite.add_available_renderers(args.engines)
    suite.run_benchmark(
        ckpt,
        resolutions=_parse_resolutions(args.resolutions),
        samples=[int(s) for s in args.samples],
        n_views=args.views,
    )
    if len(suite.engines) > 1 and "torch" in suite.engines:
        suite.quality_report()
    if getattr(args, "gt_gate", False) and "torch" in suite.engines:
        suite.gt_quality_report(
            resolution=(400, 300), gt_spp=args.gt_spp,
            spps=(16, 32, 64, 128), n_views=4,
        )
    chart = _has_matplotlib()
    if not chart:
        print("matplotlib is not installed: no performance chart")
    paths = suite.generate_report(chart=chart)
    for k, v in paths.items():
        print(f"{k}: {v}")
    return 0


def cmd_render(args) -> int:
    from nerf_tpu_torch.bench.suite import write_png
    from nerf_tpu_torch.render.engines import ENGINE_CLASSES, SharedModel
    from nerf_tpu_torch.utils.cameras import focal_from_angle, spherical_pose

    weights = args.weights
    if weights == "bmild":
        weights = BMILD_DEFAULT
    shared = SharedModel(_config_for(weights), args.device).load(weights)
    engine = ENGINE_CLASSES[args.engine](shared)

    pose = spherical_pose(args.theta, args.phi, args.radius)
    focal = (
        args.focal
        if args.focal is not None
        else focal_from_angle(args.width, 0.6911112070083618)
    )
    if args.trace:
        from nerf_tpu_torch.utils.monitor import profile_trace

        with profile_trace(args.trace):
            res = engine.render_image(
                pose, (args.width, args.height), args.samples,
                focal=focal, mode=args.mode,
            )
        print(f"profiler trace written to {args.trace}")
    else:
        res = engine.render_image(
            pose, (args.width, args.height), args.samples,
            focal=focal, mode=args.mode,
        )
    os.makedirs(args.out, exist_ok=True)
    rgb_path = os.path.join(args.out, "rgb.png")
    write_png(rgb_path, _to_uint8(res.rgb))
    depth_path = os.path.join(args.out, "depth.png")
    write_png(depth_path, _depth_to_uint8(res.depth))
    print(
        f"rendered {args.width}x{args.height}@{args.samples} with {args.engine} "
        f"in {res.stats.wall_time_s:.3f}s "
        f"({args.width*args.height/res.stats.wall_time_s:,.0f} rays/s)"
    )
    print(f"wrote {rgb_path}, {depth_path}")
    return 0


def _comparison_grid(frames) -> np.ndarray:
    """``[(rgb [S, S, 3], depth [S, S]), ...]`` (one per engine) as one
    ``[2S, S * n, 3]`` uint8 image: the RGB tiles in a row over their
    min-max-normalized depth tiles."""
    top = np.concatenate([_to_uint8(rgb) for rgb, _ in frames], axis=1)
    bottom = np.concatenate([np.repeat(_depth_to_uint8(d)[..., None], 3, axis=-1)
                             for _, d in frames], axis=1)
    return np.concatenate([top, bottom], axis=0)


def cmd_compare(args) -> int:
    """Side-by-side RGB/depth grid across all engines on one novel view, with
    black-image debug stats."""
    from nerf_tpu_torch.bench.suite import write_png
    from nerf_tpu_torch.render.engines import SharedModel, available_engines
    from nerf_tpu_torch.utils.cameras import focal_from_angle, spherical_pose

    ckpt = args.checkpoint
    if ckpt == "bmild":
        ckpt = BMILD_DEFAULT
    shared = SharedModel(_config_for(ckpt), args.device).load(ckpt)
    engines = available_engines(shared)
    pose = spherical_pose(40.0, -30.0, 4.0)
    focal = focal_from_angle(args.size, 0.6911112070083618)

    frames = []
    for name, engine in engines.items():
        res = engine.render_image(
            pose, (args.size, args.size), args.samples, focal=focal
        )
        mean = float(res.rgb.mean())
        status = "BLACK IMAGE?" if mean < 0.01 else f"mean={mean:.3f}"
        print(f"{name}: {res.stats.wall_time_s:.3f}s {status}")
        frames.append((res.rgb, res.depth))
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "renderer_comparison.png")
    write_png(path, _comparison_grid(frames))
    print(f"grid: rgb over min-max-normalized depth, one column per engine: "
          f"{' '.join(engines)}")
    print(f"wrote {path}")
    return 0


def cmd_export(args) -> int:
    """Convert a trainer checkpoint (``.npz``, either package's) to the
    reference's torch ``.pth`` format (coarse and fine state_dicts, the
    config and the loss history), the payload the JAX package's ``export``
    writes."""
    import torch

    from nerf_tpu_torch.models.nerf import params_from_numpy, params_to_torch_state_dict
    from nerf_tpu_torch.train.checkpoint import restore_checkpoint

    state, meta = restore_checkpoint(args.checkpoint)
    params = params_from_numpy(state["params"], args.device)

    def state_dict(net):
        return {k: torch.from_numpy(v.copy())
                for k, v in params_to_torch_state_dict(params[net]).items()}

    payload = {
        "coarse_model": state_dict("coarse"),
        "fine_model": state_dict("fine"),
        "config": meta.get("config", {}),
        "train_losses": meta.get("train_losses", []),
        "val_losses": meta.get("val_losses", []),
    }
    torch.save(payload, args.out)
    print(f"exported {args.checkpoint} -> {args.out} "
          f"(reference-compatible state_dict format)")
    return 0


def cmd_smoke(args) -> int:
    """Fast end-to-end sanity check: tiny procedural train -> checkpoint ->
    resume -> render -> mini benchmark."""
    from nerf_tpu_torch.bench.suite import UnifiedBenchmarkSuite
    from nerf_tpu_torch.config import Config, ModelConfig, RenderConfig, TrainConfig
    from nerf_tpu_torch.data.synthetic import make_procedural_dataset
    from nerf_tpu_torch.train.trainer import NeRFTrainer

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(
            model=ModelConfig(pos_freqs=4, dir_freqs=2, hidden_dim=32,
                              n_layers=4, skip_layer=2, color_hidden_dim=16),
            render=RenderConfig(n_coarse=8, n_fine=12),
            train=TrainConfig(n_rays=128, compute_dtype="float32",
                              learning_rate=5e-3, checkpoint_frequency=1),
            checkpoint_dir=f"{tmp}/ckpt",
            output_dir=f"{tmp}/out",
        )
        ds = make_procedural_dataset(n_views=4, img_wh=(32, 32))
        trainer = NeRFTrainer(cfg, (32, 32), device=args.device)
        trainer.train(ds, n_epochs=2, log_fn=lambda m: print(f"  {m}"))
        if len(trainer.train_losses) != 2:
            raise RuntimeError(f"smoke: {len(trainer.train_losses)} epochs trained, expected 2")
        print("  train OK")

        trainer2 = NeRFTrainer(cfg, (32, 32), device=args.device)
        if trainer2.try_resume() is None:
            raise RuntimeError("smoke: no checkpoint to resume from")
        print("  resume OK")

        rgb, _ = trainer.render_image(
            trainer.state.params, ds[0]["pose"], (32, 32), float(ds.focal)
        )
        if not bool(rgb.isfinite().all()):
            raise RuntimeError("smoke: a non-finite rendered pixel")
        print("  render OK")

        suite = UnifiedBenchmarkSuite(cfg, output_dir=f"{tmp}/out", device=args.device)
        suite.add_available_renderers(names=["torch"])
        results = suite.run_benchmark(
            None, resolutions=[(32, 24)], samples=[8], n_views=1,
            save_sample_renders=False,
        )
        if not (results and results[0].success):
            raise RuntimeError(f"smoke: the benchmark row failed: {results}")
        print("  benchmark OK")
    print(f"smoke test passed in {time.time() - t0:.1f}s")
    return 0


def cmd_scale(args) -> int:
    """Scaling report: rays/s and parallel efficiency over 1..N devices."""
    owned = _maybe_init_distributed(args)
    try:
        return _scale(args)
    finally:
        _close_distributed(owned)


def _scale(args) -> int:
    import json

    import torch.distributed as dist

    from nerf_tpu_torch.bench.scaling import scaling_report
    from nerf_tpu_torch.render.engines import SharedModel

    ckpt = args.checkpoint
    if ckpt == "bmild":
        ckpt = BMILD_DEFAULT
    cfg = _config_for(ckpt)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    shared = SharedModel(cfg, args.device).load(ckpt)
    w, h = _parse_resolutions([args.resolution])[0]
    print(f"devices available: {world}")
    os.makedirs(args.output_dir, exist_ok=True)
    rows = scaling_report(
        shared.params["fine"], cfg, resolution=(w, h), spp=args.samples,
        focal=args.focal,
        device_counts=[int(d) for d in args.devices] if args.devices else None,
        frame_path=os.path.join(args.output_dir, "scaling_frame.png"),
        device=args.device,
    )
    if rank == 0:
        out = os.path.join(args.output_dir, "scaling_report.json")
        with open(out, "w") as f:
            json.dump([r.__dict__ for r in rows], f, indent=2)
        print(f"wrote {out}")
    return 0


def cmd_pipeline(args) -> int:
    """Train (unless skipped), then benchmark the checkpoint."""
    if not args.benchmark_only and not args.skip_training:
        rc = cmd_train(args)
        if rc:
            return rc
    if args.checkpoint is None:
        args.checkpoint = os.path.join(args.checkpoint_dir, "final_model.npz")
    return cmd_benchmark(args)


def build_parser() -> argparse.ArgumentParser:
    from nerf_tpu_torch.render.engines import ENGINE_CLASSES

    p = argparse.ArgumentParser(prog="nerf-tpu-torch",
                                description="NeRF framework on PyTorch and CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on; without a CUDA device only "
                             "'cpu' runs (no fallback)")

    def common(sp):
        sp.add_argument("--output_dir", default="outputs")
        sp.add_argument("--checkpoint_dir", default="checkpoints")

    def distributed(sp):
        """The multi-host flags (one torch.distributed process group);
        single-process when omitted."""
        sp.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 (all hosts pass the "
                             "same value)")
        sp.add_argument("--num_processes", type=int, default=0,
                        help="total hosts in the pod slice (0 = "
                             "single-process)")
        sp.add_argument("--process_id", type=int, default=None,
                        help="this host's index in [0, num_processes)")

    t = sub.add_parser("train", help="train a NeRF")
    common(t)
    t.add_argument("--data_dir", default="data/nerf_synthetic/lego")
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--image_size", type=int, default=400)
    t.add_argument("--no_resume", action="store_true")
    t.add_argument("--streaming_steps", type=int, default=0,
                   help="train N steps from the native host ray producer "
                        "instead of the per-image epoch loop")
    t.add_argument("--n_rays", type=int, default=0,
                   help="rays per train step (0 = config default, 2048)")
    distributed(t)
    device(t)
    t.set_defaults(fn=cmd_train)

    b = sub.add_parser("benchmark", help="run the unified benchmark")
    common(b)
    b.add_argument("--checkpoint", default=None)
    b.add_argument("--resolutions", nargs="+",
                   default=["200x150", "400x300", "800x600"])
    b.add_argument("--samples", nargs="+", default=["32", "64", "128"])
    b.add_argument("--views", type=int, default=2)
    b.add_argument("--engines", nargs="+", default=None)
    b.add_argument("--gt_gate", action="store_true",
                   help="also run the ground-truth-anchored quality gate "
                        "(engines at several spp vs a high-spp truth)")
    b.add_argument("--gt_spp", type=int, default=256)
    device(b)
    b.set_defaults(fn=cmd_benchmark)

    r = sub.add_parser("render", help="render one view")
    r.add_argument("--weights", default="bmild",
                   help="'bmild', a .npy, or a .npz checkpoint")
    r.add_argument("--engine", default="cuda", choices=list(ENGINE_CLASSES))
    r.add_argument("--width", type=int, default=400)
    r.add_argument("--height", type=int, default=400)
    r.add_argument("--samples", type=int, default=64)
    r.add_argument("--mode", default="benchmark",
                   choices=["benchmark", "hierarchical"])
    r.add_argument("--theta", type=float, default=30.0)
    r.add_argument("--phi", type=float, default=-30.0)
    r.add_argument("--radius", type=float, default=4.0)
    r.add_argument("--focal", type=float, default=None)
    r.add_argument("--trace", default=None,
                   help="write a torch.profiler trace to this directory")
    r.add_argument("--out", default="outputs/render")
    device(r)
    r.set_defaults(fn=cmd_render)

    c = sub.add_parser("compare", help="side-by-side engine comparison")
    c.add_argument("--checkpoint", default="bmild")
    c.add_argument("--size", type=int, default=128)
    c.add_argument("--samples", type=int, default=32)
    c.add_argument("--output_dir", default="outputs")
    device(c)
    c.set_defaults(fn=cmd_compare)

    sm = sub.add_parser("smoke", help="fast end-to-end sanity check")
    device(sm)
    sm.set_defaults(fn=cmd_smoke)

    ex = sub.add_parser("export", help="convert .npz checkpoint to torch .pth")
    ex.add_argument("--checkpoint", required=True)
    ex.add_argument("--out", required=True)
    device(ex)
    ex.set_defaults(fn=cmd_export)

    s = sub.add_parser("scale", help="multi-device scaling report")
    s.add_argument("--checkpoint", default="bmild")
    s.add_argument("--resolution", default="400x300")
    s.add_argument("--samples", type=int, default=64)
    s.add_argument("--focal", type=float, default=800.0)
    s.add_argument("--devices", nargs="+", default=None)
    s.add_argument("--output_dir", default="outputs")
    distributed(s)
    device(s)
    s.set_defaults(fn=cmd_scale)

    pl = sub.add_parser("pipeline", help="train then benchmark (reference main.py)")
    common(pl)
    pl.add_argument("--data_dir", default="data/nerf_synthetic/lego")
    pl.add_argument("--epochs", type=int, default=100)
    pl.add_argument("--image_size", type=int, default=400)
    pl.add_argument("--streaming_steps", type=int, default=0,
                    help="train N steps from the native host ray producer "
                         "instead of the per-image epoch loop")
    pl.add_argument("--n_rays", type=int, default=0,
                    help="rays per train step (0 = config default, 2048)")
    pl.add_argument("--no_resume", action="store_true")
    pl.add_argument("--skip_training", action="store_true")
    pl.add_argument("--benchmark_only", action="store_true")
    pl.add_argument("--checkpoint", default=None)
    pl.add_argument("--resolutions", nargs="+",
                    default=["200x150", "400x300", "800x600"])
    pl.add_argument("--samples", nargs="+", default=["32", "64", "128"])
    pl.add_argument("--views", type=int, default=2)
    pl.add_argument("--engines", nargs="+", default=None,
                    help="restrict the benchmark stage (default: all)")
    pl.add_argument("--gt_gate", action="store_true")
    pl.add_argument("--gt_spp", type=int, default=256)
    device(pl)
    pl.set_defaults(fn=cmd_pipeline)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    from nerf_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)        # raises before any work without the asked device
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
