"""Unified benchmark suite: the same weights through every engine x
resolution x samples x view; CSV, JSON, a per-engine summary, a chart and
view-0 RGB and depth renders; a cross-engine quality gate and a gate
against converged truth.

Counterpart of ``nerf_tpu/bench/suite.py`` (``UnifiedBenchmarkSuite``) on
the port's engines, with an explicit ``device``: the probed registry, orbit
poses at ``BENCHMARK_FOCAL``, one row per view with per-view fault
isolation, rays/s = W * H / wall time, and the same report keys. It needs
neither pandas nor Pillow, and the card's machine has no matplotlib: ``summarize``
computes pandas' ``groupby`` aggregates of the JAX report (the standard
deviation with ddof = 1), ``write_png`` writes 8-bit PNGs with ``zlib`` and
``struct``, and the chart, which only matplotlib draws, is drawn when
``generate_report(chart=True)`` asks for it and fails loudly where
matplotlib is absent.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nerf_tpu_torch.config import Config, default_config
from nerf_tpu_torch.render.engines import Engine, SharedModel, available_engines
from nerf_tpu_torch.utils.cameras import BENCHMARK_FOCAL, gate_poses, orbit_poses
from nerf_tpu_torch.utils.metrics import psnr, ssim

DEGENERATE_STD = 0.05   # a reference frame with a smaller rgb std faces empty space


@dataclass
class BenchmarkResult:
    """One (engine, resolution, samples, view) measurement."""

    renderer_name: str
    device_info: str
    resolution: Tuple[int, int]
    samples_per_ray: int
    view_idx: int
    render_time_s: float
    rays_per_second: float
    peak_host_rss_mb: float
    peak_device_mb: Optional[float]
    success: bool
    error: str = ""


SUMMARY_COLUMNS = ("rays_per_second_mean", "rays_per_second_std", "rays_per_second_min",
                   "rays_per_second_max", "render_time_mean_s", "render_time_max_s",
                   "peak_host_rss_mb", "peak_device_mb", "configs")


def _finite(values) -> List[float]:
    return [float(v) for v in values if v is not None and not math.isnan(v)]


def summarize(results: Sequence[BenchmarkResult]) -> Dict[str, Dict[str, float]]:
    """Per engine (sorted by name), over its successful rows: mean, sample
    standard deviation (ddof = 1; NaN for one row), min and max of rays/s;
    mean and max render time; max host RSS; max device MB (NaN where none
    was read); the count of rows. The aggregates of the JAX suite's pandas
    ``groupby``, which skip missing values as these do."""
    rows: Dict[str, List[BenchmarkResult]] = {}
    for r in results:
        if r.success:
            rows.setdefault(r.renderer_name, []).append(r)
    out = {}
    for name in sorted(rows):
        rps = _finite(r.rays_per_second for r in rows[name])
        times = _finite(r.render_time_s for r in rows[name])
        device = _finite(r.peak_device_mb for r in rows[name])
        out[name] = {
            "rays_per_second_mean": float(np.mean(rps)),
            "rays_per_second_std": float(np.std(rps, ddof=1)) if len(rps) > 1 else math.nan,
            "rays_per_second_min": min(rps),
            "rays_per_second_max": max(rps),
            "render_time_mean_s": float(np.mean(times)),
            "render_time_max_s": max(times),
            "peak_host_rss_mb": max(_finite(r.peak_host_rss_mb for r in rows[name])),
            "peak_device_mb": max(device) if device else math.nan,
            "configs": len(rps),
        }
    return out


def format_summary(summary: Dict[str, Dict[str, float]]) -> str:
    """The summary as a table, every float as ``f"{v:,.1f}"`` (the JAX
    suite's print)."""
    def cell(v):
        return str(v) if isinstance(v, int) else f"{v:,.1f}"

    table = [("renderer_name", *SUMMARY_COLUMNS)] + [
        (name, *(cell(s[c]) for c in SUMMARY_COLUMNS)) for name, s in summary.items()]
    widths = [max(len(row[i]) for row in table) for i in range(len(table[0]))]
    return "\n".join("  ".join(v.ljust(w) if i == 0 else v.rjust(w)
                               for i, (v, w) in enumerate(zip(row, widths)))
                     for row in table)


def _csv_value(v) -> str:
    """A value as pandas' ``to_csv`` writes it: missing as empty."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit greyscale ``[H, W]`` or RGB ``[H, W, 3]`` uint8 image as a
    PNG: no row filter, one zlib stream."""
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                           and image.shape[2] == 3)):
        raise ValueError(f"need uint8 [H, W] or [H, W, 3], got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if image.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


class UnifiedBenchmarkSuite:
    def __init__(self, cfg: Optional[Config] = None, output_dir: str = "outputs",
                 device="cuda"):
        self.cfg = cfg if cfg is not None else default_config()
        self.output_dir = output_dir
        self.device = device
        self.engines: Dict[str, Engine] = {}
        self.results: List[BenchmarkResult] = []
        self.shared: Optional[SharedModel] = None
        self._quality: Dict = {}
        self._gt_quality: Dict = {}

    def add_available_renderers(self, names: Optional[Sequence[str]] = None) -> None:
        self.shared = SharedModel(self.cfg, self.device)
        self.engines = available_engines(self.shared, names)
        for name, e in self.engines.items():
            print(f"engine registered: {name} — {e.description}")

    def run_benchmark(
        self,
        checkpoint_path: Optional[str],
        resolutions: Sequence[Tuple[int, int]] = ((200, 150), (400, 300), (800, 600)),
        samples: Sequence[int] = (32, 64, 128),
        n_views: int = 2,
        save_sample_renders: bool = True,
    ) -> List[BenchmarkResult]:
        """Every engine at every resolution and sample count, one row per
        view of ``orbit_poses(n_views)``; a view that raises is recorded as
        a failed row and the sweep goes on."""
        if not self.engines:
            self.add_available_renderers()
        self.shared.load(checkpoint_path)
        poses = orbit_poses(n_views)

        for name, engine in self.engines.items():
            for resolution in resolutions:
                for spp in samples:
                    w, h = resolution
                    times = []
                    for v in range(n_views):
                        try:
                            res = engine.render_image(poses[v], resolution, spp,
                                                      focal=BENCHMARK_FOCAL)
                        except Exception as e:  # per-view fault isolation
                            error = f"{type(e).__name__}: {e}"
                            print(f"  {name} {resolution}@{spp} view{v} failed: {error}")
                            self.results.append(BenchmarkResult(
                                renderer_name=name, device_info=engine.device_info(),
                                resolution=resolution, samples_per_ray=spp, view_idx=v,
                                render_time_s=float("nan"), rays_per_second=0.0,
                                peak_host_rss_mb=0.0, peak_device_mb=None, success=False,
                                error=error))
                            continue
                        t = res.stats.wall_time_s
                        times.append(t)
                        self.results.append(BenchmarkResult(
                            renderer_name=name, device_info=engine.device_info(),
                            resolution=resolution, samples_per_ray=spp, view_idx=v,
                            render_time_s=t, rays_per_second=w * h / t,
                            peak_host_rss_mb=res.stats.peak_host_rss_mb,
                            peak_device_mb=res.stats.peak_device_mb, success=True))
                        if save_sample_renders and v == 0:
                            self._save_sample_render(name, resolution, spp, res)
                    if times:
                        avg_t = float(np.mean(times))
                        print(f"  {name} {w}x{h}@{spp}: {avg_t:.3f}s "
                              f"{w * h / avg_t:,.0f} rays/s ({len(times)}/{n_views} views)")
        return self.results

    def _save_sample_render(self, engine_name, resolution, spp, res) -> None:
        """View 0's RGB and its min-max-normalized depth (``res.depth``, the
        unnormalized ``sum(w z)``) as PNGs."""
        d = os.path.join(self.output_dir, "sample_renders", engine_name)
        os.makedirs(d, exist_ok=True)
        w, h = resolution
        tag = f"{w}x{h}_s{spp}"
        write_png(os.path.join(d, f"view0_{tag}_rgb.png"),
                  (np.clip(res.rgb, 0, 1) * 255).astype(np.uint8))
        depth = res.depth
        dmin, dmax = float(depth.min()), float(depth.max())
        dn = (depth - dmin) / max(dmax - dmin, 1e-9)
        write_png(os.path.join(d, f"view0_{tag}_depth.png"), (dn * 255).astype(np.uint8))

    def quality_report(
        self,
        resolutions: Sequence[Tuple[int, int]] = ((200, 150), (400, 300)),
        spp: int = 64,
        focal: float = BENCHMARK_FOCAL,
        reference_engine: str = "torch",
        n_views: int = 4,
    ) -> Dict[str, Dict[str, float]]:
        """PSNR and SSIM of every engine's render against the reference
        engine's, over ``n_views`` look-at-origin ``gate_poses`` at every
        resolution. Per engine: mean and worst over the informative cells
        (a cell whose reference has an rgb std under 0.05 faces empty space
        and is flagged degenerate; all cells where every one is), the
        unfiltered means beside them, and the per-cell values. A missing
        reference engine is recorded as an ``error`` entry; an engine that
        raises, as its own ``error``."""
        report: Dict[str, Dict[str, float]] = {}
        if reference_engine not in self.engines:
            report["error"] = {"missing_reference_engine": reference_engine}
            print(f"  quality gate skipped: engine {reference_engine!r} unavailable")
            self._quality = report
            return report
        poses = gate_poses(n_views)
        cells = [(v, res) for res in resolutions for v in range(n_views)]
        refs = {(v, res): self.engines[reference_engine].render_image(
                    poses[v], res, spp, focal=focal, monitor=False)
                for v, res in cells}
        degenerate = {k: bool(np.asarray(r.rgb).std() < DEGENERATE_STD)
                      for k, r in refs.items()}
        for name, engine in self.engines.items():
            if name == reference_engine:
                continue
            psnrs, ssims, per_cell = [], [], {}
            try:
                for v, res in cells:
                    out = engine.render_image(poses[v], res, spp, focal=focal, monitor=False)
                    p = float(psnr(out.rgb, refs[(v, res)].rgb))
                    s = float(ssim(out.rgb, refs[(v, res)].rgb))
                    if not degenerate[(v, res)]:
                        psnrs.append(p)
                        ssims.append(s)
                    per_cell[f"view{v}_{res[0]}x{res[1]}"] = {
                        "psnr_db": p, "ssim": s, "degenerate": degenerate[(v, res)]}
                all_psnrs = [c["psnr_db"] for c in per_cell.values()]
                all_ssims = [c["ssim"] for c in per_cell.values()]
                if not psnrs:
                    psnrs, ssims = all_psnrs, all_ssims
                report[name] = {
                    "psnr_db": float(np.mean(psnrs)),
                    "psnr_db_min": float(np.min(psnrs)),
                    "ssim": float(np.mean(ssims)),
                    "ssim_min": float(np.min(ssims)),
                    "psnr_db_all_cells": float(np.mean(all_psnrs)),
                    "ssim_all_cells": float(np.mean(all_ssims)),
                    "cells_aggregated": len(psnrs),
                    "cells": per_cell,
                }
                print(f"  quality {name} vs {reference_engine}: "
                      f"{report[name]['psnr_db']:.1f} dB PSNR "
                      f"(min {report[name]['psnr_db_min']:.1f}), "
                      f"SSIM {report[name]['ssim']:.4f} "
                      f"(min {report[name]['ssim_min']:.4f}) "
                      f"over {len(psnrs)}/{len(cells)} informative cells")
            except Exception as e:
                report[name] = {"error": f"{type(e).__name__}: {e}"}
                print(f"  quality {name} failed: {e}")
        self._quality = report
        return report

    def gt_quality_report(
        self,
        resolution: Tuple[int, int] = (400, 300),
        gt_spp: int = 256,
        spps: Sequence[int] = (16, 32, 64, 128),
        focal: float = BENCHMARK_FOCAL,
        gt_engine: str = "torch",
        n_views: int = 4,
        engines: Optional[Sequence[str]] = None,
    ) -> Dict[str, Dict[str, Dict[str, float]]]:
        """``gt_engine`` at ``gt_spp`` samples a ray is the converged truth;
        every engine (or those named) at each count in ``spps`` is scored
        against it: PSNR and SSIM over the informative views (truth rgb std
        >= 0.05; all views where none is), per-view values, and rays/s over
        the views' timed frames. It shows whether an engine that places its
        samples elsewhere (the accel engine) reaches a fidelity with fewer
        samples."""
        poses = gate_poses(n_views)
        gts = [self.engines[gt_engine].render_image(poses[v], resolution, gt_spp, focal=focal,
                                                    monitor=False).rgb
               for v in range(n_views)]
        informative = [v for v in range(n_views)
                       if float(np.asarray(gts[v]).std()) >= DEGENERATE_STD]
        agg_views = informative or list(range(n_views))
        report: Dict[str, Dict[str, Dict[str, float]]] = {
            "_meta": {
                "gt_engine": gt_engine, "gt_spp": gt_spp,
                "resolution": list(resolution), "n_views": n_views,
                "views_aggregated": agg_views,
                "views_excluded_degenerate": [v for v in range(n_views) if v not in agg_views],
            }
        }
        names = engines if engines is not None else list(self.engines)
        w, h = resolution
        for name in names:
            engine = self.engines.get(name)
            if engine is None:
                continue
            report[name] = {}
            for spp in spps:
                try:
                    psnrs, ssims, times = [], [], []
                    for v in range(n_views):
                        out = engine.render_image(poses[v], resolution, spp, focal=focal)
                        psnrs.append(float(psnr(out.rgb, gts[v])))
                        ssims.append(float(ssim(out.rgb, gts[v])))
                        times.append(out.stats.wall_time_s)
                    cell = {
                        "psnr_db_vs_gt": float(np.mean([psnrs[v] for v in agg_views])),
                        "ssim_vs_gt": float(np.mean([ssims[v] for v in agg_views])),
                        "rays_per_second": float(w * h / np.mean(times)),
                        "psnr_db_per_view": [round(p, 2) for p in psnrs],
                        "ssim_per_view": [round(s, 4) for s in ssims],
                    }
                    report[name][str(spp)] = cell
                    print(f"  gt-gate {name}@{spp}: "
                          f"{cell['psnr_db_vs_gt']:.2f} dB vs GT, "
                          f"SSIM {cell['ssim_vs_gt']:.4f}, "
                          f"{cell['rays_per_second']:,.0f} rays/s")
                except Exception as e:
                    report[name][str(spp)] = {"error": f"{type(e).__name__}: {e}"}
                    print(f"  gt-gate {name}@{spp} failed: {e}")
        self._gt_quality = report
        return report

    # -- reporting ----------------------------------------------------------

    def generate_report(self, chart: bool = True) -> Dict[str, str]:
        """``benchmark_results.csv`` (one row per result), ``.json``
        (results, quality, gt_quality), and where a row succeeded the printed
        per-engine summary, ``benchmark_summary.csv`` and, with ``chart``,
        ``performance_comparison.png``. Returns the written paths by kind
        (no ``"chart"`` without ``chart``)."""
        if chart:
            import matplotlib  # the chart's only means: raises where it is absent

            matplotlib.use("Agg")
        os.makedirs(self.output_dir, exist_ok=True)
        paths = {}

        fields = [f.name for f in dataclasses.fields(BenchmarkResult)]
        csv_path = os.path.join(self.output_dir, "benchmark_results.csv")
        with open(csv_path, "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(fields)
            for r in self.results:
                row = dataclasses.asdict(r)
                row["resolution"] = f"{r.resolution[0]}x{r.resolution[1]}"
                out.writerow([_csv_value(row[k]) for k in fields])
        paths["csv"] = csv_path

        json_path = os.path.join(self.output_dir, "benchmark_results.json")
        with open(json_path, "w") as f:
            json.dump({"results": [dataclasses.asdict(r) for r in self.results],
                       "quality": self._quality, "gt_quality": self._gt_quality},
                      f, indent=2, default=str)
        paths["json"] = json_path

        summary = summarize(self.results)
        if summary:
            print("\n== summary (per engine) ==")
            print(format_summary(summary))
            summary_path = os.path.join(self.output_dir, "benchmark_summary.csv")
            with open(summary_path, "w", newline="") as f:
                out = csv.writer(f)
                out.writerow(("renderer_name", *SUMMARY_COLUMNS))
                for name, s in summary.items():
                    out.writerow([name, *(_csv_value(s[c]) for c in SUMMARY_COLUMNS)])
            paths["summary"] = summary_path
            if chart:
                paths["chart"] = self._plot([r for r in self.results if r.success])
        return paths

    def _plot(self, rows: List[BenchmarkResult]) -> str:
        """The JAX suite's four panels: render time against samples, rays/s
        against resolution, peak memory (host RSS and device) and rays/s
        against render time, one series per engine."""
        import matplotlib.pyplot as plt

        def mean_by(sub, key, value):
            groups: Dict = {}
            for r in sub:
                groups.setdefault(key(r), []).append(value(r))
            ks = sorted(groups)
            return ks, [float(np.mean(groups[k])) for k in ks]

        fig, axes = plt.subplots(2, 2, figsize=(13, 9))
        engines = sorted({r.renderer_name for r in rows})
        by_engine = {e: [r for r in rows if r.renderer_name == e] for e in engines}

        ax = axes[0][0]
        for e in engines:
            x, y = mean_by(by_engine[e], lambda r: r.samples_per_ray, lambda r: r.render_time_s)
            ax.plot(x, y, "o-", label=e)
        ax.set_xlabel("samples/ray"); ax.set_ylabel("render time (s)")
        ax.set_yscale("log"); ax.set_title("Render time vs samples"); ax.legend()

        ax = axes[0][1]
        for e in engines:
            x, y = mean_by(by_engine[e], lambda r: tuple(r.resolution),
                           lambda r: r.rays_per_second)
            ax.plot([f"{w}x{h}" for w, h in x], y, "o-", label=e)
        ax.set_xlabel("resolution"); ax.set_ylabel("rays/s")
        ax.set_title("Throughput vs resolution"); ax.legend()

        ax = axes[1][0]
        summary = summarize(rows)
        x = np.arange(len(engines))
        ax.bar(x - 0.2, [summary[e]["peak_host_rss_mb"] for e in engines], width=0.4,
               label="host RSS")
        ax.bar(x + 0.2, [np.nan_to_num(summary[e]["peak_device_mb"]) for e in engines],
               width=0.4, label="device (max_memory_allocated)")
        ax.set_xticks(x); ax.set_xticklabels(engines)
        ax.set_ylabel("MB"); ax.set_title("Memory"); ax.legend()

        ax = axes[1][1]
        for e in engines:
            ax.scatter([r.render_time_s for r in by_engine[e]],
                       [r.rays_per_second for r in by_engine[e]], label=e)
        ax.set_xlabel("render time (s)"); ax.set_ylabel("rays/s")
        ax.set_xscale("log"); ax.set_title("Efficiency"); ax.legend()

        fig.tight_layout()
        path = os.path.join(self.output_dir, "performance_comparison.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
