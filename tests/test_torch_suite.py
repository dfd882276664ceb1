"""The port's benchmark suite (``nerf_tpu_torch/bench/suite.py``) on the
CPU: the sweep end to end, fault isolation, the report files against the
JAX suite's (pandas) on the same rows, the PNG writer through Pillow, and
both quality gates of both packages on the same trained weights."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import jax
import pandas as pd
import pytest
from PIL import Image

from nerf_tpu.bench import suite as jsuite
from nerf_tpu.config import default_config as jdefault
from nerf_tpu.render import engines as jengines
from nerf_tpu_torch.bench import suite
from nerf_tpu_torch.bench.suite import BenchmarkResult, UnifiedBenchmarkSuite, summarize, write_png
from nerf_tpu_torch.config import default_config
from nerf_tpu_torch.render import engines
from nerf_tpu_torch.utils.cameras import BENCHMARK_FOCAL, orbit_poses

PARAMS = Path(__file__).resolve().parents[1] / "results/convergence/final_params.npz"
W, H = 40, 30
PSNR_TOL = 0.5      # dB, a cell of one package's report against the other's
SSIM_TOL = 1e-3
ACCEL = dict(grid_resolution=32, probe_resolution=16)   # a small grid: the CPU bakes it


def _white(cfg):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                               white_background=True))


@pytest.fixture(scope="module")
def trained():
    if not PARAMS.exists():
        pytest.skip(f"{PARAMS} not present")
    return str(PARAMS)


def _suite(tmp_path, names, chunk=512):
    s = UnifiedBenchmarkSuite(_white(default_config()), str(tmp_path), device="cpu")
    s.add_available_renderers(names=names)
    for e in s.engines.values():
        e.chunk_rays = chunk
    return s


def test_suite_end_to_end_on_the_cpu(tmp_path, trained):
    # a mini sweep: one row per view, the CSV, the JSON, the summary, the
    # chart and view 0's PNGs, which decode to the frame exactly
    s = _suite(tmp_path, ["torch", "cuda"])
    results = s.run_benchmark(trained, resolutions=[(W, H)], samples=[8], n_views=2)
    assert [(r.renderer_name, r.view_idx) for r in results] == [
        ("torch", 0), ("torch", 1), ("cuda", 0), ("cuda", 1)]
    for r in results:
        assert r.success and r.error == "" and r.device_info == "CPU - cpu"
        assert r.resolution == (W, H) and r.samples_per_ray == 8
        assert r.rays_per_second == pytest.approx(W * H / r.render_time_s)
        assert r.peak_device_mb is None and r.peak_host_rss_mb > 0
    paths = s.generate_report()
    assert set(paths) == {"csv", "json", "summary", "chart"}
    assert all(Path(p).exists() for p in paths.values())
    assert Image.open(paths["chart"]).size == (1560, 1080)       # 13 x 9 in at 120 dpi
    csv = pd.read_csv(paths["csv"])
    assert list(csv.columns) == [f.name for f in dataclasses.fields(BenchmarkResult)]
    assert len(csv) == 4 and (csv["resolution"] == f"{W}x{H}").all() and csv["success"].all()
    with open(paths["json"]) as f:
        report = json.load(f)
    assert set(report) == {"results", "quality", "gt_quality"} and len(report["results"]) == 4
    pose = orbit_poses(2)[0]
    for name in ("torch", "cuda"):
        frame = s.engines[name].render_image(pose, (W, H), 8, focal=BENCHMARK_FOCAL,
                                             monitor=False)
        d = tmp_path / "sample_renders" / name
        rgb = np.asarray(Image.open(d / f"view0_{W}x{H}_s8_rgb.png"))
        np.testing.assert_array_equal(rgb, (np.clip(frame.rgb, 0, 1) * 255).astype(np.uint8))
        depth = np.asarray(Image.open(d / f"view0_{W}x{H}_s8_depth.png"))
        lo, hi = frame.depth.min(), frame.depth.max()
        want = ((frame.depth - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
        assert depth.shape == (H, W) and depth.dtype == np.uint8
        np.testing.assert_array_equal(depth, want)
        assert rgb.std() > 0.05 * 255      # view 0 faces the sphere
    assert sorted(p.name for p in (tmp_path / "sample_renders").iterdir()) == ["cuda", "torch"]


def test_the_chart_is_asked_for_and_fails_loudly_without_matplotlib(tmp_path, monkeypatch):
    s = UnifiedBenchmarkSuite(_white(default_config()), str(tmp_path), device="cpu")
    s.results = [BenchmarkResult("cuda", "CPU - cpu", (4, 3), 8, 0, 0.5, 24.0, 10.0, None, True)]
    paths = s.generate_report(chart=False)
    assert set(paths) == {"csv", "json", "summary"}
    assert not (tmp_path / "performance_comparison.png").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)     # as on the card
    with pytest.raises(ImportError):
        s.generate_report(chart=True)


def test_benchmark_fault_isolation(tmp_path):
    # a view that raises is a failed row with its error; the sweep goes on
    s = _suite(tmp_path, ["torch", "cuda"])
    calls = []

    def explode(*a, **k):
        calls.append(a[1])
        raise ZeroDivisionError("synthetic failure")

    s.engines["torch"].render_image = explode
    results = s.run_benchmark(None, resolutions=[(8, 6)], samples=[4], n_views=2)
    assert len(results) == 4 and len(calls) == 2
    bad, good = results[:2], results[2:]
    for r in bad:
        assert not r.success and r.error == "ZeroDivisionError: synthetic failure"
        assert math.isnan(r.render_time_s) and r.rays_per_second == 0.0
        assert r.peak_device_mb is None and r.device_info == "CPU - cpu"
    assert all(r.success for r in good)
    assert list(summarize(results)) == ["cuda"]
    paths = s.generate_report(chart=False)
    csv = pd.read_csv(paths["csv"])
    assert list(csv["success"]) == [False, False, True, True]
    assert csv["render_time_s"].isna().sum() == 2


def _rows(seed):
    """Rows as a sweep makes them: engines of several rows, one of a single
    row (its std is NaN), one without a device reading, failed rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for name, n, device in (("torch", 5, True), ("cuda", 7, True), ("accel", 1, True),
                            ("int8", 4, False)):
        for i in range(n):
            t = float(rng.uniform(0.01, 2.0))
            res = [(200, 150), (800, 600)][i % 2]
            rows.append(BenchmarkResult(
                name, "CUDA - NVIDIA H100 80GB HBM3", res, [32, 64][i % 2], i % 2, t,
                res[0] * res[1] / t, float(rng.uniform(500, 900)),
                float(rng.uniform(100, 300)) if device else None, True))
    rows.append(BenchmarkResult("cuda", "x", (8, 6), 4, 0, float("nan"), 0.0, 0.0, None, False,
                                "RuntimeError: boom"))
    rows.append(BenchmarkResult("compressed", "x", (8, 6), 4, 1, float("nan"), 0.0, 0.0, None,
                                False, "RuntimeError: boom"))
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_summary_and_csvs_match_the_jax_suites_pandas(tmp_path, seed):
    # the same rows through both suites' generate_report: the stdlib
    # summary equals pandas' groupby (1e-9), and each CSV reads back as the
    # JAX suite's does
    rows = _rows(seed)
    ours = UnifiedBenchmarkSuite(_white(default_config()), str(tmp_path / "port"), device="cpu")
    ours.results = rows
    theirs = jsuite.UnifiedBenchmarkSuite(_white(jdefault()), str(tmp_path / "jax"))
    theirs.results = [jsuite.BenchmarkResult(**dataclasses.asdict(r)) for r in rows]
    paths, jpaths = ours.generate_report(), theirs.generate_report()
    assert set(paths) == set(jpaths)

    summary = summarize(rows)
    df = theirs.to_dataframe()
    want = df[df["success"]].groupby("renderer_name").agg(
        rays_per_second_mean=("rays_per_second", "mean"),
        rays_per_second_std=("rays_per_second", "std"),
        rays_per_second_min=("rays_per_second", "min"),
        rays_per_second_max=("rays_per_second", "max"),
        render_time_mean_s=("render_time_s", "mean"),
        render_time_max_s=("render_time_s", "max"),
        peak_host_rss_mb=("peak_host_rss_mb", "max"),
        peak_device_mb=("peak_device_mb", "max"),
        configs=("rays_per_second", "count"))
    assert list(summary) == list(want.index) == ["accel", "cuda", "int8", "torch"]
    for name, row in want.iterrows():
        for col in suite.SUMMARY_COLUMNS:
            np.testing.assert_allclose(summary[name][col], row[col], rtol=1e-9, atol=0,
                                       err_msg=f"{name} {col}")
    assert math.isnan(summary["accel"]["rays_per_second_std"])
    assert math.isnan(summary["int8"]["peak_device_mb"])
    for kind in ("csv", "summary"):
        got, ref = pd.read_csv(paths[kind]), pd.read_csv(jpaths[kind])
        pd.testing.assert_frame_equal(got, ref, check_exact=False, rtol=1e-9)
    with open(paths["json"]) as f, open(jpaths["json"]) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (1, 1), (1, 2, 3)])
def test_png_writer_decodes_through_pillow(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    with Image.open(tmp_path / "a.png") as f:
        assert f.mode == ("L" if len(shape) == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(f), img)


def test_png_writer_refuses_what_it_cannot_write(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError):
            write_png(str(tmp_path / "b.png"), bad)


def test_quality_report_records_a_missing_reference_engine(tmp_path):
    s = _suite(tmp_path, ["cuda"])
    assert s.quality_report() == {"error": {"missing_reference_engine": "torch"}}
    s.generate_report(chart=False)
    with open(tmp_path / "benchmark_results.json") as f:
        assert json.load(f)["quality"] == {"error": {"missing_reference_engine": "torch"}}


def test_quality_report_leaves_degenerate_cells_out_of_the_means(tmp_path, trained):
    # a reference frame with an rgb std under 0.05 (a view of empty space)
    # is flagged and left out of the means; the unfiltered means keep it
    s = _suite(tmp_path, ["torch", "cuda"])
    s.shared.load(trained)
    real = s.engines["torch"].render_image
    seen = []

    def render(pose, *a, **k):
        out = real(pose, *a, **k)
        seen.append(1)
        if len(seen) == 2:        # the second cell's reference: a blank frame
            out.rgb[:] = 1.0
        return out

    s.engines["torch"].render_image = render
    q = s.quality_report(resolutions=[(16, 12)], spp=8, focal=15.0, n_views=2)["cuda"]
    cells = q["cells"]
    assert [c["degenerate"] for c in cells.values()] == [False, True]
    assert q["cells_aggregated"] == 1 and q["psnr_db"] == cells["view0_16x12"]["psnr_db"]
    assert q["psnr_db_all_cells"] == pytest.approx(
        np.mean([c["psnr_db"] for c in cells.values()]))


@pytest.fixture(scope="module")
def both_suites(trained, tmp_path_factory):
    """Both packages' suites on the trained weights, white background,
    bf16 compute, 512-ray chunks: the JAX suite with its Pallas engines in
    interpret mode, the port's on the CPU."""
    jax_suite = jsuite.UnifiedBenchmarkSuite(_white(jdefault()),
                                             str(tmp_path_factory.mktemp("jax")))
    jax_suite.shared = jengines.SharedModel(jax_suite.cfg).load(trained)
    jax_suite.engines = {
        "xla": jengines.XLAEngine(jax_suite.shared, chunk_rays=512),
        "compressed": jengines.CompressedEngine(jax_suite.shared, chunk_rays=512,
                                                interpret=True),
        "int8": jengines.Int8ComputeEngine(jax_suite.shared, chunk_rays=512, interpret=True),
        "accel": jengines.AccelEngine(jax_suite.shared, chunk_rays=512, interpret=True,
                                      **ACCEL)}
    port = UnifiedBenchmarkSuite(_white(default_config()), str(tmp_path_factory.mktemp("port")),
                                 device="cpu")
    port.shared = engines.SharedModel(port.cfg, "cpu").load(trained)
    port.engines = {
        "torch": engines.TorchEngine(port.shared, chunk_rays=512),
        "compressed": engines.CompressedEngine(port.shared, chunk_rays=512),
        "int8": engines.Int8ComputeEngine(port.shared, chunk_rays=512),
        "accel": engines.AccelEngine(port.shared, chunk_rays=512, **ACCEL)}
    return jax_suite, port


def test_quality_report_matches_the_jax_suite(both_suites):
    # each package's engines against its own plain reference, on 2
    # gate_poses x 2 tiny frames (both 512 rays or more: one chunk shape):
    # the same keys and degenerate flags, SSIM within 1e-3, PSNR within
    # 0.5 dB where the engine's error stands well above the two packages'
    # own disagreement (int8 compute: 31 dB and up; accel, whose depths sit
    # elsewhere than the reference's: 20 dB and up). The compressed engine
    # sits at 51 dB and up, within about 17 dB of the noise by which the two
    # packages' bf16 frames differ, so there its cells agree to about 1 dB
    # only: both are held to >= 45 dB
    jax_suite, port = both_suites
    kw = dict(resolutions=[(32, 24), (28, 20)], spp=8, focal=25.0, n_views=2)
    want = jax_suite.quality_report(reference_engine="xla", **kw)
    got = port.quality_report(**kw)
    assert set(got) == set(want) == {"compressed", "int8", "accel"}
    for name in got:
        assert set(got[name]) == set(want[name])
        assert got[name]["cells_aggregated"] == want[name]["cells_aggregated"] == 4
        assert set(got[name]["cells"]) == set(want[name]["cells"])
        for key, cell in got[name]["cells"].items():
            ref = want[name]["cells"][key]
            assert set(cell) == set(ref) and cell["degenerate"] == ref["degenerate"]
            assert abs(cell["ssim"] - ref["ssim"]) <= SSIM_TOL and cell["ssim"] <= 1.0
            if name == "compressed":
                assert cell["psnr_db"] >= 45.0 and ref["psnr_db"] >= 45.0
            else:
                assert abs(cell["psnr_db"] - ref["psnr_db"]) <= PSNR_TOL, (name, key, cell, ref)


def test_gt_quality_report_matches_the_jax_suite(both_suites):
    # truth from each package's plain engine at 32 samples; the plain and
    # the accel engine at 8 and 16 against it: the same meta (but the
    # engine's name) and informative views, PSNR per cell and per view
    # within 0.5 dB, SSIM within 1e-3
    jax_suite, port = both_suites
    kw = dict(resolution=(32, 24), gt_spp=32, spps=(8, 16), focal=25.0, n_views=2)
    want = jax_suite.gt_quality_report(gt_engine="xla", engines=["xla", "accel"], **kw)
    got = port.gt_quality_report(engines=["torch", "accel"], **kw)
    assert got["_meta"] == {**want["_meta"], "gt_engine": "torch"}
    assert got["_meta"]["views_aggregated"] == [0, 1]
    for ours, theirs in (("torch", "xla"), ("accel", "accel")):
        assert set(got[ours]) == set(want[theirs]) == {"8", "16"}
        for spp, cell in got[ours].items():
            ref = want[theirs][spp]
            assert set(cell) == set(ref) and cell["rays_per_second"] > 0
            assert abs(cell["psnr_db_vs_gt"] - ref["psnr_db_vs_gt"]) <= PSNR_TOL
            assert abs(cell["ssim_vs_gt"] - ref["ssim_vs_gt"]) <= SSIM_TOL
            np.testing.assert_allclose(cell["psnr_db_per_view"], ref["psnr_db_per_view"],
                                       atol=PSNR_TOL)
    # the accel engine places its samples better than uniform at 8 a ray
    assert got["accel"]["8"]["psnr_db_vs_gt"] > got["torch"]["8"]["psnr_db_vs_gt"]
