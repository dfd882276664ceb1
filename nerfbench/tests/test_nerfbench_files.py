"""Every file BENCHMARK.json names is found by name and parses, and the
benchmark keeps to its contract's shape."""

import json
import re

import pytest

from nerfbench import flops, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["nerfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry, workload, config = harness.cell(cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert (harness.HERE / "drivers" / f"{workload['driver']}.py").exists()
    assert set(workload["check"]["limits"]) and workload["check"]["control"] in ("fp8", "int4")
    e2e = [m["name"] for m in harness.metrics_of("end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.metrics_of("per_layer", cell)
    assert per and all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_files(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    config = harness.load_json(harness.ROOT / entry["file"])
    assert config["name"] == name and config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]
    harness.program_config(config)
    assert any(w["config"] == name for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_readers(metric):
    spec = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    module = harness.reader(metric)
    assert (module.LAYER, module.UNIT, module.MOVES) == (spec["layer"], spec["unit"],
                                                          spec["moves"])
    assert callable(module.read)


class _FakeTrace:
    window_s, busy_s = 2.0, 1.5

    def seconds_of(self, names):
        return (0.0, 0) if "nothing" in names else (1.0, 10)

    def glue(self):
        return 0.25, 30


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_readers_on_a_trace(metric):
    f = {"k1": 1e12, "k3": 2e12, "k4": 1e12, "k5": 2e12, "total": 3e12}
    value = harness.reader(metric).read(harness.Traced(_FakeTrace(), 2, f))
    assert value is not None and value > 0


def test_roofline_reads_none_where_its_kernels_never_ran():
    module = harness.reader("k3_roofline")
    saved = module.KERNELS
    module.KERNELS = ("nothing",)
    try:
        assert module.read(harness.Traced(_FakeTrace(), 2, {"k3": 1.0, "total": 1.0})) is None
    finally:
        module.KERNELS = saved


def test_mfu_reads_the_whole_step_at_peak():
    tr = harness.Traced(_FakeTrace(), 2, {"total": flops.PEAK_BF16_FLOPS})
    assert harness.reader("mfu.render").read(tr) == pytest.approx(100.0)
