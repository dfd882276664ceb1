"""``flops.py`` against counts made by hand."""

import pytest

from nerfbench import flops, harness

REF = harness.load_json(harness.HERE / "configs" / "nerf-dbr-reference.json")
LEGO = {**REF, "model": {**REF["model"], "variant": "bmild"}}   # bmild/nerf's network


def test_per_sample_counts_by_hand():
    # reference: 63x256, 7 x 256x256, the skip's 63 encoding rows x 256,
    # density 256, color 256x128, 128x3
    assert flops.sample_macs(REF["model"]) == 16128 + 458752 + 16128 + 256 + 32768 + 384
    # bmild adds the 256x256 bottleneck
    assert flops.sample_macs(LEGO["model"]) == 524416 + 65536
    assert flops.ray_macs(REF["model"]) == 27 * 128
    assert flops.dgrad_macs(REF["model"]) == 458752 + 256 + 32768 + 384


def test_frame_and_step_counts():
    n = 800 * 600
    f = flops.frame_flops(LEGO["model"], "hierarchical", n, 64, LEGO["render"])
    assert f["k1"] == 2 * (589952 * n * 64 + 3456 * n)
    assert f["k3"] == 2 * (589952 * n * 192 + 3456 * n)
    assert sum(f.values()) == pytest.approx(1.45e14, rel=1e-3)
    assert flops.frame_flops(REF["model"], "accel", n, 32, REF["render"]) == {
        "k3": 2 * (524416 * n * 32 + 3456 * n)}
    s = flops.step_flops(REF["model"], 2048, REF["render"])
    assert s["k4"] == 2 * (524416 * 2048 * 256 + 3456 * 4096)
    assert s["k5"] == 2 * ((524416 + 492160) * 2048 * 256 + 3456 * 4096)


def test_bound_is_the_longer_of_operations_and_bytes():
    assert flops.bound_s(989e12) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
