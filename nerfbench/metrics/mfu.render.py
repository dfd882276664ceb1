"""The whole frame's share of the H100's bf16 peak, in %: the model's operations of
the traced frames (``flops.py``) over the traced window's seconds."""

from nerfbench.flops import PEAK_BF16_FLOPS

LAYER = "model step"
UNIT = "%"
MOVES = "render_rays_per_s"


def read(traced):
    return 100.0 * traced.units * traced.flops["total"] / (traced.trace.window_s * PEAK_BF16_FLOPS)
