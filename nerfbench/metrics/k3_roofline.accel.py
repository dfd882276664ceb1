"""``k3_roofline`` in the accel frames, which report ``accel_rays_per_s``."""

from nerfbench import harness

LAYER = "kernels"
UNIT = "%"
MOVES = "accel_rays_per_s"


def read(traced):
    return harness.reader("k3_roofline").read(traced)
