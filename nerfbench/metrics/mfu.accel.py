"""``mfu.render`` in the accel frames, which report ``accel_rays_per_s``."""

from nerfbench import harness

LAYER = "model step"
UNIT = "%"
MOVES = "accel_rays_per_s"


def read(traced):
    return harness.reader("mfu.render").read(traced)
