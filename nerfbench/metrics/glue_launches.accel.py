"""``glue_launches.render`` in the accel frames, which report ``accel_rays_per_s``."""

from nerfbench import harness

LAYER = "glue (host)"
UNIT = "launches/frame"
MOVES = "accel_rays_per_s"


def read(traced):
    return harness.reader("glue_launches.render").read(traced)
