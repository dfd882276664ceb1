"""``glue_device_ms.render`` in the accel frames, which report ``accel_rays_per_s``."""

from nerfbench import harness

LAYER = "glue"
UNIT = "ms"
MOVES = "accel_rays_per_s"


def read(traced):
    return harness.reader("glue_device_ms.render").read(traced)
