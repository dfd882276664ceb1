"""``device_idle_share.render`` in the accel frames, which report ``accel_rays_per_s``."""

from nerfbench import harness

LAYER = "device"
UNIT = "%"
MOVES = "accel_rays_per_s"


def read(traced):
    return harness.reader("device_idle_share.render").read(traced)
