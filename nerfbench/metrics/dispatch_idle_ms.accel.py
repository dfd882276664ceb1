"""Device idle ms a frame while the host is in a kernel wrapper."""

from nerfbench import spans

LAYER = "kernel dispatch"
UNIT = "ms"
MOVES = "accel_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, spans.DISPATCH, idle=True)
