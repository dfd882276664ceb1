"""Device idle ms a frame while the host is in the occupancy glue."""

from nerfbench import spans

LAYER = "glue (host)"
UNIT = "ms"
MOVES = "accel_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, spans.GLUE, idle=True)
