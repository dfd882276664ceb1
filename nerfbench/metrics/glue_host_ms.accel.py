"""Host ms a frame in the occupancy glue (span ``occupancy.z_vals``)."""

from nerfbench import spans

LAYER = "glue (host)"
UNIT = "ms"
MOVES = "accel_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, spans.GLUE, idle=False)
