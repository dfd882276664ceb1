"""``frame_idle_ms.render`` in the accel frames, which report ``accel_rays_per_s``."""

from nerfbench import spans

LAYER = "frame loop"
UNIT = "ms"
MOVES = "accel_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, spans.FRAME, idle=True)
