"""Host ms a frame in the kernel wrappers (spans ``kernel.*``): checks,
allocation, pointer arrays, the ctypes call."""

from nerfbench import spans

LAYER = "kernel dispatch"
UNIT = "ms"
MOVES = "accel_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, spans.DISPATCH, idle=False)
