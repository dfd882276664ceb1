"""Device idle ms a frame while the host is in the mip360 variant's
``mip360.resample`` spans (each level's dilation and sampling, ATen glue):
what that glue keeps the card waiting. None where the trace holds no such
span."""

from nerfbench import spans

LAYER = "glue (host)"
UNIT = "ms"
MOVES = "render_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, ("mip360.resample",), idle=True)
