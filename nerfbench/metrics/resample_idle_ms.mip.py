"""Device idle ms a frame while the host is in the mip variant's
``mip.resample`` spans (the resampler's glue between the coarse and the
fine pass): what that glue keeps the card waiting. The span's host length
is no measure of the glue: in a device-bound frame the host waits there
for room in the launch queue behind K1-mip. None where the trace holds no
such span."""

from nerfbench import spans

LAYER = "glue (host)"
UNIT = "ms"
MOVES = "render_rays_per_s"


def read(traced):
    return spans.per_frame_ms(traced, ("mip.resample",), idle=True)
