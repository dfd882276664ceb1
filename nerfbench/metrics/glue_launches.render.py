"""Device launches a frame of every operation that is not one of the port's kernels
(ATen kernels, copies, fills) in the traced frames."""

LAYER = "glue (host)"
UNIT = "launches/frame"
MOVES = "render_rays_per_s"


def read(traced):
    seconds, launches = traced.trace.glue()
    return float(launches) / traced.units
