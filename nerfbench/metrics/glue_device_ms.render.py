"""Device time a frame of every operation that is not one of the port's kernels
(ATen kernels, copies, fills) in the traced frames."""

LAYER = "glue"
UNIT = "ms"
MOVES = "render_rays_per_s"


def read(traced):
    seconds, launches = traced.trace.glue()
    return seconds * 1e3 / traced.units
