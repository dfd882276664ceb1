"""Share of the traced window in which no operation ran on the card, in %."""

LAYER = "device"
UNIT = "%"
MOVES = "render_rays_per_s"


def read(traced):
    tr = traced.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
