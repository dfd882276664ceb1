"""Device time a step of every operation that is not one of the port's kernels
(ATen kernels, copies, fills) in the traced steps."""

LAYER = "train loop glue"
UNIT = "ms"
MOVES = "train_step_ms"


def read(traced):
    seconds, launches = traced.trace.glue()
    return seconds * 1e3 / traced.units
