"""The share of its roofline of K5, the backward of a train step (K5a and K5b together), in %:
the least time its operations of the traced steps could take (``flops.bound_s``) over the device time of the
kernels named in ``KERNELS``; None where none of them ran."""

from nerfbench.flops import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "train_step_ms"
KEY = "k5"
KERNELS = ("bwd_rows_wgmma_kernel", "wgrad_wgmma_kernel", "mlp_backward_kernel")


def read(traced):
    seconds, launches = traced.trace.seconds_of(KERNELS)
    if launches == 0 or KEY not in traced.flops:
        return None
    return 100.0 * bound_s(traced.units * traced.flops[KEY]) / seconds
