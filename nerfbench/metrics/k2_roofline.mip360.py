"""The share of its roofline of K2's opaque edges form (Mip-NeRF 360's
compositor, every level), in %: the least time its bytes of the traced
frames could take at the HBM rate (``flops.bound_s`` of ``flops_mip360``'s
``k2_bytes``) over the device time of ``composite_edges_360_kernel``; None
where it did not run."""

from nerfbench.flops import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "render_rays_per_s"
KEY = "k2_bytes"
KERNELS = ("composite_edges_360_kernel",)


def read(traced):
    seconds, launches = traced.trace.seconds_of(KERNELS)
    if launches == 0 or KEY not in traced.flops:
        return None
    return 100.0 * bound_s(0.0, traced.units * traced.flops[KEY]) / seconds
