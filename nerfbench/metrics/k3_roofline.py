"""The share of its roofline of K3, the ray kernel at per-ray depths, in %:
the least time its operations of the traced frames could take (``flops.bound_s``) over the device time of the
kernels named in ``KERNELS``; None where none of them ran."""

from nerfbench.flops import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "render_rays_per_s"
KEY = "k3"
KERNELS = ("ray_z_wgmma_kernel", "ray_z_composite_wgmma_kernel", "ray_z_kernel", "ray_z_composite_kernel")


def read(traced):
    seconds, launches = traced.trace.seconds_of(KERNELS)
    if launches == 0 or KEY not in traced.flops:
        return None
    return 100.0 * bound_s(traced.units * traced.flops[KEY]) / seconds
