"""The share of its roofline of K3-mip, the mip variant's ray kernel at the
resampled per-ray intervals, in %: the least time its operations of the
traced frames could take (``flops.bound_s`` of ``flops_mip``'s ``k3``) over
the device time of ``ray_z_mip_wgmma_kernel``; None where it did not run."""

from nerfbench.flops import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "render_rays_per_s"
KEY = "k3"
KERNELS = ("ray_z_mip_wgmma_kernel",)


def read(traced):
    seconds, launches = traced.trace.seconds_of(KERNELS)
    if launches == 0 or KEY not in traced.flops:
        return None
    return 100.0 * bound_s(traced.units * traced.flops[KEY]) / seconds
