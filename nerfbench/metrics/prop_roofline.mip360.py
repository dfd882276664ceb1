"""The share of its roofline of Mip-NeRF 360's proposal network, in %: the
least time its operations of the traced frames could take
(``flops.bound_s`` of ``flops_mip360``'s ``prop``) over the device time of
the proposal entry of the ray kernels' body, ``ray_z_prop360_wgmma_kernel``;
None where it did not run."""

from nerfbench.flops import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "render_rays_per_s"
KEY = "prop"
KERNELS = ("ray_z_prop360_wgmma_kernel",)


def read(traced):
    seconds, launches = traced.trace.seconds_of(KERNELS)
    if launches == 0 or KEY not in traced.flops:
        return None
    return 100.0 * bound_s(traced.units * traced.flops[KEY]) / seconds
