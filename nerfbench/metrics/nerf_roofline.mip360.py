"""The share of its roofline of Mip-NeRF 360's NeRF pass, in %: the least
time its operations of the traced frames could take (``flops.bound_s`` of
``flops_mip360``'s ``nerf``) over the device time of every kernel of the
pass, the encoder and the direction term included; None where none ran."""

from nerfbench.flops import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "render_rays_per_s"
KEY = "nerf"
KERNELS = ("mip360_encode_kernel", "mip360_dense_wgmma_kernel", "mip360_dir_kernel")


def read(traced):
    seconds, launches = traced.trace.seconds_of(KERNELS)
    if launches == 0 or KEY not in traced.flops:
        return None
    return 100.0 * bound_s(traced.units * traced.flops[KEY]) / seconds
