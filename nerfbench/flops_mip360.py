"""Frozen operation and byte counts of a Mip-NeRF 360 frame
(``configs/mipnerf360-outdoor.json``, driver ``mip360_render_loop``), by the
rules of ``flops.py``: a product of an interval counts ``2 * in * out``
(the encoding's real width, not its padding), the view direction's term
once a ray, biases and activations not at all.

A frame runs the proposal network (``prop_layers`` x ``prop_hidden_dim``,
density only) at ``n_coarse`` intervals on each of the two proposal
levels (``prop``: the proposal entry of the ray kernels' body) and the NeRF
network (``n_layers`` x ``hidden_dim`` with the skip, density, bottleneck,
color) at ``n_fine`` (``nerf``: the NeRF pass, encoder included). K2's
opaque edges form is bound by memory: ``k2_bytes`` counts what its
launches a chunk must move, each byte once: a proposal level's densities
and edges in and weights out, the NeRF level's float32 ``(density, r, g,
b)`` and edges in and its ``[R, 8]`` out. ``total`` is the operations
alone (``prop + nerf``), what ``mfu.render`` reads.
"""

from __future__ import annotations

from nerfbench.flops import encoded


N_BASIS = 21          # directions of the icosahedral basis at two subdivisions
N_PROP_LEVELS = 2     # proposal levels before the NeRF level


def ipe_dim(model: dict) -> int:
    return 2 * N_BASIS * (model["ipe_max_deg"] - model["ipe_min_deg"])


def prop_macs(model: dict) -> int:
    """Multiply-adds of the proposal network an interval."""
    ph = model["prop_hidden_dim"]
    return ipe_dim(model) * ph + (model["prop_layers"] - 1) * ph * ph + ph


def nerf_macs(model: dict) -> int:
    """Multiply-adds of the NeRF network an interval, without the direction
    term: layer 0 and the skip layer's encoding rows, the trunk, density,
    bottleneck, color and rgb layers."""
    h, pos = model["hidden_dim"], ipe_dim(model)
    b, ch = model["bottleneck_dim"], model["color_hidden_dim"]
    return pos * h + (model["n_layers"] - 1) * h * h + pos * h + h + h * b + b * ch + ch * 3


def ray_macs(model: dict) -> int:
    return encoded(model["dir_freqs"]) * model["color_hidden_dim"]


def k2_bytes(n_rays: int, render: dict) -> float:
    n_c, n_f = render["n_coarse"], render["n_fine"]
    prop = N_PROP_LEVELS * n_rays * (4 * n_c + 4 * (n_c + 1) + 4 * n_c)
    nerf = n_rays * (16 * n_f + 4 * (n_f + 1) + 32)
    return float(prop + nerf)


def frame_flops(model: dict, n_rays: int, render: dict) -> dict:
    """``prop``, ``nerf`` (operations), ``k2_bytes`` and ``total`` of one
    frame of ``n_rays`` rays."""
    prop = 2.0 * prop_macs(model) * n_rays * render["n_coarse"] * N_PROP_LEVELS
    nerf = 2.0 * (nerf_macs(model) * n_rays * render["n_fine"] + ray_macs(model) * n_rays)
    return {"prop": prop, "nerf": nerf, "k2_bytes": k2_bytes(n_rays, render),
            "total": prop + nerf}
