"""Frozen operation and byte counts of a Mip-NeRF frame
(``configs/mipnerf-blender.json``, driver ``mip_render_loop``), by the rules
of ``flops.py``: a product of a sample counts ``2 * in * out``, the view
direction's term once a ray, biases and activations not at all.

The network is bmild's layout on the integrated positional encoding: 96
encoding rows into layer 0 and into the skip layer, a bottleneck. One frame
runs it at ``n_coarse`` uniform intervals (``k1``, K1-mip) and at
``n_fine`` resampled ones (``k3``, K3-mip). K2's edges form is bound by
memory: ``k2_bytes`` counts what its two launches a chunk must move, each
byte once: the raw output of both passes (float32 ``(density, r, g, b)``
an interval), the fine pass's per-ray edges (the coarse edges are one
shared row), the ``[R, 8]`` outputs of both and the coarse pass's weights.
``total`` is the operations alone (``k1 + k3``), what ``mfu.render`` reads.
"""

from __future__ import annotations

from nerfbench.flops import encoded


def ipe_dim(model: dict) -> int:
    return 6 * (model["ipe_max_deg"] - model["ipe_min_deg"])


def sample_macs(model: dict) -> int:
    """Multiply-adds an interval, without the direction term: layer 0 and
    the skip layer's encoding rows (96 each), the trunk, density,
    bottleneck and color layers."""
    h, ch, pos = model["hidden_dim"], model["color_hidden_dim"], ipe_dim(model)
    return pos * h + (model["n_layers"] - 1) * h * h + pos * h + h + h * h + h * ch + ch * 3


def ray_macs(model: dict) -> int:
    return encoded(model["dir_freqs"]) * model["color_hidden_dim"]


def forward_flops(model: dict, n_rays: int, intervals: int) -> float:
    return 2.0 * (sample_macs(model) * n_rays * intervals + ray_macs(model) * n_rays)


def k2_bytes(n_rays: int, n_coarse: int, n_fine: int, raw_bytes: int = 16) -> float:
    raw = raw_bytes * n_rays * (n_coarse + n_fine)
    edges = 4 * (n_coarse + 1) + 4 * n_rays * (n_fine + 1)
    outs = 2 * 32 * n_rays + 4 * n_rays * n_coarse
    return float(raw + edges + outs)


def frame_flops(model: dict, n_rays: int, render: dict) -> dict:
    """``k1``, ``k3`` (operations), ``k2_bytes`` and ``total`` of one
    hierarchical frame of ``n_rays`` rays."""
    k1 = forward_flops(model, n_rays, render["n_coarse"])
    k3 = forward_flops(model, n_rays, render["n_fine"])
    return {"k1": k1, "k3": k3, "k2_bytes": k2_bytes(n_rays, render["n_coarse"], render["n_fine"]),
            "total": k1 + k3}
