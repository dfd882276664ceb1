"""Frozen operation counts of the NeRF network and the H100's peaks.

The count is the model's: the products a cell's shapes require, whatever
kernel runs them. A product of a sample counts ``2 * in * out``; the view
direction's term of the first color layer is counted once a ray, since all
samples of a ray share it. Biases and activations are not counted.
Backward: the weight gradient of every product, and the input gradient of
every product whose input is not an encoding. Padding rays are not counted.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def encoded(n_freqs: int) -> int:
    return 3 * (1 + 2 * n_freqs)


def sample_macs(model: dict) -> int:
    """Multiply-adds a sample, without the direction term: the trunk (with
    the encoding's rows of the skip layer), density, color layers."""
    h, ch = model["hidden_dim"], model["color_hidden_dim"]
    pos = encoded(model["pos_freqs"])
    macs = pos * h + (model["n_layers"] - 1) * h * h + pos * h + h + h * ch + ch * 3
    if model["variant"] == "bmild":
        macs += h * h                                     # bottleneck
    return macs


def ray_macs(model: dict) -> int:
    """Multiply-adds a ray of one network pass: the direction term."""
    return encoded(model["dir_freqs"]) * model["color_hidden_dim"]


def dgrad_macs(model: dict) -> int:
    """Multiply-adds a sample of the input gradients: every product whose
    input is not an encoding."""
    h, ch = model["hidden_dim"], model["color_hidden_dim"]
    macs = (model["n_layers"] - 1) * h * h + h + h * ch + ch * 3
    if model["variant"] == "bmild":
        macs += h * h
    return macs


def forward_flops(model: dict, n_rays: int, samples: int) -> float:
    """One network's forward pass over ``n_rays`` rays of ``samples``."""
    return 2.0 * (sample_macs(model) * n_rays * samples + ray_macs(model) * n_rays)


def backward_flops(model: dict, n_rays: int, samples: int) -> float:
    """Its backward: weight gradients (as many as the forward) and input
    gradients."""
    return 2.0 * ((sample_macs(model) + dgrad_macs(model)) * n_rays * samples
                  + ray_macs(model) * n_rays)


def frame_flops(model: dict, kind: str, n_rays: int, samples: int, render: dict) -> dict:
    """Operations of one frame by the kernel that carries them: ``k1`` (the
    uniform pass), ``k3`` (the per-ray-depth pass)."""
    if kind == "hierarchical":
        return {"k1": forward_flops(model, n_rays, render["n_coarse"]),
                "k3": forward_flops(model, n_rays, render["n_coarse"] + render["n_fine"])}
    if kind == "accel":
        return {"k3": forward_flops(model, n_rays, samples)}
    return {"k1": forward_flops(model, n_rays, samples)}


def step_flops(model: dict, n_rays: int, render: dict) -> dict:
    """Operations of one train step of both networks: ``k4`` (forward),
    ``k5`` (backward)."""
    passes = (render["n_coarse"], render["n_coarse"] + render["n_fine"])
    return {"k4": sum(forward_flops(model, n_rays, s) for s in passes),
            "k5": sum(backward_flops(model, n_rays, s) for s in passes)}


def bound_s(flops: float, nbytes: float = 0.0) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
