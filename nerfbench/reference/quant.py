"""The compressed engine's weights, worked out again in float32.

Pruning: in each weight matrix the entries with ``|w|`` at or under the
``prune_fraction`` quantile of ``|w|`` (linear interpolation at index
``fraction * (n - 1)``, in float32) become 0; biases stay. Quantization:
symmetric, one scale per output column, ``scale = max|w| / qmax`` with
``qmax = 2^(bits - 1) - 1``, ``q = clip(round(w / scale))``, over the row
groups the engine's kernels hold as separate matrices: the hidden and the
encoding rows of the skip layer, and the feature and the direction rows of
the first color layer, each apart; the density column as one group. The
result is the dequantized weights ``q * scale`` in float32, in the params'
own layout.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfbench.reference.nerf import encoded_dim, map_params


def _quantile(x: torch.Tensor, fraction: float) -> torch.Tensor:
    a = torch.sort(x.reshape(-1)).values
    last = np.float32(a.numel() - 1)
    pos = np.float32(fraction) * last
    low, high = np.floor(pos), np.ceil(pos)
    hi_w = pos - low
    lo_w = np.float32(1.0) - hi_w
    return a[int(low)] * float(lo_w) + a[int(high)] * float(hi_w)


def prune(net: dict, fraction: float) -> dict:
    if fraction <= 0.0:
        return net

    def walk(node):
        if isinstance(node, dict) and "w" in node:
            w = node["w"]
            mag = w.abs()
            return {"w": torch.where(mag <= _quantile(mag, fraction), torch.zeros_like(w), w),
                    "b": node["b"]}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(net)


def _dequantized(w: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12) / qmax
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def quantized(net: dict, model: dict, bits: int) -> dict:
    """The network with every weight matrix quantized to ``bits`` and back."""
    h = model["hidden_dim"]
    pos_dim = encoded_dim(model["pos_freqs"])
    wide = model["skip_layer"] + (0 if model["variant"] == "reference" else 1)
    out = map_params(lambda t: t, net)
    for i, layer in enumerate(net["trunk"]):
        w = layer["w"]
        if i == wide:
            split = h if model["variant"] == "reference" else pos_dim
            w = torch.cat([_dequantized(w[:split], bits), _dequantized(w[split:], bits)])
        else:
            w = _dequantized(w, bits)
        out["trunk"][i] = {"w": w, "b": layer["b"]}
    for name in ("density", "color1", "bottleneck"):
        if name in net:
            out[name] = {"w": _dequantized(net[name]["w"], bits), "b": net[name]["b"]}
    w = net["color0"]["w"]
    out["color0"] = {"w": torch.cat([_dequantized(w[:h], bits), _dequantized(w[h:], bits)]),
                     "b": net["color0"]["b"]}
    return out


def compressed(nets: dict, model: dict, bits: int, prune_fraction: float) -> dict:
    return {k: quantized(prune(v, prune_fraction), model, bits) for k, v in nets.items()}
