"""NeRF MLP as plain functions over a nested dict of tensors.

Counterpart of ``nerf_tpu/models/nerf.py``. Params keep the JAX package's
layout: ``{'trunk': [{'w','b'}...], 'density', 'color0', 'color1'}`` plus
``'bottleneck'`` for the bmild variant, every ``w`` ``[in, out]`` float32, so
``x @ w + b`` per layer and the two packages' params convert leaf for leaf
(``params_from_numpy``).

``apply_nerf`` is the plain evaluator the ``torch`` engine runs and the
reference the fused ray kernel (``ops/render_kernel.py``) is tested against.
A bf16 compute dtype rounds each matmul's inputs to bf16 and accumulates in
float32 (the JAX package's ``preferred_element_type=float32``); it is
written as a float32 product of bf16-rounded operands, so CPU and GPU
compute the same function.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from nerf_tpu_torch.config import ModelConfig
from nerf_tpu_torch.models.encoding import positional_encoding
from nerf_tpu_torch.train.checkpoint import unflatten_keystr
from nerf_tpu_torch.utils.device import disable_tf32, resolve_device

NeRFParams = Dict[str, Any]


def _linear_init(g: torch.Generator, fan_in: int, fan_out: int):
    """torch.nn.Linear's default rule: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias."""
    bound = 1.0 / np.sqrt(fan_in)
    w = (torch.rand(fan_in, fan_out, generator=g) * 2.0 - 1.0) * bound
    b = (torch.rand(fan_out, generator=g) * 2.0 - 1.0) * bound
    return {"w": w, "b": b}


def init_nerf_params(generator: torch.Generator, cfg: ModelConfig,
                     device="cuda") -> NeRFParams:
    """Random params for either variant, drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device), then
    moved to ``device``."""
    dev = resolve_device(device)
    pos_dim, dir_dim, h = cfg.pos_dim, cfg.dir_dim, cfg.hidden_dim
    trunk = []
    for i in range(cfg.n_layers):
        fan_in = pos_dim if i == 0 else h
        # reference: skip concat before layer skip_layer; bmild: after it,
        # so layer skip_layer + 1 sees the wide input
        if i == cfg.skip_layer + (0 if cfg.variant == "reference" else 1):
            fan_in = h + pos_dim
        trunk.append(_linear_init(generator, fan_in, h))
    params: NeRFParams = {
        "trunk": trunk,
        "density": _linear_init(generator, h, 1),
        "color0": _linear_init(generator, h + dir_dim, cfg.color_hidden_dim),
        "color1": _linear_init(generator, cfg.color_hidden_dim, 3),
    }
    if cfg.variant == "bmild":
        params["bottleneck"] = _linear_init(generator, h, h)
    return _to(params, dev)


def _to(tree, device, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device, dtype) for v in tree]
    leaf = tree if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))
    return leaf.to(device=device, dtype=dtype)


def _dense(x: torch.Tensor, layer: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    w = layer["w"]
    if dtype != torch.float32:
        x = x.to(dtype).float()
        w = w.to(dtype).float()
    return x.float() @ w + layer["b"]


def apply_nerf(
    params: NeRFParams,
    positions: torch.Tensor,
    directions: Optional[torch.Tensor],
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the MLP at ``positions [..., 3]`` seen from ``directions``.
    Returns ``(sigma [...], rgb [..., 3])`` float32; sigma is ReLU'd for the
    reference variant and raw for bmild."""
    disable_tf32()
    pos_enc = positional_encoding(positions.float(), cfg.pos_freqs, cfg.posenc_pi)
    x = pos_enc
    for i, layer in enumerate(params["trunk"]):
        if cfg.variant == "reference" and i == cfg.skip_layer:
            x = torch.cat([x, pos_enc], dim=-1)
        x = torch.relu(_dense(x, layer, compute_dtype))
        if cfg.variant == "bmild" and i == cfg.skip_layer:
            x = torch.cat([pos_enc, x], dim=-1)

    sigma = _dense(x, params["density"], compute_dtype)[..., 0]
    if cfg.variant == "reference":
        sigma = torch.relu(sigma)

    if directions is None:
        directions = torch.zeros_like(positions)
    directions = directions.float()
    if cfg.normalize_dirs:
        directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    dir_enc = positional_encoding(directions, cfg.dir_freqs, cfg.posenc_pi)

    feat = x
    if cfg.variant == "bmild":
        feat = _dense(x, params["bottleneck"], compute_dtype)   # no activation
    c = torch.cat([feat, dir_enc], dim=-1)
    c = torch.relu(_dense(c, params["color0"], compute_dtype))
    rgb = torch.sigmoid(_dense(c, params["color1"], compute_dtype))
    return sigma, rgb


# ---------------------------------------------------------------------------
# Weight importers
# ---------------------------------------------------------------------------


def params_from_numpy(tree: Mapping[str, Any], device="cuda") -> NeRFParams:
    """Carry params across from the JAX package: a nested dict of numpy (or
    any array-like) leaves, as ``jax.device_get(params)`` gives, or the flat
    keystr dict of a params ``.npz``. Returns float32 tensors on ``device``
    in the same nesting."""
    dev = resolve_device(device)
    if tree and all(isinstance(k, str) and k.startswith("[") for k in tree):
        tree = unflatten_keystr(tree)
    return _to(dict(tree), dev)


def params_to_numpy(params: NeRFParams) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy`` (nested dict of numpy arrays)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


def params_from_torch_state_dict(state_dict: Mapping[str, Any], cfg: ModelConfig,
                                 device="cuda") -> NeRFParams:
    """Import a reference-format ``NeRFModel`` state_dict (Linear weights
    ``[out, in]``, transposed here to ``[in, out]``)."""
    dev = resolve_device(device)

    def lin(prefix):
        w = torch.as_tensor(state_dict[f"{prefix}.weight"], dtype=torch.float32)
        b = torch.as_tensor(state_dict[f"{prefix}.bias"], dtype=torch.float32)
        return {"w": w.t().contiguous().to(dev), "b": b.to(dev)}

    return {
        "trunk": [lin(f"layers.{i}") for i in range(cfg.n_layers)],
        "density": lin("density_head"),
        "color0": lin("color_layers.0"),
        "color1": lin("color_layers.1"),
    }


def params_to_torch_state_dict(params: NeRFParams) -> Dict[str, np.ndarray]:
    """Export "reference"-variant params (tensors on any device) as a
    reference-format state_dict of numpy arrays, Linear weights ``[out,
    in]``: the inverse of ``params_from_torch_state_dict``."""
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params["trunk"]):
        out[f"layers.{i}.weight"] = layer["w"].detach().cpu().numpy().T
        out[f"layers.{i}.bias"] = layer["b"].detach().cpu().numpy()
    for name, key in (("density_head", "density"), ("color_layers.0", "color0"),
                      ("color_layers.1", "color1")):
        out[f"{name}.weight"] = params[key]["w"].detach().cpu().numpy().T
        out[f"{name}.bias"] = params[key]["b"].detach().cpu().numpy()
    return out


def load_bmild_weights(path: str, device="cuda") -> NeRFParams:
    """Original-NeRF Keras weights: an object array of 24 ``[in, out]``
    weight/bias arrays (8 trunk pairs, bottleneck, viewdir, rgb, alpha)."""
    arrs = np.load(path, allow_pickle=True)
    if len(arrs) != 24:
        raise ValueError(f"expected 24 arrays in bmild weight file, got {len(arrs)}")

    def pair(i):
        return {"w": arrs[2 * i], "b": arrs[2 * i + 1]}

    return params_from_numpy({
        "trunk": [pair(i) for i in range(8)],
        "bottleneck": pair(8),
        "color0": pair(9),
        "color1": pair(10),
        "density": pair(11),
    }, device)


def count_params(params: NeRFParams) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()
