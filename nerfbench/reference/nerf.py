"""The NeRF MLP of both variants in float32.

``variant="reference"`` is dgsmith7/nerf-dbr's network (8 x 256 ReLU trunk,
the encoding concatenated before layer ``skip_layer``, ReLU density, a
128-wide color branch); ``"bmild"`` is Mildenhall et al.'s (the encoding
concatenated after layer ``skip_layer``, raw density, a linear bottleneck
before the color branch, unit view directions). Params are the JAX layout
the port keeps: ``{'trunk': [{'w', 'b'}, ...], 'density', 'color0',
'color1'}`` (+ ``'bottleneck'``), each ``w`` ``[in, out]``.

``Rounding`` rounds both operands of every product, accumulating in float32:
to the configuration's own compute dtype (``rounding_of``: bf16 operands, as
the port computes), or one step lower for the control (``fp8_rounding``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

Params = Dict[str, object]
Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def disable_tf32() -> None:
    """True float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_rounding(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 against its absmax (448 at the top), as
    a float32 tensor; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def bf16_rounding(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, as a float32 tensor; the gradient passes
    straight through."""
    return x + (x.detach().to(torch.bfloat16).float() - x).detach()


def encoded_dim(n_freqs: int) -> int:
    return 3 * (1 + 2 * n_freqs)


def encode(x: torch.Tensor, n_freqs: int, include_pi: bool) -> torch.Tensor:
    """``[x, sin(f0 x), cos(f0 x), ...]``, bands ``2^i`` (times pi)."""
    bands = torch.tensor([(2.0 ** i) * (math.pi if include_pi else 1.0)
                          for i in range(n_freqs)], dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * bands[:, None]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], 6 * n_freqs)], dim=-1)


def mlp(params: Params, points: torch.Tensor, ray_dirs: torch.Tensor, model: dict,
        rnd: Rounding = None):
    """``(sigma [R, S], rgb [R, S, 3])`` at ``points [R, S, 3]`` seen along
    ``ray_dirs [R, 3]`` (one direction a ray: its term is formed once a ray
    and added to each of its samples). The reference variant's sigma is
    ReLU'd, bmild's raw."""
    variant, skip = model["variant"], model["skip_layer"]
    pi = model["posenc_pi"]
    enc = encode(points, model["pos_freqs"], pi)
    x = enc
    for i, layer in enumerate(params["trunk"]):
        if variant == "reference" and i == skip:
            x = torch.cat([x, enc], dim=-1)
        x = torch.relu(_product(x, layer, rnd))
        if variant == "bmild" and i == skip:
            x = torch.cat([enc, x], dim=-1)
    sigma = _product(x, params["density"], rnd)[..., 0]
    if variant == "reference":
        sigma = torch.relu(sigma)
    d = ray_dirs
    if model["normalize_dirs"]:
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d_enc = encode(d, model["dir_freqs"], pi)                         # [R, 27]
    feat = _product(x, params["bottleneck"], rnd) if variant == "bmild" else x
    h = feat.shape[-1]
    c0 = params["color0"]
    w_h, w_d = c0["w"][:h], c0["w"][h:]
    if rnd is not None:
        feat, w_h, d_enc, w_d = rnd(feat), rnd(w_h), rnd(d_enc), rnd(w_d)
    c = torch.relu(feat @ w_h + (d_enc @ w_d + c0["b"])[:, None, :])
    rgb = torch.sigmoid(_product(c, params["color1"], rnd))
    return sigma, rgb


def _product(x, layer, rnd: Rounding):
    w = layer["w"]
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    return x @ w + layer["b"]


def rounding_of(config: dict) -> Rounding:
    """The products' operand rounding the configuration states: its
    ``compute_dtype`` (bf16 operands, float32 accumulation), or none."""
    return {"bfloat16": bf16_rounding, "float32": None}[config["compute_dtype"]]


def leaves(params) -> List[tuple]:
    """``(path, tensor)`` of every leaf, dict keys sorted, list items by
    index: the order in which the trainer's optimizer holds its moments."""
    if isinstance(params, dict):
        return [((k,) + p, t) for k in sorted(params) for p, t in leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [((i,) + p, t) for i, v in enumerate(params) for p, t in leaves(v)]
    return [((), params)]


def map_params(fn, params):
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(fn, v) for v in params]
    return fn(params)
