"""Sinusoidal positional encoding.

Layout is the JAX package's (``nerf_tpu/models/encoding.py``):
``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]`` with bands
``f_i = 2^i`` (times pi when ``include_pi``). Phases are formed in the input's
dtype; call it with float32 coordinates, since at the top band (2^9 pi) a
bf16 coordinate is radians off.
"""

from __future__ import annotations

import numpy as np
import torch


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_pi: bool = True) -> torch.Tensor:
    """Encode ``x [..., D] -> [..., D * (1 + 2 * num_freqs)]``."""
    if num_freqs == 0:
        return x
    scale = np.pi if include_pi else 1.0
    freqs = torch.as_tensor((2.0 ** np.arange(num_freqs)) * scale,
                            dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]                 # [..., L, D]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
