"""Image-quality metrics: MSE and PSNR.

Counterpart of ``mse``, ``psnr`` and ``psnr_from_mse`` in
``nerf_tpu/utils/metrics.py``, on tensors or numpy arrays.
"""

from __future__ import annotations

import torch


def mse(pred, target) -> torch.Tensor:
    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    return torch.mean((pred - target) ** 2)


def psnr_from_mse(m, max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(torch.as_tensor(m), min=1e-12))


def psnr(pred, target, max_val: float = 1.0) -> torch.Tensor:
    return psnr_from_mse(mse(pred, target), max_val)
