"""Image-quality metrics: MSE, PSNR and SSIM.

Counterpart of ``nerf_tpu/utils/metrics.py``, on tensors or numpy arrays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(pred, target) -> torch.Tensor:
    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    return torch.mean((pred - target) ** 2)


def psnr_from_mse(m, max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(torch.as_tensor(m), min=1e-12))


def psnr(pred, target, max_val: float = 1.0) -> torch.Tensor:
    return psnr_from_mse(mse(pred, target), max_val)


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over an ``[H, W, C]`` image pair: a separable Gaussian
    window, "valid" along H and then W, per channel (Wang et al., the
    defaults of ``tf.image.ssim``), in float32. Variances are clamped to
    >= 0 and the covariance to +-sqrt(s00 s11), as in the JAX package, so a
    near-constant patch cannot push the mean above 1."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    x = torch.arange(filter_size, dtype=torch.float32) - filter_size // 2
    g = torch.exp(-0.5 * (x / filter_sigma) ** 2)
    g = g / g.sum()
    # channels as the batch: [C, 1, H, W]
    a = torch.as_tensor(img0).to(torch.float32).permute(2, 0, 1)[:, None]
    b = torch.as_tensor(img1).to(torch.float32).permute(2, 0, 1)[:, None]
    g = g.to(a.device)
    gh, gw = g.view(1, 1, -1, 1), g.view(1, 1, 1, -1)

    def blur(t):
        return F.conv2d(F.conv2d(t, gh), gw)

    mu0, mu1 = blur(a), blur(b)
    s00 = torch.clamp(blur(a * a) - mu0 * mu0, min=0.0)
    s11 = torch.clamp(blur(b * b) - mu1 * mu1, min=0.0)
    bound = torch.sqrt(s00 * s11)
    s01 = torch.minimum(torch.maximum(blur(a * b) - mu0 * mu1, -bound), bound)
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)
