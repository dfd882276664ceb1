"""The trainer's step in float32: ray selection, the coarse and fine render
with jitter and random importance draws, loss, gradients and the optimizer.

The step's random numbers are drawn from a generator on the training
device, in the trainer's order and shapes (pixel ids, the coarse jitter,
the importance draws), so that the same seed gives the same rays and depths.
The optimizer is optax's chain of the trainer: clip by global norm (scale
``max / norm`` only when ``norm >= max``), decay ``wd * p`` added, Adam
(``eps`` outside the root), learning rate ``lr * decay^(count / steps)``
at the count before the update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from nerfbench.reference.nerf import Rounding, leaves, mlp
from nerfbench.reference.render import composite, sample_pdf, uniform_depths

B1, B2, EPS = 0.9, 0.999, 1e-8


def select_rays(image, pose, focal: float, g: torch.Generator, n_rays: int):
    H, W = image.shape[:2]
    idx = torch.randint(0, H * W, (n_rays,), device=image.device, generator=g)
    i = (idx % W).float()
    j = torch.div(idx, W, rounding_mode="floor").float()
    d = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)], -1)
    rays_d = (d[:, None, :] * pose[:3, :3]).sum(-1)
    return pose[:3, 3].expand(rays_d.shape), rays_d, image.reshape(-1, 3)[idx]


def loss(nets, ro, rd, target, g: torch.Generator, model: dict, render: dict,
         rnd: Rounding = None, keep: Optional[int] = None):
    """MSE of the coarse plus the fine render. ``keep``: only the first
    ``keep`` rays enter the loss (a fault: part of the batch left out)."""
    n = ro.shape[0]
    near, far = render["near"], render["far"]
    z = uniform_depths(n, near, far, render["n_coarse"], ro.device)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    z_c = lower + (upper - lower) * torch.rand(z.shape, device=ro.device, generator=g)
    u = torch.rand((n, render["n_fine"]), device=ro.device, generator=g)
    pts = ro[:, None] + rd[:, None] * z_c[..., None]
    rgb_c, _, w = composite(*mlp(nets["coarse"], pts, rd, model, rnd), z_c, rd, render)
    z_f = torch.sort(torch.cat([z_c, sample_pdf(z_c, w.detach(), render["n_fine"], u=u)], -1),
                     -1).values
    pts = ro[:, None] + rd[:, None] * z_f[..., None]
    rgb_f, _, _ = composite(*mlp(nets["fine"], pts, rd, model, rnd), z_f, rd, render)
    k = n if keep is None else keep
    return (torch.mean((rgb_c[:k] - target[:k]) ** 2)
            + torch.mean((rgb_f[:k] - target[:k]) ** 2))


class Adam:
    def __init__(self, train: dict, params: List[torch.Tensor]):
        self.t = train
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        t = self.t
        norm = torch.linalg.vector_norm(torch.stack([gr.norm() for gr in grads]))
        scale = torch.where(norm < t["grad_clip_norm"], torch.ones_like(norm),
                            t["grad_clip_norm"] / norm)
        n = self.count + 1
        lr = t["learning_rate"] * t["lr_decay"] ** (self.count / t["lr_decay_steps"])
        step_size = torch.tensor(lr / (1.0 - B1 ** n), dtype=torch.float64).float().item()
        bias2 = torch.tensor(1.0 - B2 ** n, dtype=torch.float64).float().item()
        for p, gr, m, v in zip(params, grads, self.mu, self.nu):
            gr = gr * scale + t["weight_decay"] * p
            m.mul_(B1).add_(gr, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(gr, gr, value=1.0 - B2)
            p.sub_(step_size * m / (torch.sqrt(v / bias2) + EPS))
        self.count += 1


class Trainer:
    """The reference's training run: its own params from the seed, its own
    generator on the device, one ``step`` a view."""

    def __init__(self, nets: Dict[str, dict], seed: int, model: dict, render: dict,
                 train: dict, device, rnd: Rounding = None, keep: Optional[int] = None):
        self.nets, self.model, self.render, self.train = nets, model, render, train
        self.paths = [p for p, _ in leaves(nets)]
        self.params = [t.requires_grad_(True) for _, t in leaves(nets)]
        self.opt = Adam(train, self.params)
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.rnd, self.keep = rnd, keep
        self.grad_norms = [0.0] * len(self.params)

    def step(self, image, pose, focal: float) -> float:
        ro, rd, target = select_rays(image, pose, focal, self.g, self.train["n_rays"])
        value = loss(self.nets, ro, rd, target, self.g, self.model, self.render, self.rnd,
                     self.keep)
        grads = list(torch.autograd.grad(value, self.params))
        self.grad_norms = [max(a, float(gr.norm())) for a, gr in zip(self.grad_norms, grads)]
        self.opt.update(self.params, grads)
        return float(value.detach())
