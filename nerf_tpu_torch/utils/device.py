"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no CUDA device is
present: a run that asked for the card never falls back to the CPU. Callers
that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """Float32 products in true float32. The plain versions are the
    references the kernels are held against, so they must not round matmul
    inputs to TF32's 10-bit mantissa (PyTorch's defaults: matmul off,
    cuDNN on). Set explicitly, not relied on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_dtype(name: str) -> torch.dtype:
    """A config's ``compute_dtype`` name as a torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
