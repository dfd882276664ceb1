"""PyTorch/CUDA port of nerf_tpu.

Module names follow the JAX package (``nerf_tpu``), which stays the
reference: ``models.nerf`` <-> ``nerf_tpu.models.nerf``,
``ops.render_kernel`` <-> ``nerf_tpu.ops.render_kernel`` and so on. Hand-written
CUDA kernels live in ``csrc/`` and are built at first use by ``ops._ext``.
"""
