"""The benchmark's plain reference of both NeRF variants.

Plain PyTorch on float32 tensors, TF32 off, each product's operands rounded
as the configuration states (``nerf.rounding_of``), no kernel and nothing of
the port: the network
(``nerf.py``), the renders the engines run (``render.py``: uniform and
hierarchical frames, the accel engine's grid and depths), the compressed
engine's pruning and quantization (``quant.py``) and the trainer's step and
optimizer (``train.py``). Where the port's arithmetic is copied, the copy is
frozen here, so a later change to the port cannot move the yardstick.
"""
