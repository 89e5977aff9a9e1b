"""PyTorch/CUDA port of the ATHEENA reproduction (``src/repro``).

The layout mirrors ``repro``: ``models``/``configs`` build the backbone,
``core`` holds the early-exit stages, ``kernels`` the hand-written CUDA
kernels beside their plain versions, ``runtime`` the two-stage prefill
server and ``launch`` the serving CLI. The package imports torch and numpy
only; it never imports JAX or ``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
