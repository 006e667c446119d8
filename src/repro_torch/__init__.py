"""PyTorch/CUDA port of the ScalaBFS reproduction (batched MS-BFS on one GPU).

The package mirrors the layout of the JAX package ``repro`` so that each
module's counterpart is easy to find, and imports neither JAX nor ``repro``.
Entry points take ``device=None``, which means the CUDA card; pass
``device="cpu"`` to run the plain PyTorch bodies (what the CPU tests do).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
