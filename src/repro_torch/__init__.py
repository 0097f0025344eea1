"""PyTorch + CUDA port of the compressed tensor-parallel serving system.

Mirrors the JAX package's layout (``configs/``, ``core/``, ``kernels/``,
``models/``, ``serving/``, ``launch/``) so each module's counterpart is found
by name. The port imports ``torch``, numpy and the standard library only.
Entry points default to ``device="cuda"`` and raise without a GPU; pass
``device="cpu"`` to run on the CPU, where every hand-written kernel's plain
PyTorch version stands in for it.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
