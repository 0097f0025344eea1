"""Device selection for the port's entry points: the card by default, the
CPU only when the caller asks for it, never a silent fallback."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False: this entry point runs on an NVIDIA GPU by default; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
