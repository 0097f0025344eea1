"""Architecture registry of the port: the dense pure-attention archs ported so
far. ``get_config(arch_id)`` / ``ARCHS`` mirror the reference's API."""
from __future__ import annotations

from repro_torch.configs.base import LayerSpec, ModelConfig, reduced_config
from repro_torch.configs.internlm2_1_8b import CONFIG as internlm2_1_8b
from repro_torch.configs.llama2 import LLAMA2_7B, LLAMA2_13B, LLAMA2_70B

ARCHS = {
    "internlm2-1.8b": internlm2_1_8b,
    "llama2-7b": LLAMA2_7B,
    "llama2-13b": LLAMA2_13B,
    "llama2-70b": LLAMA2_70B,
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet; the port knows "
            f"{', '.join(sorted(ARCHS))}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "get_config", "ModelConfig", "LayerSpec", "reduced_config"]
