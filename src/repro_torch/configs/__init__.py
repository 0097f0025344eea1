"""Architecture registry of the port: the archs ported so far, dense
(llama2, internlm2, qwen2, qwen3, gemma3), MoE (mixtral-8x22b,
llama4-maverick-400b-a17b), the Mamba + MoE hybrid jamba-v0.1-52b, the
vision-prefix decoder pixtral-12b, the encoder-decoder whisper-medium and
the recurrent xlstm-125m (mLSTM + sLSTM).
``get_config(arch_id)`` / ``ARCHS`` mirror the reference's API."""
from __future__ import annotations

from repro_torch.configs.base import (
    LayerSpec, ModelConfig, RankConfig, first_layers, reduced_config,
)
from repro_torch.configs.gemma3_4b import CONFIG as gemma3_4b
from repro_torch.configs.internlm2_1_8b import CONFIG as internlm2_1_8b
from repro_torch.configs.jamba_v01_52b import CONFIG as jamba_v01_52b
from repro_torch.configs.llama2 import LLAMA2_7B, LLAMA2_13B, LLAMA2_70B
from repro_torch.configs.llama4_maverick import CONFIG as llama4_maverick
from repro_torch.configs.mixtral_8x22b import CONFIG as mixtral_8x22b
from repro_torch.configs.pixtral_12b import CONFIG as pixtral_12b
from repro_torch.configs.qwen2_7b import CONFIG as qwen2_7b
from repro_torch.configs.qwen3_32b import CONFIG as qwen3_32b
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.xlstm_125m import CONFIG as xlstm_125m

ARCHS = {
    "internlm2-1.8b": internlm2_1_8b,
    "llama2-7b": LLAMA2_7B,
    "llama2-13b": LLAMA2_13B,
    "llama2-70b": LLAMA2_70B,
    "qwen2-7b": qwen2_7b,
    "qwen3-32b": qwen3_32b,
    "gemma3-4b": gemma3_4b,
    "mixtral-8x22b": mixtral_8x22b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "jamba-v0.1-52b": jamba_v01_52b,
    "pixtral-12b": pixtral_12b,
    "whisper-medium": whisper_medium,
    "xlstm-125m": xlstm_125m,
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet; the port knows "
            f"{', '.join(sorted(ARCHS))}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "get_config", "ModelConfig", "RankConfig", "LayerSpec", "first_layers",
           "reduced_config"]
