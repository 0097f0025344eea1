"""Llama 2 family — the paper's own TTFT profiling models (Table 3).
[arXiv:2307.09288]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def _llama2(name, n_layers, d_model, n_heads, n_kv, d_ff):
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=d_ff,
        vocab_size=32000,
        layers=tuple(LayerSpec(kind="attn") for _ in range(n_layers)),
        rope_theta=1e4,
        source="arXiv:2307.09288",
    )


LLAMA2_7B = _llama2("llama2-7b", 32, 4096, 32, 32, 11008)
LLAMA2_13B = _llama2("llama2-13b", 40, 5120, 40, 40, 13824)
LLAMA2_70B = _llama2("llama2-70b", 80, 8192, 64, 8, 28672)
