"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + 1 shared
expert, MoE on every other layer (the text backbone of an early-fusion
multimodal model). [hf:meta-llama/Llama-4-Scout-17B-16E family]

48L, d_model 5120, 40H (GQA kv=8, head_dim 128), d_ff 8192 (per-expert and
dense), vocab 202048. Full attention. The port's copy of the reference's
config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_layers = tuple(LayerSpec(kind="attn", moe=(l % 2 == 1)) for l in range(48))

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layers=_layers,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
