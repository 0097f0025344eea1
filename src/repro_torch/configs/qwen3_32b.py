"""qwen3-32b [dense] — qk-norm, GQA. [hf:Qwen/Qwen3-8B family]

64L, d_model 5120, 64H (GQA kv=8, head_dim 128), d_ff 25600, vocab 151936.
The port's copy of the reference's config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    layers=tuple(LayerSpec(kind="attn") for _ in range(64)),
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)
