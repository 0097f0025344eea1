"""qwen2-7b [dense] — GQA with QKV bias. [arXiv:2407.10671]

28L, d_model 3584, 28H (GQA kv=4, head_dim 128), d_ff 18944, vocab 152064.
The port's copy of the reference's config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    layers=tuple(LayerSpec(kind="attn") for _ in range(28)),
    qkv_bias=True,
    source="arXiv:2407.10671",
)
