"""mixtral-8x22b [moe] — 8 experts top-2 every layer, sliding-window
attention. [arXiv:2401.04088]

56L, d_model 6144, 48H (GQA kv=8, head_dim 128), d_ff 16384 (per-expert),
vocab 32768. Window 4096 on every layer. The port's copy of the reference's
config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_WINDOW = 4096
_layers = tuple(LayerSpec(kind="attn", moe=True, window=_WINDOW) for _ in range(56))

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    layers=_layers,
    n_experts=8,
    top_k=2,
    source="arXiv:2401.04088",
)
