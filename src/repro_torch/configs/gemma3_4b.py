"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family]

34L, d_model 2560, 8H (GQA kv=4, head_dim 256), d_ff 10240, vocab 262144.
Sliding window 1024 on local layers; every 6th layer global. qk-norm, a
non-gated tanh-gelu MLP and tied embeddings. The port's copy of the
reference's config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_WINDOW = 1024
_layers = tuple(
    LayerSpec(kind="attn", window=None if (l % 6 == 5) else _WINDOW)
    for l in range(34)
)

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    layers=_layers,
    qk_norm=True,
    activation="gelu",
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
