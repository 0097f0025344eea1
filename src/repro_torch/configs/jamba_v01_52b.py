"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE every
other layer (16 experts, top-2). [arXiv:2403.19887]

32L, d_model 4096, 32H (GQA kv=8, head_dim 128), d_ff 14336, vocab 65536,
Mamba d_state 16, d_conv 4, expand 2 (d_inner 8192, dt_rank 256).
Attention at layer index l % 8 == 4 (1 attention layer in each block of 8);
MoE on odd layers. The port's copy of the reference's config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_layers = tuple(
    LayerSpec(kind="attn" if l % 8 == 4 else "mamba", moe=(l % 2 == 1))
    for l in range(32)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    layers=_layers,
    n_experts=16,
    top_k=2,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    source="arXiv:2403.19887",
)
