"""pixtral-12b [vlm] — Pixtral-ViT vision frontend (stubbed) + Mistral-Nemo
style decoder. [hf:mistralai/Pixtral-12B-2409]

40L, d_model 5120, 32 heads (GQA kv=8, head_dim 128 per Nemo card),
d_ff 14336, vocab 131072. Each prompt opens with 256 precomputed patch
embeddings (early fusion through ``mm_proj``). The port's copy of the
reference's config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    layers=tuple(LayerSpec(kind="attn") for _ in range(40)),
    rope_theta=1e6,
    frontend="vision",
    n_patches=256,
    source="hf:mistralai/Pixtral-12B-2409",
)
