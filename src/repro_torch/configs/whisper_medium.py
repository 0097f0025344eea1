"""whisper-medium [audio] — encoder-decoder, conv/mel frontend stubbed
(precomputed frame embeddings). [arXiv:2212.04356]

24 enc + 24 dec layers, d_model 1024, 16 heads (kv=16 => MHA), d_ff 4096,
vocab 51865. GELU MLP; RMSNorm and RoPE as in every config of the
reference (which uses them uniformly). The encoder attends 1500 frames
without a causal mask; each decoder layer adds a cross-attention sublayer
over the encoder's output. The port's copy of the reference's config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    layers=tuple(LayerSpec(kind="attn") for _ in range(24)),
    activation="gelu",
    encoder_decoder=True,
    n_encoder_layers=24,
    encoder_seq=1500,
    frontend="audio",
    source="arXiv:2212.04356",
)
