"""xlstm-125m [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517]

12L, d_model 768, 4 heads, no FFN (each block owns its projections: an
mLSTM block its up/down projection of d_inner 1536, an sLSTM block its
gated 4/3 FF of 1024 columns), vocab 50304. sLSTM at layers {3, 9}, mLSTM
elsewhere. The port's copy of the reference's config.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_SLSTM_AT = {3, 9}
_layers = tuple(
    LayerSpec(kind="slstm" if l in _SLSTM_AT else "mlstm") for l in range(12)
)

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    layers=_layers,
    xlstm_proj_factor=2.0,
    xlstm_conv=4,
    source="arXiv:2405.04517",
)
