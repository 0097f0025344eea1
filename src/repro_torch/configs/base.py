"""Model configuration: the port's copy of ``repro.configs.base``.

``ModelConfig`` keeps every field of the reference (so configs read the same
and ``reduced_config`` shrinks them the same way); the port serves the
attention and Mamba layer kinds, with dense MLP or MoE sublayers, and the
xLSTM kinds (mLSTM, sLSTM). ``tp_shard`` returns a ``RankConfig``, which
also carries the rank-local Mamba ``d_inner``, mLSTM ``d_inner`` and heads
and sLSTM FF width (the reference derives them from ``d_model`` and
``n_heads``, which a rank of an xLSTM stack keeps whole: its sLSTM runs
every head).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["LayerSpec", "ModelConfig", "RankConfig", "first_layers", "reduced_config"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One block in the schedule."""

    kind: str = "attn"           # "attn" | "mamba" | "slstm" | "mlstm"
    moe: bool = False            # routed-experts MLP instead of dense MLP
    window: Optional[int] = None  # sliding-window width (None = global attn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layers: Tuple[LayerSpec, ...] = ()

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # SSM (Mamba)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0

    # xLSTM
    xlstm_proj_factor: float = 2.0
    xlstm_conv: int = 4

    # encoder-decoder (audio)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # multimodal early fusion (vlm)
    frontend: Optional[str] = None
    n_patches: int = 256

    # misc
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    activation: str = "silu"     # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""             # citation

    def __post_init__(self):
        if not self.layers:
            object.__setattr__(
                self, "layers", tuple(LayerSpec() for _ in range(self.n_layers))
            )
        assert len(self.layers) == self.n_layers

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def mlstm_d_inner(self) -> int:
        """An mLSTM block's inner width (its ``up`` / ``z`` columns)."""
        return int(self.xlstm_proj_factor * self.d_model)

    @property
    def mlstm_heads(self) -> int:
        """An mLSTM block's heads (``dh = mlstm_d_inner / mlstm_heads``)."""
        return self.n_heads

    @property
    def slstm_ff(self) -> int:
        """An sLSTM block's FF columns (``ff_up`` / ``ff_gate``), 4/3 d_model."""
        return int(4 * self.d_model / 3)

    @property
    def mm_proj_cols(self) -> int:
        """Output columns of a vision model's ``mm_proj`` this config
        computes: ``d_model`` (a rank's share on a TP group, ``RankConfig``)."""
        return self.d_model

    @property
    def local_experts(self) -> int:
        """Routed experts whose weights this config holds: ``n_experts``
        (a data rank's ``n_experts / dp`` on a data group, ``RankConfig``)."""
        return self.n_experts

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Parameter count (embedding + blocks + head): the leaves of the
        tree ``Model.init_params`` builds. Attention layers (q/k/v/o,
        biases) and Mamba layers (in_x, in_z, conv, x_proj, dt_proj, A_log,
        D, out_proj) as the reference counts them, and each layer's dense
        MLP or MoE (router, ``n_experts`` gated experts of ``d_ff`` columns,
        ``n_shared_experts`` shared ones); an encoder-decoder's encoder
        layers (attention, MLP, two norms) and each decoder layer's
        cross-attention, as the reference counts them. Terms the reference's
        count leaves out are counted (ROADMAP.md Queue 3 items 13 and 14):
        the dense MLP of a Mamba layer without MoE, which its ``init_layer``
        builds (``_has_mlp_sublayer``), two of a Mamba layer's three
        ``d_inner`` vectors (``conv_b``, ``dt_proj.b``, ``D``), a vision
        model's ``mm_proj`` (``d_model x d_model``), and an
        encoder-decoder's ``enc_norm`` and the norm of each cross-attention
        sublayer. An xLSTM layer is counted as the tree holds it (ROADMAP.md
        Queue 3 item 16): an mLSTM block's ``up``, ``z``, ``conv_w``,
        ``conv_b``, ``wq``/``wk``/``wv``, ``wi``, ``wf`` (with its bias),
        ``norm`` and ``down``, an sLSTM block's four gates (``wf`` with its
        bias), four recurrent ``(H, dh, dh)`` matrices, ``norm`` and its three
        FF matrices, and one norm (``ln1``: an xLSTM layer has no MLP
        sublayer), where the reference counts two FF matrices and no conv,
        gate vectors or bias. As for every family, the final norm is not
        counted."""
        d, ff = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        dense_mlp = (3 if self.activation == "silu" else 2) * d * ff if ff > 0 else 0
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for spec in self.layers:
            if spec.kind == "mlstm":
                di, H = self.mlstm_d_inner, self.mlstm_heads
                n += 2 * d * di + self.xlstm_conv * di + di          # up, z, conv
                n += 3 * di * di + 2 * di * H + H + di               # q/k/v, i/f, f bias, norm
                n += di * d + d                                      # down, ln1
                continue
            if spec.kind == "slstm":
                dh, ffs = d // self.n_heads, self.slstm_ff
                n += 4 * d * d + 4 * self.n_heads * dh * dh + d + d  # gates, r*, f bias, norm
                n += 3 * d * ffs + d                                 # ff_up/gate/down, ln1
                continue
            if spec.kind == "attn":
                n += attn
            else:
                di, N = self.ssm_d_inner, self.ssm_d_state
                n += d * 2 * di + self.ssm_d_conv * di + di          # in_x, in_z, conv
                n += di * (self.dt_rank + 2 * N)                     # x_proj
                n += self.dt_rank * di + di + di * N + di            # dt_proj, A_log, D
                n += di * d                                          # out_proj
            if spec.moe:
                n += d * self.n_experts  # router
                n += (self.n_experts + self.n_shared_experts) * 3 * d * ff
            else:
                n += dense_mlp
            n += 2 * d  # norms
        if self.frontend == "vision":
            n += d * d                                               # mm_proj
        if self.encoder_decoder:
            n += self.n_encoder_layers * (attn + dense_mlp + 2 * d)  # encoder layers
            n += d                                                   # enc_norm
            n += self.n_layers * (attn + d)                          # cross-attention + norm
        return n

    def tp_shard(self, n: int, dp: int = 1) -> "ModelConfig":
        """The rank-local view of this config on a TP group of ``n`` ranks,
        in one of ``dp`` data ranks of a ``data x model`` grid (a
        ``RankConfig``): ``n_experts / dp`` routed experts when ``dp``
        divides them (the reference's expert-parallel ``moe_specs``), else
        every expert; ``n_heads / n`` query heads, ``n_kv_heads / n``
        kv heads, ``d_ff / n`` MLP columns and ``ssm_d_inner / n`` Mamba
        channels; ``head_dim``, ``d_model``, ``dt_rank``, ``ssm_d_state``,
        the vocabulary and a vision prefix's or an encoder's fields
        (``frontend``, ``n_patches``, ``encoder_seq``, ``n_encoder_layers``)
        unchanged: an encoder layer and a cross-attention shard their heads
        and MLP columns as a decoder layer does. Rank r holds whole heads, q
        heads ``[r H/n, (r+1) H/n)`` with their kv heads ``[r KV/n, (r+1)
        KV/n)``, so q head h keeps kv head ``h // G``, and Mamba channels
        ``[r di/n, (r+1) di/n)``. An xLSTM stack (the reference's
        ``mlstm_specs`` / ``slstm_specs``) keeps ``n_heads`` whole, since its
        sLSTM blocks run every head on every rank, and shards the mLSTM
        ``d_inner`` and heads (``mlstm_d_inner / n`` channels, ``mlstm_heads
        / n`` heads: rank r's heads are its channels) and the sLSTM FF
        columns (``slstm_ff / n``). Everything sized from the config (the
        paged pools, the recurrent state, the cross K/V, the paged kernel's
        ``kv_heads``) follows. Raises unless the kv heads, (with Mamba
        layers) ``d_inner`` and (with a vision prefix, whose ``mm_proj``
        shards by output columns) ``d_model`` divide over the ranks and each
        rank's ``q_dim``, ``d_ff``, mLSTM ``d_inner`` and sLSTM FF width are
        multiples of the policies' MX block (32). With ``n = 1`` and no
        experts split over data ranks it is the config itself."""
        experts = (self.n_experts // dp if dp > 1 and self.n_experts
                   and self.n_experts % dp == 0 else self.n_experts)
        if n == 1 and experts == self.n_experts:
            return self
        block_size = 32
        q_local = self.q_dim // n if self.n_heads % n == 0 else 0
        kinds = {sp.kind for sp in self.layers}
        local = lambda width: width % n == 0 and (width // n) % block_size == 0
        bad = [why for why, ok in (
            (f"n_kv_heads={self.n_kv_heads} % {n} != 0", self.n_kv_heads % n == 0),
            (f"n_heads={self.n_heads} % {n} != 0", self.n_heads % n == 0),
            (f"the local q_dim {self.q_dim}/{n} is not a multiple of {block_size}",
             q_local and q_local % block_size == 0),
            (f"the local {'expert ' if self.n_experts else ''}d_ff {self.d_ff}/{n} is not "
             f"a multiple of {block_size}",
             local(self.d_ff)),
            (f"ssm_d_inner={self.ssm_d_inner} % {n} != 0",
             "mamba" not in kinds or self.ssm_d_inner % n == 0),
            (f"d_model={self.d_model} % {n} != 0 (mm_proj's columns)",
             self.frontend != "vision" or self.d_model % n == 0),
            (f"the local mLSTM d_inner {self.mlstm_d_inner}/{n} is not a multiple of "
             f"{block_size}", "mlstm" not in kinds or local(self.mlstm_d_inner)),
            (f"the local sLSTM FF {self.slstm_ff}/{n} is not a multiple of {block_size}",
             "slstm" not in kinds or local(self.slstm_ff)),
        ) if not ok]
        if n < 1 or bad:
            raise ValueError(f"{self.name} does not shard over {n} TP ranks: "
                             f"{'; '.join(bad) or 'n < 1'}")
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(ModelConfig)}
        heads = (dict(n_heads=self.n_heads // n, n_kv_heads=self.n_kv_heads // n)
                 if kinds.isdisjoint(("mlstm", "slstm")) else {})
        return RankConfig(**dict(fields, d_ff=self.d_ff // n, **heads),
                          ssm_d_inner_local=self.ssm_d_inner // n,
                          mm_proj_cols_local=self.d_model // n,
                          mlstm_d_inner_local=self.mlstm_d_inner // n,
                          mlstm_heads_local=self.mlstm_heads // n,
                          slstm_ff_local=self.slstm_ff // n, local_experts_n=experts)

    def active_param_count(self) -> int:
        """Params touched per token: a MoE layer counts only its ``top_k``
        routed experts and its shared ones."""
        inactive = sum((self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
                       for spec in self.layers if spec.moe)
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """A config as one rank of a TP group computes it (``tp_shard``): its
    ``ssm_d_inner`` is this rank's share of the Mamba channels, its
    ``mm_proj_cols`` this rank's columns of a vision model's ``mm_proj``,
    its ``mlstm_d_inner`` / ``mlstm_heads`` this rank's mLSTM channels and
    heads and its ``slstm_ff`` this rank's sLSTM FF columns, all of which
    the reference derives from ``d_model`` and ``n_heads`` (kept whole on a
    rank), and its ``local_experts`` the routed experts of this data rank.
    Fields of its own, so ``ModelConfig`` keeps exactly the reference's
    fields."""

    ssm_d_inner_local: int = 0
    mm_proj_cols_local: int = 0
    mlstm_d_inner_local: int = 0
    mlstm_heads_local: int = 0
    slstm_ff_local: int = 0
    local_experts_n: int = 0

    @property
    def local_experts(self) -> int:
        return self.local_experts_n

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_d_inner_local

    @property
    def mm_proj_cols(self) -> int:
        return self.mm_proj_cols_local

    @property
    def mlstm_d_inner(self) -> int:
        return self.mlstm_d_inner_local

    @property
    def mlstm_heads(self) -> int:
        return self.mlstm_heads_local

    @property
    def slstm_ff(self) -> int:
        return self.slstm_ff_local


def first_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` cut to the first ``n`` layers of its schedule at full width
    (``n`` of 0 or at least ``n_layers``: ``cfg`` itself)."""
    if n <= 0 or n >= cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=n, layers=cfg.layers[:n])


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
                   max_experts: int = 4, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family, shrunk exactly as the
    reference's ``reduced_config`` shrinks it (same schedule pattern, <= 4
    heads, head_dim 32, d_ff <= 512)."""
    kinds_needed = []
    seen = set()
    for spec in cfg.layers:
        key = (spec.kind, spec.moe, spec.window is not None)
        if key not in seen:
            seen.add(key)
            kinds_needed.append(spec)
    layers = tuple(kinds_needed[:n_layers])
    while len(layers) < n_layers:
        layers = layers + (cfg.layers[len(layers) % cfg.n_layers],)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    return dataclasses.replace(
        cfg,
        n_layers=len(layers),
        layers=tuple(
            dataclasses.replace(l, window=min(l.window, 32) if l.window else None)
            for l in layers
        ),
        d_model=min(d_model, cfg.d_model),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32,
        d_ff=min(512, cfg.d_ff) if cfg.d_ff else 0,
        vocab_size=vocab,
        n_experts=min(cfg.n_experts, max_experts) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_d_state=8,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 64),
        n_patches=min(cfg.n_patches, 16),
        ssm_dt_rank=8 if cfg.family in ("ssm", "hybrid") else 0,
    )
