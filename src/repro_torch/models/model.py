"""The port's Model for decoders of attention and Mamba layers with dense
MLP or MoE sublayers, with a vision prefix or an encoder: parameter init,
the whole-prompt prefill over a dense cache, and the three paged serving
steps (the reference's ``Model.init_params``, ``init_cache``, ``prefill``,
``prefill_chunk``, ``decode_step_paged`` and ``mixed_step``), and for
stacks of mLSTM and sLSTM layers (xlstm-125m). A stack with recurrent
layers (jamba's Mamba, xLSTM) serves through whole-prompt prefill and
``decode_step_paged`` only: the chunk and mixed steps raise, as the
reference's do, since a recurrent layer would fold a chunk's pads into its
state.

A vision model (pixtral, ``frontend="vision"``) prefills ``n_patches``
precomputed patch embeddings through ``mm_proj`` ahead of the text tokens
(early fusion, not scaled by ``sqrt(d_model)``); its positions count the
prefix. An encoder-decoder (whisper) runs its bidirectional encoder over
``encoder_frames`` in the prefill (RoPE over frame positions, as the
reference's), projects the encoder's output once into each decoder layer's
cross-attention K/V (``_cross_kv``: no bias, no k-norm, no RoPE) and adds
a cross-attention sublayer after each decoder layer; the decode step reads
the per-slot cross K/V from ``state["cross_k"]`` / ``state["cross_v"]``.
The encoder's ``wo`` and ``down`` and each cross-attention's ``wo`` are
row-parallel reductions the policy compresses. The chunk and mixed steps
refuse an encoder-decoder, as the reference's do.

Parameters are a plain nested dict with the reference's tree and names
(``embed``, ``layers[i].{ln1, core.{wq, wk, wv, wo, q_norm, k_norm}, ln2,
mlp.{up, down, gate}}``, ``final_norm``, ``lm_head``) and its layouts
(linear weights ``(Fin, Fout)`` applied as ``x @ w``, biases ``b``;
``embed``/``lm_head`` ``(V, d)``; a vision model adds ``mm_proj.w (d,
d)``, an encoder-decoder ``enc_layers[i].{ln1, core, ln2, mlp}``,
``enc_norm`` and ``xattn[i].{ln, core}``). ``param_shapes`` gives the tree
a config has: q/k/v biases with ``qkv_bias``, ``q_norm``/``k_norm`` with
``qk_norm``, ``gate`` only for the gated (silu) MLP, and no ``lm_head``
with ``tie_embeddings`` (the logits then read ``embed``). A MoE layer has
``moe.{router, up, gate, down, shared0, ...}`` in place of ``mlp``: router
``(d, E)``, experts ``up`` / ``gate`` ``(E, d, d_ff)`` and ``down`` ``(E,
d_ff, d)``, and each shared expert a dense MLP's tree. A Mamba layer's
``core`` is ``{in_x, in_z: {w (d, di)}, conv_w (d_conv, di), conv_b (di,),
x_proj: {w (di, dt_rank + 2N)}, dt_proj: {w (dt_rank, di), b (di,)}, A_log
(di, N), D (di,), out_proj: {w (di, d)}}`` (the reference's names and
layouts), with the reference's deterministic ``A_log = log(1..N)``,
``dt_proj.b = log(expm1(0.01))``, ``D = 1`` and ``conv_b = 0``. An xLSTM
layer is ``{ln1, core}`` (no second sublayer): an mLSTM ``core`` is ``{up,
z: {w (d, di)}, conv_w (d_conv, di), conv_b (di,), wq, wk, wv: {w (di,
di)}, wi: {w (di, H)}, wf: {w (di, H), b (H,)}, norm: {w (di,)}, down: {w
(di, d)}}``, an sLSTM ``core`` ``{norm: {w (d,)}, wz, wi, wo: {w (d, d)},
wf: {w (d, d), b (d,)}, rz, ri, rf, ro (H, dh, dh), ff_up, ff_gate: {w (d,
4d/3)}, ff_down: {w (4d/3, d)}}``, drawn as the reference draws them:
``wf.b = 3``, ``norm = 1``, ``conv_b = 0``, ``r*`` at scale ``dh**-0.5``.

Tensor parallelism (``TPContext.tp_group`` of N ranks): ``init_params(...,
tp=(rank, N))`` keeps this rank's shard of each tensor (``shard_axis``):
``wq``, ``wk``, ``wv`` (with their biases), ``gate`` and ``up`` by output
columns (the last axis), ``wo`` and ``down`` by input rows (the
second-to-last axis: an expert tensor keeps every expert and splits its
``d_ff``); a Mamba layer by ``d_inner`` as the reference's ``mamba_specs``
(``in_x``, ``in_z``, ``conv_w``, ``conv_b``, ``dt_proj``, ``D`` on the last
axis, ``x_proj``, ``out_proj`` and ``A_log`` by rows); norms, the router,
``embed`` and ``lm_head`` replicated, so every rank computes the full
logits, the same bits on every rank, with no float collective. An
encoder's layers and each cross-attention's ``core`` shard as a decoder
layer's (the rank's heads; ``enc_norm`` and each ``xattn[i].ln``
replicated), and a vision model's ``mm_proj`` by output columns (the
reference's ``P(d, model)``): the prefix is each rank's columns,
all-gathered densely (``collectives.rank_all_gather``) before the text.
An xLSTM layer shards as the reference's ``mlstm_specs`` / ``slstm_specs``
(``shard_axis`` with the block's kind: the names collide with attention's):
an mLSTM block's ``up``, ``z``, ``conv_w``, ``conv_b`` and ``norm`` by
``d_inner`` and its ``wq``, ``wk``, ``wv``, ``wi``, ``wf.w`` and ``down``
by input rows; an sLSTM block whole but its FF (``ff_up``, ``ff_gate`` by
columns, ``ff_down`` by rows). On a data group of dp ranks
(``init_params(..., dp=(r, dp))``) a MoE's ``up``, ``gate`` and ``down``
keep data rank r's ``E / dp`` experts when dp divides E (``expert_range``;
every expert otherwise); every other leaf is whole on each data rank. The
steps then run on the rank-local config (``local_cfg``,
``ModelConfig.tp_shard``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import copy_to_group, rank_all_gather
from repro_torch.core.tp import TPContext, column_linear
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    KVCache, attention, paged_attention_chunk, paged_attention_decode, paged_attention_mixed,
)
from repro_torch.models.common import Initializer, embed, int_scalar, rms_norm, unembed
from repro_torch.models.mlp import mlp
from repro_torch.models.transformer import (
    add_aux, apply_layer, apply_stack, feed_forward, init_layer_cache,
)

__all__ = ["Model", "AUX_WEIGHTS", "torch_dtype", "param_shapes", "shard_axis", "shard_leaf", "expert_range",
           "is_expert_leaf",
           "layer_block", "recurrent_layer", "check_supported", "XLSTM_KINDS"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

AUX_WEIGHTS = {"load_balance": 1e-2, "router_z": 1e-3}   # the reference's, model.py:31


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


XLSTM_KINDS = ("mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise on anything but a decoder of attention and Mamba layers with an
    RMSNorm and, per layer, a SwiGLU or gelu MLP or a MoE of top-k routed
    experts, with a vision prefix, or an encoder (with its audio frontend);
    or a text decoder of mLSTM and sLSTM layers only, with an RMSNorm and
    ``d_ff = 0`` (its blocks own their projections)."""
    if any(s.kind in XLSTM_KINDS for s in cfg.layers):
        if (any(s.kind not in XLSTM_KINDS or s.moe for s in cfg.layers) or cfg.d_ff
                or cfg.encoder_decoder or cfg.frontend is not None or cfg.norm != "rmsnorm"):
            raise NotImplementedError(
                f"{cfg.name}: the port serves xLSTM layers in a text decoder of mLSTM and "
                f"sLSTM layers only, with an RMSNorm and d_ff=0")
        return
    bad = [s for s in cfg.layers if s.kind not in ("attn", "mamba")]
    moe_ok = not any(s.moe for s in cfg.layers) or 0 < cfg.top_k <= cfg.n_experts
    front_ok = cfg.frontend == ("audio" if cfg.encoder_decoder else None) or (
        cfg.frontend == "vision" and not cfg.encoder_decoder)
    if (bad or not moe_ok or not front_ok or cfg.norm != "rmsnorm"
            or cfg.activation not in ("silu", "gelu") or cfg.d_ff <= 0):
        raise NotImplementedError(
            f"{cfg.name}: the port serves decoders of attention and Mamba layers with "
            f"an RMSNorm and a SwiGLU or gelu MLP or a top-k MoE, with a vision prefix "
            f"or an audio encoder, or of xLSTM layers only")


def recurrent_layer(cfg: ModelConfig) -> Optional[Tuple[int, str]]:
    """(index, kind) of the first non-attention layer of ``cfg``, or None
    for a pure-attention stack."""
    return next(((i, sp.kind) for i, sp in enumerate(cfg.layers) if sp.kind != "attn"), None)


_NORMS = ("ln1", "ln2", "ln", "final_norm", "enc_norm", "q_norm", "k_norm", "norm")


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``cfg``, with each leaf's shape (what
    ``Model.init_params`` draws and ``convert.params_from_numpy`` checks);
    a rank's shapes on a TP group's rank-local config."""
    d, ff = cfg.d_model, cfg.d_ff

    def linear(fin, fout, bias=False):
        return {"w": (fin, fout), **({"b": (fout,)} if bias else {})}

    def attention():
        core = {"wq": linear(d, cfg.q_dim, cfg.qkv_bias),
                "wk": linear(d, cfg.kv_dim, cfg.qkv_bias),
                "wv": linear(d, cfg.kv_dim, cfg.qkv_bias),
                "wo": linear(cfg.q_dim, d)}
        if cfg.qk_norm:
            core["q_norm"] = {"w": (cfg.head_dim,)}
            core["k_norm"] = {"w": (cfg.head_dim,)}
        return core

    def mamba():
        di, N, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank
        return {"in_x": linear(d, di), "in_z": linear(d, di),
                "conv_w": (cfg.ssm_d_conv, di), "conv_b": (di,),
                "x_proj": linear(di, dtr + 2 * N), "dt_proj": linear(dtr, di, True),
                "A_log": (di, N), "D": (di,), "out_proj": linear(di, d)}

    def mlstm_core():
        # a rank's d_inner rows of wq / wk / wv / wi / wf reach every head:
        # their outputs stay whole (int(pf * d_model) and n_heads, whole on a rank)
        di, DI, H = cfg.mlstm_d_inner, int(cfg.xlstm_proj_factor * d), cfg.n_heads
        return {"up": linear(d, di), "z": linear(d, di), "conv_w": (cfg.xlstm_conv, di),
                "conv_b": (di,), "wq": linear(di, DI), "wk": linear(di, DI),
                "wv": linear(di, DI), "wi": linear(di, H), "wf": linear(di, H, True),
                "norm": {"w": (di,)}, "down": linear(di, d)}

    def slstm_core():
        dh = d // cfg.n_heads
        core = {"norm": {"w": (d,)}}
        for g in ("z", "i", "f", "o"):
            core[f"w{g}"] = linear(d, d, g == "f")
            core[f"r{g}"] = (cfg.n_heads, dh, dh)
        core.update(ff_up=linear(d, cfg.slstm_ff), ff_gate=linear(d, cfg.slstm_ff),
                    ff_down=linear(cfg.slstm_ff, d))
        return core

    def layer(spec):
        if spec.kind in XLSTM_KINDS:
            return {"ln1": {"w": (d,)},
                    "core": mlstm_core() if spec.kind == "mlstm" else slstm_core()}
        core = attention() if spec.kind == "attn" else mamba()
        return {"ln1": {"w": (d,)}, "core": core, "ln2": {"w": (d,)},
                **({"moe": moe()} if spec.moe else {"mlp": mlp()})}

    def mlp():
        mlp_p = {"up": linear(d, ff), "down": linear(ff, d)}
        if cfg.activation == "silu":  # gated
            mlp_p["gate"] = linear(d, ff)
        return mlp_p

    def moe():
        E, El = cfg.n_experts, cfg.local_experts
        p = {"router": {"w": (d, E)}, "up": {"w": (El, d, ff)}, "gate": {"w": (El, d, ff)},
             "down": {"w": (El, ff, d)}}
        p.update({f"shared{i}": mlp() for i in range(cfg.n_shared_experts)})
        return p

    tree: Dict[str, Any] = {"embed": {"w": (cfg.vocab_size, d)},
                            "layers": [layer(spec) for spec in cfg.layers],
                            "final_norm": {"w": (d,)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (cfg.vocab_size, d)}
    if cfg.frontend == "vision":
        tree["mm_proj"] = linear(d, cfg.mm_proj_cols)
    if cfg.encoder_decoder:
        tree["enc_layers"] = [{"ln1": {"w": (d,)}, "core": attention(), "ln2": {"w": (d,)},
                               "mlp": mlp()} for _ in range(cfg.n_encoder_layers)]
        tree["enc_norm"] = {"w": (d,)}
        tree["xattn"] = [{"ln": {"w": (d,)}, "core": attention()} for _ in cfg.layers]
    return tree


# column-parallel: sharded by outputs (Mamba's in_x, in_z, dt_proj by d_inner;
# a vision model's mm_proj by d_model)
_COLUMNS = ("wq", "wk", "wv", "gate", "up", "in_x", "in_z", "dt_proj", "mm_proj")
# row-parallel: sharded by inputs (Mamba's x_proj and out_proj by d_inner)
_ROWS = ("wo", "down", "x_proj", "out_proj")
# the Mamba leaves directly under ``core``, by d_inner (the reference's mamba_specs)
_MAMBA_LEAVES = {"conv_w": -1, "conv_b": -1, "D": -1, "A_log": -2}
# an xLSTM layer's sharded leaves by (parent, key) (the reference's
# mlstm_specs / slstm_specs); every other leaf of such a layer is whole
_XLSTM_AXES = {
    "mlstm": {("up", "w"): -1, ("z", "w"): -1, ("core", "conv_w"): -1,
              ("core", "conv_b"): -1, ("norm", "w"): -1, ("wq", "w"): -2, ("wk", "w"): -2,
              ("wv", "w"): -2, ("wi", "w"): -2, ("wf", "w"): -2, ("down", "w"): -2},
    "slstm": {("ff_up", "w"): -1, ("ff_gate", "w"): -1, ("ff_down", "w"): -2},
}


def shard_axis(parent: str, key: str, block: Optional[str] = None) -> Optional[int]:
    """The axis a TP group shards the leaf ``key`` of ``parent`` along
    (``-1`` output columns, ``-2`` input rows: axis 0 of a ``(Fin, Fout)``
    weight, the ``d_ff`` axis of an expert ``down`` ``(E, d_ff, d)``, the
    ``d_inner`` rows of ``A_log``), or None (replicated). Inside an xLSTM
    layer ``block`` is its kind (``"mlstm"`` / ``"slstm"``), whose names
    shard otherwise than attention's (``wq`` by rows, ``wo`` whole)."""
    if block in _XLSTM_AXES:
        return _XLSTM_AXES[block].get((parent, key))
    if parent in _COLUMNS and key in ("w", "b"):
        return -1
    if parent in _ROWS and key == "w":
        return -2
    if parent == "core":
        return _MAMBA_LEAVES.get(key)
    return None


def layer_block(cfg: ModelConfig, key: str, index: int, block: Optional[str]) -> Optional[str]:
    """The ``block`` a tree walk passes on into entry ``index`` of the list
    ``key``: an xLSTM layer's kind for ``layers[index]``, else ``block``."""
    if key == "layers" and cfg.layers[index].kind in _XLSTM_AXES:
        return cfg.layers[index].kind
    return block


def expert_range(cfg: ModelConfig, dp_rank: int, dp: int) -> Tuple[int, int]:
    """The routed experts ``[first, last)`` data rank ``dp_rank`` of ``dp``
    holds: ``n_experts / dp`` of them in order when ``dp`` divides them (the
    reference's expert-parallel ``moe_specs``), else every expert."""
    El = cfg.tp_shard(1, dp).local_experts
    first = dp_rank * El if El < cfg.n_experts else 0
    return first, first + El


def is_expert_leaf(parent: str, key: str, ndim: int) -> bool:
    """Whether a leaf is a routed-expert tensor (``up``, ``gate``, ``down``
    of a MoE, ``(E, ...)``), which a data rank holds its experts of."""
    return ndim == 3 and parent in ("up", "gate", "down") and key == "w"


def shard_leaf(t, parent: str, key: str, rank: int, n: int, block: Optional[str] = None):
    """Rank ``rank``'s contiguous ``1/n`` of a leaf (a tensor or numpy
    array) along ``shard_axis``; the leaf itself when replicated."""
    axis = shard_axis(parent, key, block)
    if axis is None or n == 1:
        return t
    size = t.shape[axis] // n
    index = [slice(None)] * len(t.shape)
    index[axis] = slice(rank * size, (rank + 1) * size)
    return t[tuple(index)]


class Model:
    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device: str | torch.device = "cuda", *, seed: int = 0,
                    tp: Tuple[int, int] = (0, 1),
                    dp: Tuple[int, int] = (0, 1)) -> Dict[str, Any]:
        """Random weights from ``generator`` (default: a fresh generator on
        ``device`` seeded with ``seed``), drawn on ``device`` in the config's
        dtype. Runs on the card unless ``device="cpu"``. With ``tp=(rank,
        n)`` every tensor is drawn in the single-rank order from the same
        generator and only this rank's shard is kept (``shard_leaf``), so the
        n ranks' trees put together are the single-rank tree; a rank holds
        no more than its shard plus the tensor being drawn. A 3-D expert
        tensor is drawn one expert at a time (its fp32 transient is one
        expert's, not the whole tensor's: 21.5 GB for llama4-maverick's
        ``up``)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        cfg = self.cfg
        rank, n = tp
        cfg.tp_shard(n)   # raises when the config does not shard over n ranks
        lo, hi = expert_range(cfg, *dp)
        init = Initializer(generator, torch_dtype(cfg.dtype), dev)

        def draw(node, key, parent, block=None):
            # linear weights (the embedding scaled by d_model**-0.5), zero
            # biases and unit norms, drawn in the tree's order
            if isinstance(node, dict):
                return {k: draw(v, k, key, block) for k, v in node.items()}
            if isinstance(node, list):
                return [draw(v, key, parent, layer_block(cfg, key, i, block))
                        for i, v in enumerate(node)]
            if block == "slstm" and key[0] == "r":   # recurrent (H, dh, dh) at dh**-0.5
                t = init.linear(node, scale=node[-1]**-0.5)
            elif len(node) == 3:   # experts: each drawn (and sharded) in turn, in place
                experts = None
                for e in range(node[0]):
                    t = draw(node[1:], key, parent)
                    if not lo <= e < hi:   # another data rank's expert
                        continue
                    if experts is None:
                        experts = t.new_empty((hi - lo, *t.shape))
                    experts[e - lo] = t
                return experts
            elif block is not None and parent == "wf" and key == "b":   # forget bias
                t = init.full(node, 3.0)
            elif parent == "dt_proj" and key == "b":
                t = init.full(node, math.log(math.expm1(0.01)))
            elif key == "A_log":   # log(1..N) on every channel
                t = init.full(node, 1.0).cumsum(-1, dtype=torch.float32).log().to(init.dtype)
            elif key in ("b", "conv_b"):
                t = init.zeros(node)
            elif parent in _NORMS or key == "D":
                t = init.ones(node)
            else:
                t = init.linear(node, scale=cfg.d_model**-0.5 if parent == "embed" else None)
            if shard_axis(parent, key, block) is None or n == 1:
                return t
            return shard_leaf(t, parent, key, rank, n, block).clone()

        return draw(param_shapes(cfg), "", "")

    def local_cfg(self, ctx: TPContext) -> ModelConfig:
        """The config this process computes with: the rank-local view on a
        TP group and a data group (``ModelConfig.tp_shard``), else the
        config itself."""
        return self.cfg.tp_shard(ctx.tp_size, ctx.dp_size)

    # ----------------------------------------------------------------- train

    def loss(self, ctx: TPContext, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's ``Model.loss``: next-token cross-entropy of
        ``batch["targets"]`` (B, S) over fp32 logits (``logsumexp`` minus
        the target's logit, mean over every position), plus each MoE aux
        loss weighted by ``AUX_WEIGHTS`` over ``n_layers``. Returns (loss,
        metrics ``{"ce", aux losses..., "loss"}``), 0-d tensors. A vision
        model takes its loss on the text positions only (after
        ``n_patches``); an encoder-decoder runs the encoder over
        ``batch["encoder_frames"]`` and each decoder layer, then its
        cross-attention (the reference's ``_encdec_decoder``). The stack is
        recomputed in backward under ``ctx.remat`` (not the encoder's, nor
        an encoder-decoder's decoder: the reference's ``_encdec_decoder``
        calls its layers directly). On a TP group every rank computes the
        same loss; in backward the collectives' own gradients and
        ``copy_to_group`` make every rank's gradient of a replicated leaf
        the whole model's, and of a sharded leaf its shard's."""
        cfg = self.local_cfg(ctx)
        x = self._embed_inputs(ctx, params, batch)
        if cfg.encoder_decoder:
            cross = self._cross_kv(ctx, params, self._encode(ctx, params,
                                                             batch["encoder_frames"]))
            aux: Dict[str, torch.Tensor] = {}
            for i, spec in enumerate(cfg.layers):
                x, _, losses = apply_layer(ctx, cfg, spec, params["layers"][i], x, pos=0,
                                           aux=True)
                x = self._cross(ctx, cfg, params["xattn"][i], x, cross[i])
                add_aux(aux, losses)
        else:
            x, _, aux = apply_stack(ctx, cfg, params["layers"], x, pos=0, aux=True)
        x = rms_norm(x, params["final_norm"]["w"])
        if cfg.frontend == "vision":
            x = x[:, cfg.n_patches:]   # loss on text positions only
        head = params.get("lm_head", params["embed"])["w"]
        logits = unembed(ctx, x, head).float()
        tgt = logits.gather(-1, batch["targets"].long()[..., None])[..., 0]
        ce = torch.mean(torch.logsumexp(logits, dim=-1) - tgt)
        total = ce
        metrics = {"ce": ce}
        for k, v in aux.items():
            total = total + AUX_WEIGHTS.get(k, 0.0) * v / max(1, cfg.n_layers)
            metrics[k] = v
        metrics["loss"] = total
        return total, metrics

    # ----------------------------------------------------------------- serve

    def _embed(self, ctx: TPContext, params, tokens: torch.Tensor) -> torch.Tensor:
        x = embed(ctx, params["embed"]["w"], tokens)
        return x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)

    def _embed_inputs(self, ctx: TPContext, params, batch) -> torch.Tensor:
        """The token embeddings of ``batch["tokens"]``, after the projected
        ``patch_embeds`` of a vision model when the batch has them (early
        fusion: ``patch_embeds @ mm_proj``, unscaled, ahead of the text). On
        a TP group each rank projects onto its columns of ``mm_proj`` and
        one dense all-gather makes the prefix whole on every rank."""
        x = self._embed(ctx, params, batch["tokens"])
        if self.cfg.frontend == "vision" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            pe = column_linear(ctx, copy_to_group(pe, ctx.tp_group), params["mm_proj"]["w"])
            if ctx.tp_group is not None:
                pe = rank_all_gather(pe, ctx.tp_group)
            x = torch.cat([pe, x], dim=1)
        return x

    def _encode(self, ctx: TPContext, params, frames: torch.Tensor) -> torch.Tensor:
        """The bidirectional encoder over ``frames`` (B, F, d_model): each
        layer pre-norm attention (RoPE at frame positions 0..F-1, no causal
        mask) and MLP, then ``enc_norm``."""
        cfg = self.local_cfg(ctx)
        x = frames
        for lp in params["enc_layers"]:
            h = rms_norm(x, lp["ln1"]["w"])
            x = x + attention(ctx, lp["core"], h, cfg, pos=0, causal=False)[0]
            h = rms_norm(x, lp["ln2"]["w"])
            x = x + mlp(ctx, lp["mlp"], h, cfg)
        return rms_norm(x, params["enc_norm"]["w"])

    def _cross_kv(self, ctx: TPContext, params, enc_out: torch.Tensor):
        """Each decoder layer's cross-attention K/V, flat (B, F, kv_dim), from
        the encoder's output (no bias, no k-norm, no RoPE: the reference's);
        on a TP group the rank's kv heads, from its columns of ``wk`` /
        ``wv``."""
        enc_out = copy_to_group(enc_out, ctx.tp_group)   # training: read by the rank's heads
        return [KVCache(k=torch.matmul(enc_out, xp["core"]["wk"]["w"].to(enc_out.dtype)),
                        v=torch.matmul(enc_out, xp["core"]["wv"]["w"].to(enc_out.dtype)))
                for xp in params["xattn"]]

    @staticmethod
    def _cross(ctx: TPContext, cfg: ModelConfig, xp, x: torch.Tensor, kv: KVCache
               ) -> torch.Tensor:
        """x plus the cross-attention sublayer ``xp`` over the encoder's K/V."""
        h = rms_norm(x, xp["ln"]["w"])
        return x + attention(ctx, xp["core"], h, cfg, pos=0, cross_kv=kv)[0]

    def _logits(self, ctx: TPContext, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm + unembed of x (N, 1, d_model) -> logits (N, V)."""
        x = rms_norm(x, params["final_norm"]["w"])
        head = params.get("lm_head", params["embed"])["w"]
        return unembed(ctx, x, head)[:, 0]

    def _paged_layers(self, ctx: TPContext, params, x: torch.Tensor, state,
                      attend: Callable) -> Tuple[torch.Tensor, Any]:
        """Every layer over ``state``: on an attention layer ``attend(cfg,
        core params, h, pool_k, pool_v, window)`` is the step's paged
        attention over the layer's pools (``cfg`` the rank-local config,
        ``window`` the layer's own ``LayerSpec.window``) and returns (out,
        pool_k, pool_v), then the layer's MLP or MoE (``feed_forward``); a
        recurrent layer (decode only: the chunk and mixed steps refuse such
        stacks first) is the dense layer's one-token step on its slot-batched
        cache ``state["rec"]``, as the reference's decode step runs it. An
        encoder-decoder (decode only, likewise) adds each layer's
        cross-attention over the slots' encoder K/V (``state["cross_k"]`` /
        ``state["cross_v"]``) after the layer. Pools and recurrent caches
        update in place (a captured step writes the engine's state). Returns
        (x, state)."""
        pools_k, pools_v = list(state["pools_k"]), list(state["pools_v"])
        rec = state.get("rec", [])
        cfg = self.local_cfg(ctx)
        ai = ri = 0
        for i, spec in enumerate(cfg.layers):
            lp = params["layers"][i]
            if spec.kind != "attn":
                x, new = apply_layer(ctx, cfg, spec, lp, x, pos=0, cache=rec[ri], decode=True)
                for held, t in zip(rec[ri], new):
                    held.copy_(t)
                ri += 1
            else:
                h = rms_norm(x, lp["ln1"]["w"])
                out, pools_k[ai], pools_v[ai] = attend(cfg, lp["core"], h, pools_k[ai],
                                                       pools_v[ai], spec.window)
                ai += 1
                x = x + out
                h = rms_norm(x, lp["ln2"]["w"])
                x = x + feed_forward(ctx, cfg, spec, lp, h)
            if cfg.encoder_decoder:
                x = self._cross(ctx, cfg, params["xattn"][i], x,
                                KVCache(k=state["cross_k"][i], v=state["cross_v"][i]))
        return x, {**state, "pools_k": pools_k, "pools_v": pools_v}

    def _attention_only(self, step: str, then: str) -> None:
        """The reference's refusals in the chunk and mixed steps: an
        encoder-decoder (the step threads no encoder state) and a recurrent
        stack (its pads would fold into the recurrent state)."""
        if self.cfg.encoder_decoder:
            raise ValueError(f"{step} does not thread encoder cross-attention; "
                             f"encoder-decoder models use {then}")
        bad = recurrent_layer(self.cfg)
        if bad is not None:
            raise ValueError(f"{step} requires a pure-attention stack; layer {bad[0]} is "
                             f"{bad[1]!r} (use {then})")

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda", ctx: Optional[TPContext] = None
                   ) -> Dict[str, Any]:
        """Dense per-layer caches for whole-prompt prefill: K/V in ``dtype``
        for attention, a fp32 ``MambaCache``, ``MLSTMCache`` or
        ``SLSTMCache`` for a recurrent layer (this rank's kv heads, channels
        and mLSTM heads on a TP group ``ctx``)."""
        cfg = self.local_cfg(ctx) if ctx is not None else self.cfg
        return {"layers": [init_layer_cache(cfg, spec, batch, max_len, dtype, device)
                           for spec in cfg.layers],
                "pos": 0}

    def prefill(self, ctx: TPContext, params, batch, cache, *,
                last_index=None) -> Tuple[torch.Tensor, Any]:
        """Whole-prompt prefill of ``batch["tokens"]`` (B, S) into ``cache``
        (K/V written in place; a recurrent layer's cache is its history and
        comes back as new tensors after the prompt); returns (logits (B, V)
        at ``last_index``, the last position by default, and the cache). The
        engine right-pads prompts of a pure-attention stack to a length
        bucket and passes the last real token's index (causal masking hides
        the pads; a recurrent stack prefills at the exact length), an int or
        a 0-d int32 tensor on the tokens' device (the row is picked on the
        device, so the call holds no host value of it).

        A vision model's ``batch["patch_embeds"]`` (B, n_patches, d_model)
        come first (``cache`` holds ``n_patches + S`` positions and
        ``last_index`` counts them). An encoder-decoder's
        ``batch["encoder_frames"]`` (B, F, d_model) go through the encoder,
        whose per-layer cross K/V the decoder attends after each layer and
        the cache returns as ``"cross"``."""
        cfg = self.local_cfg(ctx)
        x = self._embed_inputs(ctx, params, batch)
        if cfg.encoder_decoder:
            cross = self._cross_kv(ctx, params, self._encode(ctx, params,
                                                             batch["encoder_frames"]))
            layer_caches = []
            for i, spec in enumerate(cfg.layers):
                x, c = apply_layer(ctx, cfg, spec, params["layers"][i], x, pos=0,
                                   cache=cache["layers"][i])
                layer_caches.append(c)
                x = self._cross(ctx, cfg, params["xattn"][i], x, cross[i])
        else:
            x, layer_caches = apply_stack(ctx, cfg, params["layers"], x, pos=0,
                                          caches=cache["layers"])
        i = int_scalar(x.shape[1] - 1 if last_index is None else last_index, x.device)
        logits = self._logits(ctx, params, x.index_select(1, i.reshape(1)))
        prompt_len = batch["tokens"].shape[1] + (cfg.n_patches if cfg.frontend == "vision"
                                                 else 0)
        out = {"layers": layer_caches, "pos": prompt_len}
        if cfg.encoder_decoder:
            out["cross"] = cross
        return logits, out

    def prefill_chunk(self, ctx: TPContext, params, tokens, state, table_row, start,
                      n_valid, cache_spec=None) -> Tuple[torch.Tensor, Any]:
        """Chunked prefill of ONE slot: tokens (1, C) int32, right-padded
        after ``n_valid`` real tokens; table_row (max_blocks,) int32 the
        slot's blocks; ``start`` the position of tokens[0, 0]. ``start`` and
        ``n_valid`` are ints or 0-d int32 tensors on the tokens' device. Each
        layer attends the slot's paged history plus the chunk, then appends
        the chunk's K/V to the pools (in place). Returns (logits (1, V) at
        chunk index ``n_valid - 1``, state). A recurrent stack raises (the
        reference's ``ValueError``), and so does an encoder-decoder."""
        self._attention_only("prefill_chunk", "whole-prompt prefill")
        x = self._embed(ctx, params, tokens)
        x, state = self._paged_layers(
            ctx, params, x, state, lambda cfg, p, h, pk, pv, window: paged_attention_chunk(
                ctx, p, h, cfg, start=start, table_row=table_row, pool_k=pk,
                pool_v=pv, window=window, cache_spec=cache_spec))
        last = int_scalar(n_valid, x.device) - 1
        return self._logits(ctx, params, x.index_select(1, last.reshape(1))), state

    def decode_step_paged(self, ctx: TPContext, params, tokens, state, tables, lengths,
                          cache_spec=None) -> Tuple[torch.Tensor, Any]:
        """Batched decode of every slot: tokens (B, 1) int32, tables (B,
        max_blocks) int32, lengths (B,) int32 per-slot write positions.
        Returns (logits (B, V), state); the pools, and the slot-batched
        recurrent caches ``state["rec"]`` of a recurrent stack, update in
        place. An encoder-decoder's state holds each slot's cross K/V
        (``init_paged_state``), which each layer's cross-attention reads."""
        x = self._embed(ctx, params, tokens)
        x, state = self._paged_layers(
            ctx, params, x, state, lambda cfg, p, h, pk, pv, window: paged_attention_decode(
                ctx, p, h, cfg, lengths=lengths, pool_k=pk, pool_v=pv,
                tables=tables, window=window, cache_spec=cache_spec))
        return self._logits(ctx, params, x), state

    def mixed_step(self, ctx: TPContext, params, tokens, state, slot_ids, positions,
                   valid, is_decode, slot_starts, tables, sample_idx,
                   cache_spec=None) -> Tuple[torch.Tensor, Any]:
        """One unified mixed-batch token-budget step (see the reference's
        ``Model.mixed_step``): tokens (1, T) int32 right-padded; slot_ids /
        positions / valid / is_decode (T,); slot_starts (n_slots,);
        tables (n_slots, max_blocks); sample_idx (n_slots,) — the flat index
        each slot samples from. Appends every real token's K/V to the pools
        of ``state`` (in place) and returns (logits (n_slots, V), state). A
        recurrent stack raises (the reference's ``ValueError``), and so does
        an encoder-decoder."""
        self._attention_only("mixed_step", "whole-prompt prefill + decode_step_paged")
        x = self._embed(ctx, params, tokens)
        x, state = self._paged_layers(
            ctx, params, x, state, lambda cfg, p, h, pk, pv, window: paged_attention_mixed(
                ctx, p, h, cfg, positions=positions, slot_ids=slot_ids,
                slot_starts=slot_starts, valid=valid, is_decode=is_decode,
                tables=tables, pool_k=pk, pool_v=pv, window=window,
                cache_spec=cache_spec))
        # logits only at each slot's sampled token (norm + unembed stay
        # O(n_slots), not O(token_budget))
        return self._logits(ctx, params, x[0][sample_idx.long()][:, None]), state
