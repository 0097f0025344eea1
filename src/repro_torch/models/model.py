"""The port's Model for pure-attention decoders with dense MLP or MoE
layers: parameter init, the whole-prompt prefill over a dense cache, and the
three paged serving steps (the reference's ``Model.init_params``,
``init_cache``, ``prefill``, ``prefill_chunk``, ``decode_step_paged`` and
``mixed_step``). Other families raise ``NotImplementedError``.

Parameters are a plain nested dict with the reference's tree and names
(``embed``, ``layers[i].{ln1, core.{wq, wk, wv, wo, q_norm, k_norm}, ln2,
mlp.{up, down, gate}}``, ``final_norm``, ``lm_head``) and its layouts
(linear weights ``(Fin, Fout)`` applied as ``x @ w``, biases ``b``;
``embed``/``lm_head`` ``(V, d)``). ``param_shapes`` gives the tree a config
has: q/k/v biases with ``qkv_bias``, ``q_norm``/``k_norm`` with
``qk_norm``, ``gate`` only for the gated (silu) MLP, and no ``lm_head``
with ``tie_embeddings`` (the logits then read ``embed``). A MoE layer has
``moe.{router, up, gate, down, shared0, ...}`` in place of ``mlp``: router
``(d, E)``, experts ``up`` / ``gate`` ``(E, d, d_ff)`` and ``down`` ``(E,
d_ff, d)``, and each shared expert a dense MLP's tree.

Tensor parallelism (``TPContext.tp_group`` of N ranks): ``init_params(...,
tp=(rank, N))`` keeps this rank's shard of each tensor (``shard_axis``):
``wq``, ``wk``, ``wv`` (with their biases), ``gate`` and ``up`` by output
columns (the last axis), ``wo`` and ``down`` by input rows (the
second-to-last axis: an expert tensor keeps every expert and splits its
``d_ff``); norms, the router, ``embed`` and ``lm_head`` replicated, so
every rank computes the full logits, the same bits on every rank, with no
float collective. The steps then run on the
rank-local config (``local_cfg``, ``ModelConfig.tp_shard``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tp import TPContext
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    init_cache, paged_attention_chunk, paged_attention_decode, paged_attention_mixed,
)
from repro_torch.models.common import Initializer, embed, int_scalar, rms_norm, unembed
from repro_torch.models.transformer import apply_stack, feed_forward

__all__ = ["Model", "torch_dtype", "param_shapes", "shard_axis", "shard_leaf"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise on anything but a pure-attention text decoder with an RMSNorm
    and, per layer, a SwiGLU or gelu MLP or a MoE of top-k routed experts."""
    bad = [s for s in cfg.layers if s.kind != "attn"]
    moe_ok = not any(s.moe for s in cfg.layers) or 0 < cfg.top_k <= cfg.n_experts
    if (bad or not moe_ok or cfg.encoder_decoder or cfg.frontend is not None
            or cfg.norm != "rmsnorm" or cfg.activation not in ("silu", "gelu")
            or cfg.d_ff <= 0):
        raise NotImplementedError(
            f"{cfg.name}: the port serves pure-attention decoders with an RMSNorm "
            f"and a SwiGLU or gelu MLP or a top-k MoE only (SSM/xLSTM, "
            f"encoder-decoder and vision frontends are not ported yet)")


_NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``cfg``, with each leaf's shape (what
    ``Model.init_params`` draws and ``convert.params_from_numpy`` checks)."""
    d, ff = cfg.d_model, cfg.d_ff

    def linear(fin, fout, bias=False):
        return {"w": (fin, fout), **({"b": (fout,)} if bias else {})}

    def layer(spec):
        core = {"wq": linear(d, cfg.q_dim, cfg.qkv_bias),
                "wk": linear(d, cfg.kv_dim, cfg.qkv_bias),
                "wv": linear(d, cfg.kv_dim, cfg.qkv_bias),
                "wo": linear(cfg.q_dim, d)}
        if cfg.qk_norm:
            core["q_norm"] = {"w": (cfg.head_dim,)}
            core["k_norm"] = {"w": (cfg.head_dim,)}
        return {"ln1": {"w": (d,)}, "core": core, "ln2": {"w": (d,)},
                **({"moe": moe()} if spec.moe else {"mlp": mlp()})}

    def mlp():
        mlp_p = {"up": linear(d, ff), "down": linear(ff, d)}
        if cfg.activation == "silu":  # gated
            mlp_p["gate"] = linear(d, ff)
        return mlp_p

    def moe():
        E = cfg.n_experts
        p = {"router": {"w": (d, E)}, "up": {"w": (E, d, ff)}, "gate": {"w": (E, d, ff)},
             "down": {"w": (E, ff, d)}}
        p.update({f"shared{i}": mlp() for i in range(cfg.n_shared_experts)})
        return p

    tree: Dict[str, Any] = {"embed": {"w": (cfg.vocab_size, d)},
                            "layers": [layer(spec) for spec in cfg.layers],
                            "final_norm": {"w": (d,)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (cfg.vocab_size, d)}
    return tree


_COLUMNS = ("wq", "wk", "wv", "gate", "up")   # column-parallel: sharded by outputs
_ROWS = ("wo", "down")                        # row-parallel: sharded by inputs


def shard_axis(parent: str, key: str) -> Optional[int]:
    """The axis a TP group shards the leaf ``key`` of ``parent`` along
    (``-1`` output columns, ``-2`` input rows: axis 0 of a ``(Fin, Fout)``
    weight, the ``d_ff`` axis of an expert ``down`` ``(E, d_ff, d)``), or
    None (replicated)."""
    if parent in _COLUMNS and key in ("w", "b"):
        return -1
    if parent in _ROWS and key == "w":
        return -2
    return None


def shard_leaf(t, parent: str, key: str, rank: int, n: int):
    """Rank ``rank``'s contiguous ``1/n`` of a leaf (a tensor or numpy
    array) along ``shard_axis``; the leaf itself when replicated."""
    axis = shard_axis(parent, key)
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
                    tp: Tuple[int, int] = (0, 1)) -> Dict[str, Any]:
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
        init = Initializer(generator, torch_dtype(cfg.dtype), dev)

        def draw(node, key, parent):
            # linear weights (the embedding scaled by d_model**-0.5), zero
            # biases and unit norms, drawn in the tree's order
            if isinstance(node, dict):
                return {k: draw(v, k, key) for k, v in node.items()}
            if isinstance(node, list):
                return [draw(v, key, parent) for v in node]
            if len(node) == 3:   # experts: each drawn (and sharded) in turn, in place
                experts = None
                for e in range(node[0]):
                    t = draw(node[1:], key, parent)
                    if experts is None:
                        experts = t.new_empty((node[0], *t.shape))
                    experts[e] = t
                return experts
            if key == "b":
                t = init.zeros(node)
            elif parent in _NORMS:
                t = init.ones(node)
            else:
                t = init.linear(node, scale=cfg.d_model**-0.5 if parent == "embed" else None)
            if shard_axis(parent, key) is None or n == 1:
                return t
            return shard_leaf(t, parent, key, rank, n).clone()

        return draw(param_shapes(cfg), "", "")

    def local_cfg(self, ctx: TPContext) -> ModelConfig:
        """The config this process computes with: the rank-local view on a
        TP group (``ModelConfig.tp_shard``), else the config itself."""
        return self.cfg.tp_shard(ctx.tp_size)

    # ----------------------------------------------------------------- serve

    def _embed(self, ctx: TPContext, params, tokens: torch.Tensor) -> torch.Tensor:
        x = embed(ctx, params["embed"]["w"], tokens)
        return x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)

    def _logits(self, ctx: TPContext, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm + unembed of x (N, 1, d_model) -> logits (N, V)."""
        x = rms_norm(x, params["final_norm"]["w"])
        head = params.get("lm_head", params["embed"])["w"]
        return unembed(ctx, x, head)[:, 0]

    def _paged_layers(self, ctx: TPContext, params, x: torch.Tensor, state,
                      attend: Callable) -> Tuple[torch.Tensor, Any]:
        """Every layer over the paged pools of ``state``: ``attend(cfg, core
        params, h, pool_k, pool_v, window)`` is the step's paged attention
        (``cfg`` the rank-local config, ``window`` the layer's own
        ``LayerSpec.window``) and returns (out,
        pool_k, pool_v); then the layer's MLP or MoE (``feed_forward``).
        Pools update in place. Returns (x,
        state)."""
        pools_k, pools_v = list(state["pools_k"]), list(state["pools_v"])
        cfg = self.local_cfg(ctx)
        for i, spec in enumerate(cfg.layers):
            lp = params["layers"][i]
            h = rms_norm(x, lp["ln1"]["w"])
            out, pools_k[i], pools_v[i] = attend(cfg, lp["core"], h, pools_k[i], pools_v[i],
                                                 spec.window)
            x = x + out
            h = rms_norm(x, lp["ln2"]["w"])
            x = x + feed_forward(ctx, cfg, spec, lp, h)
        return x, {**state, "pools_k": pools_k, "pools_v": pools_v}

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda", ctx: Optional[TPContext] = None
                   ) -> Dict[str, Any]:
        """Dense per-layer K/V caches for whole-prompt prefill (this rank's
        kv heads on a TP group ``ctx``)."""
        cfg = self.local_cfg(ctx) if ctx is not None else self.cfg
        return {"layers": [init_cache(cfg, batch, max_len, dtype, device)
                           for _ in cfg.layers],
                "pos": 0}

    def prefill(self, ctx: TPContext, params, batch, cache, *,
                last_index=None) -> Tuple[torch.Tensor, Any]:
        """Whole-prompt prefill of ``batch["tokens"]`` (B, S) into ``cache``
        (written in place); returns (logits (B, V) at ``last_index``, the last
        position by default, and the cache). The engine right-pads prompts to
        a length bucket and passes the last real token's index (causal
        masking hides the pads), an int or a 0-d int32 tensor on the tokens'
        device (the row is picked on the device, so the call holds no host
        value of it)."""
        tokens = batch["tokens"]
        x = self._embed(ctx, params, tokens)
        x, layer_caches = apply_stack(ctx, self.local_cfg(ctx), params["layers"], x, pos=0,
                                      caches=cache["layers"])
        i = int_scalar(tokens.shape[1] - 1 if last_index is None else last_index, x.device)
        logits = self._logits(ctx, params, x.index_select(1, i.reshape(1)))
        return logits, {"layers": layer_caches, "pos": tokens.shape[1]}

    def prefill_chunk(self, ctx: TPContext, params, tokens, state, table_row, start,
                      n_valid, cache_spec=None) -> Tuple[torch.Tensor, Any]:
        """Chunked prefill of ONE slot: tokens (1, C) int32, right-padded
        after ``n_valid`` real tokens; table_row (max_blocks,) int32 the
        slot's blocks; ``start`` the position of tokens[0, 0]. ``start`` and
        ``n_valid`` are ints or 0-d int32 tensors on the tokens' device. Each
        layer attends the slot's paged history plus the chunk, then appends
        the chunk's K/V to the pools (in place). Returns (logits (1, V) at
        chunk index ``n_valid - 1``, state)."""
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
        Returns (logits (B, V), state); the pools update in place."""
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
        of ``state`` (in place) and returns (logits (n_slots, V), state)."""
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
