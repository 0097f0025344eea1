"""Decoder stack of attention layers, each with a dense MLP or a MoE
sublayer (the reference's ``models/transformer.py`` ``apply_layer`` /
``apply_stack`` for the layer kind the port serves; each layer attends
within its ``LayerSpec.window``). Mamba and xLSTM layers raise."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.tp import TPContext
from repro_torch.models.attention import KVCache, attention
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import mlp
from repro_torch.models.moe import moe

__all__ = ["apply_layer", "apply_stack", "feed_forward"]


def feed_forward(ctx: TPContext, cfg: ModelConfig, spec: LayerSpec, params,
                 h: torch.Tensor) -> torch.Tensor:
    """The layer's second sublayer on the normed residual ``h``: the MoE
    (routed plus shared experts) on a ``spec.moe`` layer, else the MLP."""
    if spec.moe:
        return moe(ctx, params["moe"], h, cfg)[0]
    return mlp(ctx, params["mlp"], h, cfg)


def apply_layer(ctx: TPContext, cfg: ModelConfig, spec: LayerSpec, params,
                x: torch.Tensor, *, pos: int, cache: Optional[KVCache] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One pre-norm layer: x + attention(norm(x)), then + the MLP or MoE of
    norm(x) (``feed_forward``). Returns (x, cache). (The reference also
    returns the MoE aux losses, which serving never reads; ``moe(...,
    aux=True)`` computes them.)"""
    if spec.kind != "attn":
        raise NotImplementedError(f"layer kind {spec.kind!r} is not ported yet")
    h = rms_norm(x, params["ln1"]["w"])
    out, cache = attention(ctx, params["core"], h, cfg, pos=pos, cache=cache,
                           window=spec.window)
    x = x + out
    h = rms_norm(x, params["ln2"]["w"])
    return x + feed_forward(ctx, cfg, spec, params, h), cache


def apply_stack(ctx: TPContext, cfg: ModelConfig, params_list, x: torch.Tensor, *,
                pos: int, caches: Optional[List[KVCache]] = None
                ) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
    """Every layer of ``cfg`` in order; returns (x, new caches or None)."""
    new_caches = []
    for i, spec in enumerate(cfg.layers):
        x, c = apply_layer(ctx, cfg, spec, params_list[i], x, pos=pos,
                           cache=caches[i] if caches is not None else None)
        new_caches.append(c)
    return x, (new_caches if caches is not None else None)
