"""Decoder stack of attention and Mamba layers, each with a dense MLP or a
MoE sublayer (the reference's ``models/transformer.py`` ``apply_layer`` /
``init_layer_cache`` / ``apply_stack`` for the layer kinds the port serves;
each attention layer attends within its ``LayerSpec.window``). jamba's Mamba
layers carry the MLP or MoE sublayer too, as the reference's
``_has_mlp_sublayer`` gives every attention and Mamba layer one when the
config has an FFN (the port serves only such configs). xLSTM layers
raise."""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.tp import TPContext
from repro_torch.models.attention import attention, init_cache
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import mlp
from repro_torch.models.moe import moe
from repro_torch.models.ssm import init_mamba_cache, mamba

__all__ = ["apply_layer", "apply_stack", "feed_forward", "init_layer_cache"]


def feed_forward(ctx: TPContext, cfg: ModelConfig, spec: LayerSpec, params,
                 h: torch.Tensor) -> torch.Tensor:
    """The layer's second sublayer on the normed residual ``h``: the MoE
    (routed plus shared experts) on a ``spec.moe`` layer, else the MLP."""
    if spec.moe:
        return moe(ctx, params["moe"], h, cfg)[0]
    return mlp(ctx, params["mlp"], h, cfg)


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cuda"):
    """A layer's dense serving cache: K/V of ``max_len`` positions in
    ``dtype`` for attention, a fp32 ``MambaCache`` for Mamba (the
    reference never passes its dtype on)."""
    if spec.kind == "attn":
        return init_cache(cfg, batch, max_len, dtype, device)
    if spec.kind == "mamba":
        return init_mamba_cache(cfg, batch, device=device)
    raise NotImplementedError(f"layer kind {spec.kind!r} is not ported yet")


def apply_layer(ctx: TPContext, cfg: ModelConfig, spec: LayerSpec, params,
                x: torch.Tensor, *, pos: int, cache: Any = None, decode: bool = False
                ) -> Tuple[torch.Tensor, Any]:
    """One pre-norm layer: x + core(norm(x)), attention or Mamba (``decode``:
    the Mamba one-token state update), then + the MLP or MoE of norm(x)
    (``feed_forward``). Returns (x, cache). (The reference also returns the
    MoE aux losses, which serving never reads; ``moe(..., aux=True)``
    computes them.)"""
    h = rms_norm(x, params["ln1"]["w"])
    if spec.kind == "attn":
        out, cache = attention(ctx, params["core"], h, cfg, pos=pos, cache=cache,
                               window=spec.window)
    elif spec.kind == "mamba":
        out, cache = mamba(ctx, params["core"], h, cfg, cache=cache, decode=decode)
    else:
        raise NotImplementedError(f"layer kind {spec.kind!r} is not ported yet")
    x = x + out
    h = rms_norm(x, params["ln2"]["w"])
    return x + feed_forward(ctx, cfg, spec, params, h), cache


def apply_stack(ctx: TPContext, cfg: ModelConfig, params_list, x: torch.Tensor, *,
                pos: int, caches: Optional[List[Any]] = None, decode: bool = False
                ) -> Tuple[torch.Tensor, Optional[List[Any]]]:
    """Every layer of ``cfg`` in order; returns (x, new caches or None)."""
    new_caches = []
    for i, spec in enumerate(cfg.layers):
        x, c = apply_layer(ctx, cfg, spec, params_list[i], x, pos=pos,
                           cache=caches[i] if caches is not None else None, decode=decode)
        new_caches.append(c)
    return x, (new_caches if caches is not None else None)
