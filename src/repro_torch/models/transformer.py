"""Decoder stack of attention, Mamba and xLSTM layers (the reference's
``models/transformer.py`` ``apply_layer`` / ``init_layer_cache`` /
``apply_stack``; each attention layer attends within its
``LayerSpec.window``). An attention or Mamba layer carries a dense MLP or
MoE sublayer (jamba's Mamba layers too), as the reference's
``_has_mlp_sublayer`` gives every attention and Mamba layer one when the
config has an FFN; an mLSTM or sLSTM layer owns its projections and has no
second sublayer and no ``ln2``."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.tp import TPContext
from repro_torch.models.attention import attention, init_cache
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import mlp
from repro_torch.models.moe import moe
from repro_torch.models.ssm import init_mamba_cache, mamba
from repro_torch.models.xlstm import init_mlstm_cache, init_slstm_cache, mlstm, slstm

__all__ = ["apply_layer", "apply_stack", "feed_forward", "init_layer_cache", "add_aux"]


def feed_forward(ctx: TPContext, cfg: ModelConfig, spec: LayerSpec, params,
                 h: torch.Tensor, aux: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The layer's second sublayer on the normed residual ``h``: the MoE
    (routed plus shared experts) on a ``spec.moe`` layer, else the MLP. A
    MoE adds its aux losses into ``aux`` when one is given."""
    if spec.moe:
        out, losses = moe(ctx, params["moe"], h, cfg, aux=aux is not None)
        if aux is not None:
            aux.update(losses)
        return out
    return mlp(ctx, params["mlp"], h, cfg)


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cuda"):
    """A layer's dense serving cache: K/V of ``max_len`` positions in
    ``dtype`` for attention, a fp32 ``MambaCache``, ``MLSTMCache`` or
    ``SLSTMCache`` for a recurrent layer (the reference never passes its
    dtype on)."""
    if spec.kind == "attn":
        return init_cache(cfg, batch, max_len, dtype, device)
    recurrent = {"mamba": init_mamba_cache, "mlstm": init_mlstm_cache,
                 "slstm": init_slstm_cache}
    if spec.kind not in recurrent:
        raise ValueError(spec.kind)
    return recurrent[spec.kind](cfg, batch, device=device)


def apply_layer(ctx: TPContext, cfg: ModelConfig, spec: LayerSpec, params,
                x: torch.Tensor, *, pos: int, cache: Any = None, decode: bool = False,
                aux: bool = False):
    """One pre-norm layer: x + core(norm(x)), attention, Mamba, mLSTM or
    sLSTM (``decode``: a recurrent block's one-token state update), then
    for an attention or Mamba layer + the MLP or MoE of norm(x)
    (``feed_forward``). Returns (x, cache), or with ``aux`` (x, cache, the
    MoE aux losses: empty for a layer without a MoE), as the reference's
    returns them (serving does not ask)."""
    losses: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, params["ln1"]["w"])
    if spec.kind == "attn":
        out, cache = attention(ctx, params["core"], h, cfg, pos=pos, cache=cache,
                               window=spec.window)
    else:
        blocks = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}
        if spec.kind not in blocks:
            raise ValueError(spec.kind)
        out, cache = blocks[spec.kind](ctx, params["core"], h, cfg, cache=cache,
                                       decode=decode)
    x = x + out
    if spec.kind not in ("mlstm", "slstm"):   # an xLSTM block owns its feed-forward
        h = rms_norm(x, params["ln2"]["w"])
        x = x + feed_forward(ctx, cfg, spec, params, h, losses if aux else None)
    return (x, cache, losses) if aux else (x, cache)


def add_aux(total: Dict[str, torch.Tensor], losses: Dict[str, torch.Tensor]) -> None:
    """Sum a layer's aux losses into ``total`` (the reference's order)."""
    for k, v in losses.items():
        total[k] = total[k] + v if k in total else v


def apply_stack(ctx: TPContext, cfg: ModelConfig, params_list, x: torch.Tensor, *,
                pos: int, caches: Optional[List[Any]] = None, decode: bool = False,
                aux: bool = False):
    """Every layer of ``cfg`` in order; returns (x, new caches or None), or
    with ``aux`` (x, caches, the MoE aux losses summed over layers). Under
    ``ctx.remat`` with grad enabled each layer is recomputed in backward
    (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``_maybe_remat``)."""
    new_caches = []
    total: Dict[str, torch.Tensor] = {}
    for i, spec in enumerate(cfg.layers):
        def layer(x, spec=spec, params_i=params_list[i],
                  c=caches[i] if caches is not None else None):
            out = apply_layer(ctx, cfg, spec, params_i, x, pos=pos, cache=c, decode=decode,
                              aux=aux)
            return out if aux else (*out, {})

        if ctx.remat and torch.is_grad_enabled():
            x, c, losses = checkpoint(layer, x, use_reentrant=False)
        else:
            x, c, losses = layer(x)
        add_aux(total, losses)
        new_caches.append(c)
    caches_out = new_caches if caches is not None else None
    return (x, caches_out, total) if aux else (x, caches_out)
