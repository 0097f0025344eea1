"""Dense MLP with the paper's compressed reduction on the down projection
(column-parallel gate/up, row-parallel down): SwiGLU (``silu``, gated) or
the non-gated ``gelu`` MLP, ``act(up(x))`` then ``down``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tp import TPContext, fused_mlp

__all__ = ["mlp"]


def _gelu(h: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu defaults to the tanh approximation;
    # torch's default is the exact erf form
    return F.gelu(h, approximate="tanh")


_ACT = {"silu": F.silu, "gelu": _gelu}


def mlp(ctx: TPContext, params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = params.get("gate")
    return fused_mlp(ctx, x, gate["w"] if gate else None, params["up"]["w"],
                     params["down"]["w"], act=_ACT[cfg.activation],
                     n_tokens=math.prod(x.shape[:-1]))
