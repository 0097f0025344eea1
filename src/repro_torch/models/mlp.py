"""Dense SwiGLU MLP with the paper's compressed reduction on the down
projection (column-parallel gate/up, row-parallel down)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tp import TPContext, column_linear, row_linear

__all__ = ["mlp"]


def mlp(ctx: TPContext, params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation != "silu" or "gate" not in params:
        raise NotImplementedError("the port's MLP is the gated SwiGLU path only")
    h = column_linear(ctx, x, params["up"]["w"])
    h = F.silu(column_linear(ctx, x, params["gate"]["w"])) * h
    return row_linear(ctx, h, params["down"]["w"], n_tokens=math.prod(x.shape[:-1]))
