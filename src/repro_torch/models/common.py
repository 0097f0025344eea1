"""Shared model components: RMSNorm, RoPE, embeddings, parameter init."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.tp import TPContext

__all__ = ["rms_norm", "make_rope", "apply_rope", "embed", "unembed", "int_scalar",
           "Initializer"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (...,) -> rope table (..., head_dim//2, 2) of (cos, sin)."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / half)
    ang = positions.float()[..., None] * freqs
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def apply_rope(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), rope (B, S, D//2, 2) or (S, D//2, 2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if rope.dim() == 3:
        rope = rope[None]
    cos = rope[..., 0][:, :, None, :].to(x.dtype)
    sin = rope[..., 1][:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def int_scalar(v, device: torch.device) -> torch.Tensor:
    """A 0-d int32 tensor on ``device`` for an int or an int tensor (an int
    becomes a fill, not a host-to-device copy, so it can run under capture)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(device=device, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=device)


def embed(ctx: TPContext, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(ctx: TPContext, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits: x (..., d) against table (V, d)."""
    return torch.matmul(x, table.to(x.dtype).t())


class Initializer:
    """Seeded parameter init from one ``torch.Generator``.

    Tensors are drawn in a fixed order (the order ``Model.init_params`` walks
    the parameter tree), so a seed fixes every weight; the draws differ from
    the reference's per-name ``jax.random`` keys (tests that compare the two
    frameworks convert the reference's weights with ``models/convert.py``).
    Normals are drawn in fp32 on the generator's device, scaled, then cast.
    """

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def linear(self, shape, scale: Optional[float] = None) -> torch.Tensor:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in**-0.5
        w = torch.randn(*shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return w.mul_(s).to(self.dtype)   # in place: one fp32 transient, not two

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(*shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(*shape, dtype=self.dtype, device=self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=self.dtype, device=self.device)
