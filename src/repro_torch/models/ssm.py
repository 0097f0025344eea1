"""Mamba (selective SSM) block: the reference's ``models/ssm.py`` —
whole-prompt prefill through a chunked selective scan, O(1) decode on the
recurrent state, the out-projection's row-parallel reduction compressed as
the paper compresses every other one.

The recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` is first-order
linear. Prefill runs it chunk by chunk (64 tokens, as the reference), the
(B, d_inner, N) state carried from chunk to chunk; inside a chunk a
log-depth doubling scan over the (B, L, d_inner, N) fp32 expansion gives
every step's state at once (33.5 MB a chunk at jamba's full width), which
computes the reference's ``lax.associative_scan`` up to fp32 summation
order. The reference halves its chunk until it divides the prompt length
(a prime length runs 1-token chunks); here the scan's inputs are padded
instead, with ``dt = 0`` and ``x = 0`` after the prompt: ``a = 1, b = 0``
is the identity of the combine, so every state and output at a real
position, and the final state, are the unpadded ones. The scan is plain
PyTorch: the reference's scan has no Pallas kernel.

Caches (``MambaCache``) are fp32 whatever the model's dtype, as the
reference's ``init_mamba_cache`` makes them: the conv history ``(B,
d_conv - 1, d_inner)`` and the state ``(B, d_inner, N)``.

Tensor parallelism: the weights are sharded by ``d_inner`` as the
reference's ``mamba_specs`` shards them (``models/model.py`` ``shard_axis``),
so each rank of a TP group holds ``d_inner / N`` channels of the conv, the
scan and the state. Two products contract over ``d_inner``: the
out-projection, through ``row_linear`` (the policy's compressed reduction),
and ``x_proj``, whose (T, dt_rank + 2N) partial is reduced uncompressed
with one all-reduce (``collectives.rank_psum``), as GSPMD reduces the
reference's sharded ``x_proj`` einsum. That partial is computed and reduced
in fp32 and rounded to the activation dtype once, after the sum, as the
single-rank product rounds once: dt, B and C feed the whole scan, and a
bf16 rounding of each partial and of their sum moved the rank path's
logits from the single-rank ones about three times as far (reduced jamba,
bf16, 2 ranks on the CPU). Under ``simulate_tp`` only the out-projection is
split into partial sums, as in the reference's simulated ``row_linear``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import copy_to_group, rank_psum
from repro_torch.core.tp import TPContext, column_linear, row_linear
from repro_torch.device import resolve_device

__all__ = ["MambaCache", "init_mamba_cache", "mamba", "selective_scan", "causal_conv",
           "CHUNK"]

CHUNK = 64   # the reference's _CHUNK


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) trailing conv inputs
    ssm: torch.Tensor   # (B, d_inner, N) recurrent state


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> MambaCache:
    di, dev = cfg.ssm_d_inner, resolve_device(device)
    return MambaCache(conv=torch.zeros((batch, cfg.ssm_d_conv - 1, di), dtype=dtype, device=dev),
                      ssm=torch.zeros((batch, di, cfg.ssm_d_state), dtype=dtype, device=dev))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                history: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv by static shifts: x (B, S, di), w (dc, di), b
    (di,), history (B, dc - 1, di) of the inputs before x (zeros when
    None)."""
    dc, S = w.shape[0], x.shape[1]
    if history is None:
        history = x.new_zeros(x.shape[0], dc - 1, x.shape[-1])
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(dc):
        out = out + xp[:, i:i + S] * w[i]
    return out + b.to(x.dtype)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the combine ``(l, r) -> (r0 l0, r0 l1 + r1)`` along
    axis 1 of a / b (B, L, ...): step k joins each position with the
    prefix ending k before it, so log2(L) steps."""
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def selective_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   A: torch.Tensor, h0: torch.Tensor, chunk: int = CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked selective scan, fp32: dt / x (B, S, di), Bm / Cm (B, S,
    N), A (di, N), h0 (B, di, N). Returns (y (B, S, di), the state after
    position S - 1). Chunks of ``min(chunk, S)`` tokens; the inputs are
    padded to a whole number of chunks with the combine's identity."""
    S = x.shape[1]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        dt, x, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, x, Bm, Cm))
    h, ys = h0, []
    for c in range(0, S + pad, L):
        dt_k, x_k, B_k, C_k = (t[:, c:c + L] for t in (dt, x, Bm, Cm))
        a = torch.exp(dt_k[..., None] * A)                        # (B, L, di, N)
        b = (dt_k * x_k)[..., None] * B_k[:, :, None, :]
        aa, bb = _doubling_scan(a, b)
        h_all = aa * h[:, None] + bb
        ys.append(torch.einsum("bldn,bln->bld", h_all, C_k))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h


def mamba(ctx: TPContext, params, u: torch.Tensor, cfg: ModelConfig, *,
          cache: Optional[MambaCache] = None, decode: bool = False
          ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """u (B, S, d_model) -> (out, new cache): the reference's ``mamba``.
    ``decode`` takes S == 1 and a cache, and updates the state in O(1).
    With a cache, prefill starts from its conv history and state and
    returns both after the prompt (new tensors; the caller writes them where
    it keeps its state)."""
    B, S, _ = u.shape
    N, dtr = cfg.ssm_d_state, cfg.dt_rank
    u = copy_to_group(u, ctx.tp_group)   # training: one backward all-reduce for in_x, in_z
    x = column_linear(ctx, u, params["in_x"]["w"])   # (B, S, di): rank's channels
    z = column_linear(ctx, u, params["in_z"]["w"])
    x_conv = causal_conv(x, params["conv_w"].to(x.dtype), params["conv_b"],
                         cache.conv if cache is not None else None)
    new_conv = None
    if cache is not None:
        tail = torch.cat([cache.conv.to(x.dtype), x], dim=1)[:, -(cfg.ssm_d_conv - 1):]
        new_conv = tail.to(cache.conv.dtype)
    x = F.silu(x_conv)

    if ctx.tp_group is not None:   # this rank's share of d_inner: a partial, summed in fp32
        bcd = rank_psum(torch.matmul(x.float(), params["x_proj"]["w"].float()),
                        ctx.tp_group).to(x.dtype)
        # read by the rank's dt_proj columns and channels: in training each
        # rank's gradient of it is a share, summed over the group
        bcd = copy_to_group(bcd, ctx.tp_group)
    else:
        bcd = torch.matmul(x, params["x_proj"]["w"].to(x.dtype))      # contracts over di
    dt_raw = bcd[..., :dtr]
    Bm = bcd[..., dtr:dtr + N].float()
    Cm = bcd[..., dtr + N:].float()
    dt = F.softplus(torch.matmul(dt_raw, params["dt_proj"]["w"].to(x.dtype)).float()
                    + params["dt_proj"]["b"].float())
    A = -torch.exp(params["A_log"].float())                       # (di, N)
    x32 = x.float()

    if decode:
        if cache is None or S != 1:
            raise ValueError(f"mamba decode takes one token and a cache (S={S}, "
                             f"cache {'given' if cache is not None else 'missing'})")
        a = torch.exp(dt[:, 0, :, None] * A)                      # (B, di, N)
        b = (dt[:, 0] * x32[:, 0])[..., None] * Bm[:, 0, None, :]
        new_ssm = a * cache.ssm + b
        y = torch.einsum("bdn,bn->bd", new_ssm, Cm[:, 0])[:, None]
    else:
        h0 = (cache.ssm.float() if cache is not None
              else x32.new_zeros(B, x.shape[-1], N))
        y, new_ssm = selective_scan(dt, x32, Bm, Cm, A, h0)

    y = (y + params["D"].float() * x32).to(u.dtype)
    y = y * F.silu(z)
    out = row_linear(ctx, y, params["out_proj"]["w"], n_tokens=B * S)
    new_cache = None
    if cache is not None:
        new_cache = MambaCache(conv=new_conv, ssm=new_ssm.to(cache.ssm.dtype))
    return out, new_cache
