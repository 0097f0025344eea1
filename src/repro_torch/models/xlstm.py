"""xLSTM blocks: the reference's ``models/xlstm.py`` — mLSTM (matrix memory,
chunkwise-parallel prefill, O(1) decode) and sLSTM (scalar memory, a
sequential scan with recurrent gate weights), each block's down-projection
reduction (mLSTM ``down``, sLSTM ``ff_down``) compressed as the paper
compresses every other row-parallel reduction. [arXiv:2405.04517]

mLSTM recurrence per head (exponential gating, log-space stabilized):

    m_t = max(lf_t + m_{t-1}, li_t)
    C_t = e^{lf_t + m_{t-1} - m_t} C_{t-1} + e^{li_t - m_t} v_t k_t^T
    n_t = e^{lf_t + m_{t-1} - m_t} n_{t-1} + e^{li_t - m_t} k_t
    h_t = C_t^T q_t / max(|n_t . q_t|, e^{-m_t})

Prefill runs the reference's chunkwise closed form (``_mlstm_chunk``)
chunk by chunk, the (C, n, m) carry passed on. The reference halves its
128-token chunk until it divides the prompt length (a prime length runs
1-token chunks); here a prompt is cut into 128-token chunks and a shorter
last one: the closed form holds for any chunk length, so every output and
the carry are the reference's up to fp32 summation order. Decode is the
same closed form over one token. The stabilizer starts at -1e30, not
-inf, as the reference's (``exp(F + m0 - m_t)`` stays 0, not NaN).

The sLSTM cell runs the prompt's exact length in a loop of one-token
steps (each gate's input projection ``W x + b`` for every position in one
product first, since it does not depend on h; the four recurrent
``(H, dh, dh)`` products in one batched product a step). In a captured
whole-prompt step program the loop is one CUDA graph, so the host takes no
part in it. Both scans are plain PyTorch: the reference's are ``lax.scan``
with no Pallas kernel.

Caches are fp32 whatever the model's dtype, as the reference's
``init_mlstm_cache`` / ``init_slstm_cache`` make them: ``MLSTMCache`` (C
``(B, H, dh, dh)``, n ``(B, H, dh)``, m ``(B, H)``, the conv history
``(B, d_conv - 1, d_inner)``) and ``SLSTMCache`` (c, n, m, h, each ``(B,
H, dh)``). The four sLSTM tensors are distinct storage (the reference
builds c, n and h from one zeros array): the engine writes each slot's row
of each in place.

Tensor parallelism (the reference's ``mlstm_specs`` / ``slstm_specs``): an
mLSTM block's ``up``, ``z``, ``conv_w``, ``conv_b`` and ``norm`` are
sharded by ``d_inner``, so a rank holds ``d_inner / N`` channels, which
are its ``H / N`` heads; ``wq``, ``wk``, ``wv``, ``wi`` and ``wf.w`` by
their input rows, so each rank's product is a partial of the whole (T, 3
d_inner + 2H) projection. That partial is computed in fp32, reduced with
one all-reduce a layer (``collectives.rank_psum``, uncompressed, as GSPMD
reduces the reference's sharded einsums) and rounded once to the
activation dtype after the sum, as the single-rank product rounds once
(as ``models/ssm.py`` reduces Mamba's ``x_proj``); each rank then keeps its
heads' columns. A rank computes and holds only its own heads' recurrence
and (C, n, m) state, where the reference keeps C, n and m replicated: the
values are the same, the state 1/N. ``down`` goes through ``row_linear``
(the compressed rank collective). An sLSTM block keeps its gates, its
recurrent matrices and ``norm`` whole on every rank (every rank runs the
same recurrence on the same inputs) and shards its FF: ``ff_up`` and
``ff_gate`` by columns, ``ff_down`` by rows through ``row_linear``. Under
``simulate_tp`` only ``down`` and ``ff_down`` are split into partial sums,
as in the reference's simulated ``row_linear``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import copy_to_group, rank_psum
from repro_torch.core.tp import TPContext, column_linear, fused_mlp, row_linear
from repro_torch.device import resolve_device
from repro_torch.models.ssm import causal_conv

__all__ = ["MLSTMCache", "SLSTMCache", "init_mlstm_cache", "init_slstm_cache", "mlstm",
           "slstm", "reset_cache", "CHUNK", "M_INIT"]

CHUNK = 128     # the reference's _CHUNK
M_INIT = -1e30  # the stabilizer's start (the reference's; finite, not -inf)


class MLSTMCache(NamedTuple):
    C: torch.Tensor     # (B, H, dh, dh)
    n: torch.Tensor     # (B, H, dh)
    m: torch.Tensor     # (B, H)
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) trailing conv inputs


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, dh)
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> MLSTMCache:
    """This rank's heads and channels on a TP group's rank-local config."""
    di, H, dev = cfg.mlstm_d_inner, cfg.mlstm_heads, resolve_device(device)
    dh = di // H
    return MLSTMCache(C=torch.zeros((batch, H, dh, dh), dtype=dtype, device=dev),
                      n=torch.zeros((batch, H, dh), dtype=dtype, device=dev),
                      m=torch.full((batch, H), M_INIT, dtype=dtype, device=dev),
                      conv=torch.zeros((batch, cfg.xlstm_conv - 1, di), dtype=dtype,
                                       device=dev))


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> SLSTMCache:
    """Four tensors of their own storage (every head, on any rank)."""
    H, dev = cfg.n_heads, resolve_device(device)
    shape = (batch, H, cfg.d_model // H)
    return SLSTMCache(c=torch.zeros(shape, dtype=dtype, device=dev),
                      n=torch.zeros(shape, dtype=dtype, device=dev),
                      m=torch.full(shape, M_INIT, dtype=dtype, device=dev),
                      h=torch.zeros(shape, dtype=dtype, device=dev))


def reset_cache(cache) -> None:
    """Put a recurrent cache (a ``MambaCache`` too) back to its initial
    values in place: every tensor zero, an xLSTM stabilizer ``m`` at
    ``M_INIT``."""
    for name, t in zip(cache._fields, cache):
        if name == "m":
            t.fill_(M_INIT)
        else:
            t.zero_()


def _mlstm_chunk(C0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, li: torch.Tensor, lf: torch.Tensor):
    """One chunk of the stabilized chunkwise mLSTM (the reference's
    ``_mlstm_chunk``), fp32: q, k, v (B, H, L, dh); li, lf (B, H, L); the
    carry (C0, n0, m0). Returns (C, n, m after the chunk, h (B, H, L, dh))."""
    L = q.shape[2]
    Fc = torch.cumsum(lf, dim=-1)                                  # cumulative decay
    m_run = torch.maximum(m0[..., None], torch.cummax(li - Fc, dim=-1).values)
    m_t = Fc + m_run                                               # m after each position
    inter_w = torch.exp(Fc + m0[..., None] - m_t)                  # carry-in weight
    # intra weights exp(F_t - F_s + li_s - m_t) for s <= t
    lw = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :] - m_t[..., :, None]
    above = torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1)
    intra = torch.exp(lw).masked_fill(above, 0.0)
    scores = torch.matmul(q, k.transpose(-1, -2)) * intra
    num = torch.matmul(scores, v) + torch.matmul(q, C0) * inter_w[..., None]
    den = scores.sum(-1) + torch.matmul(q, n0[..., None])[..., 0] * inter_w
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the carry after position L - 1
    m_next = m_t[..., -1]
    wL = torch.exp(Fc[..., -1:] - Fc + li - m_next[..., None])    # (B, H, L)
    decay = torch.exp(m0 + Fc[..., -1] - m_next)
    wk = k * wL[..., None]
    C_new = C0 * decay[..., None, None] + torch.matmul(wk.transpose(-1, -2), v)
    n_new = n0 * decay[..., None] + wk.sum(-2)
    return C_new, n_new, m_next, h


def _qkv_gates(ctx: TPContext, params, xi: torch.Tensor, xc: torch.Tensor,
               cfg: ModelConfig):
    """(q, k, v (B, S, di), li, f (B, S, H)) of this rank's heads in the
    activation dtype: q, k from the conv path ``xc``, v and the gates from
    ``xi``. On a TP group each rank's rows give a partial of every head's
    projection: one fp32 all-reduce of the concatenated partial, rounded
    once after the sum, then the rank's columns."""
    names = (("wq", xc), ("wk", xc), ("wv", xi), ("wi", xi), ("wf", xi))
    if ctx.tp_group is None:
        return [torch.matmul(x, params[k]["w"].to(x.dtype)) for k, x in names]
    parts = torch.cat([torch.matmul(x.float(), params[k]["w"].float()) for k, x in names],
                      dim=-1)
    # each rank reads its columns: in training the shares of the gradient
    # are summed over the group
    full = copy_to_group(rank_psum(parts, ctx.tp_group).to(xi.dtype), ctx.tp_group)
    r, N = ctx.tp_rank, ctx.tp_size
    di, H = cfg.mlstm_d_inner, cfg.mlstm_heads
    q, k, v, li, f = torch.split(full, [di * N] * 3 + [H * N] * 2, dim=-1)
    return ([t[..., r * di:(r + 1) * di] for t in (q, k, v)]
            + [t[..., r * H:(r + 1) * H] for t in (li, f)])


def mlstm(ctx: TPContext, params, u: torch.Tensor, cfg: ModelConfig, *,
          cache: Optional[MLSTMCache] = None, decode: bool = False
          ) -> Tuple[torch.Tensor, Optional[MLSTMCache]]:
    """u (B, S, d_model) -> (out, new cache): the reference's ``mlstm``.
    ``decode`` takes S == 1 and a cache. With a cache, prefill starts from
    its state and conv history and returns both after the prompt (new
    tensors; the caller writes them where it keeps its state)."""
    B, S, _ = u.shape
    if decode and (cache is None or S != 1):
        raise ValueError(f"mlstm decode takes one token and a cache (S={S}, "
                         f"cache {'given' if cache is not None else 'missing'})")
    di, H = cfg.mlstm_d_inner, cfg.mlstm_heads      # this rank's channels and heads
    dh = di // H
    u = copy_to_group(u, ctx.tp_group)   # training: one backward all-reduce for up, z
    xi = column_linear(ctx, u, params["up"]["w"])
    zg = column_linear(ctx, u, params["z"]["w"])
    history = cache.conv if cache is not None else None
    xc = F.silu(causal_conv(xi, params["conv_w"].to(xi.dtype), params["conv_b"], history))
    new_conv = None
    if cache is not None:   # the last d_conv - 1 inputs before the SiLU
        tail = torch.cat([cache.conv.to(xi.dtype), xi], dim=1)[:, -(cfg.xlstm_conv - 1):]
        new_conv = tail.to(cache.conv.dtype)

    q, k, v, li, f = _qkv_gates(ctx, params, xi, xc, cfg)
    heads = lambda t: t.reshape(B, S, H, dh).transpose(1, 2).float()   # (B, H, S, dh)
    q, k, v = heads(q) * dh**-0.5, heads(k), heads(v)
    li = li.float().transpose(1, 2)                                     # (B, H, S)
    f_bias = params["wf"]["b"].float()
    if ctx.tp_group is not None:   # the bias is whole on every rank: each reads its heads
        f_bias = copy_to_group(f_bias, ctx.tp_group)[ctx.tp_rank * H:(ctx.tp_rank + 1) * H]
    lf = F.logsigmoid(f.float() + f_bias).transpose(1, 2)

    if cache is not None:
        C, n, m = cache.C.float(), cache.n.float(), cache.m.float()
    else:
        C = q.new_zeros(B, H, dh, dh)
        n = q.new_zeros(B, H, dh)
        m = q.new_full((B, H), M_INIT)
    hs = []
    for c0 in range(0, S, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, S))
        C, n, m, h = _mlstm_chunk(C, n, m, q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                  li[..., sl], lf[..., sl])
        hs.append(h)
    h = torch.cat(hs, dim=2) if len(hs) > 1 else hs[0]

    h = h.transpose(1, 2).reshape(B, S, di).to(u.dtype)
    hn = h.reshape(B, S, H, dh).float()            # per-head group norm (rms over dh)
    hn = hn * torch.rsqrt((hn * hn).mean(-1, keepdim=True) + 1e-6)
    h = (hn.reshape(B, S, di) * params["norm"]["w"].float()).to(u.dtype)
    h = h * F.silu(zg)
    out = row_linear(ctx, h, params["down"]["w"], n_tokens=B * S)
    new_cache = None
    if cache is not None:
        new_cache = MLSTMCache(C=C.to(cache.C.dtype), n=n.to(cache.n.dtype),
                               m=m.to(cache.m.dtype), conv=new_conv)
    return out, new_cache


_GATES = ("z", "i", "f", "o")


def _gelu(h: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu: the tanh approximation
    return F.gelu(h, approximate="tanh")


def slstm(ctx: TPContext, params, u: torch.Tensor, cfg: ModelConfig, *,
          cache: Optional[SLSTMCache] = None, decode: bool = False
          ) -> Tuple[torch.Tensor, Optional[SLSTMCache]]:
    """u (B, S, d_model) -> (out, new cache): the reference's ``slstm``,
    every head on every rank; then the gated GELU FF (4/3 d_model columns,
    this rank's on a TP group) and ``ff_down``'s reduction."""
    B, S, d = u.shape
    if decode and (cache is None or S != 1):
        raise ValueError(f"slstm decode takes one token and a cache (S={S}, "
                         f"cache {'given' if cache is not None else 'missing'})")
    H = cfg.n_heads
    dh = d // H
    if cache is not None:
        c, n, m, h = (t.float() for t in cache)
    else:
        c, n, h = (u.new_zeros(B, H, dh, dtype=torch.float32) for _ in range(3))
        m = u.new_full((B, H, dh), M_INIT, dtype=torch.float32)
    x32 = u.float()
    # W x + b of each gate for every position: (S, 4, B, H, dh)
    wx = torch.stack([torch.matmul(x32, params[f"w{g}"]["w"].float())
                      + (params[f"w{g}"]["b"].float() if "b" in params[f"w{g}"] else 0.0)
                      for g in _GATES]).reshape(4, B, S, H, dh).permute(2, 0, 1, 3, 4)
    R = torch.stack([params[f"r{g}"].float() for g in _GATES])           # (4, H, dh, dh)
    hs = []
    for t in range(S):
        rh = torch.matmul(h.transpose(0, 1)[None], R).transpose(1, 2)   # (4, B, H, dh)
        gz, gi, gf, go = (wx[t] + rh).unbind(0)
        z, o, lf = torch.tanh(gz), torch.sigmoid(go), F.logsigmoid(gf)
        m_new = torch.maximum(lf + m, gi)
        i_p, f_p = torch.exp(gi - m_new), torch.exp(lf + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        m = m_new
        h = o * c / torch.clamp(n.abs(), min=1.0)
        hs.append(h)
    y = torch.stack(hs, dim=1)                                           # (B, S, H, dh)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6)          # per-head group norm
    y = (y.reshape(B, S, d) * params["norm"]["w"].float()).to(u.dtype)
    out = fused_mlp(ctx, y, params["ff_gate"]["w"], params["ff_up"]["w"],
                    params["ff_down"]["w"], act=_gelu, n_tokens=math.prod(y.shape[:-1]))
    new_cache = None
    if cache is not None:
        new_cache = SLSTMCache(*(s.to(t.dtype) for s, t in zip((c, n, m, h), cache)))
    return out, new_cache
