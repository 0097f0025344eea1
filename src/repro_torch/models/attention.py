"""GQA attention with RoPE over paged KV pools — the mixed token-budget path
of the reference's ``models/attention.py``.

KV pools are flat ``(n_blocks, block_size, kv_dim)`` (dense) or MX wire
pairs ``(payload (n_blocks, bs, kv_dim*bits/8), scales (n_blocks, bs,
kv_dim/B))``, as in the reference. One difference in idiom: pool appends are
in-place ``index_put_`` on the pool tensors (JAX returns updated copies via
``.at[].set``); the functions still return the pools so call sites read the
same.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import KVCacheSpec, MXSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.core.tp import TPContext, column_linear, row_linear
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (
    NEG_INF, T_INVALID, attend_block as _attend_block, paged_attention,
)
from repro_torch.models.common import apply_rope, make_rope, rms_norm

__all__ = ["paged_attention_mixed", "quantize_kv_pages", "NEG_INF", "T_INVALID",
           "_attend_block", "_qkv"]


def _qkv(ctx: TPContext, params, x: torch.Tensor, cfg: ModelConfig, positions):
    """Project to q (B, S, H, hd) and flat k/v (B, S, kv_dim), RoPE applied."""
    B, S = x.shape[:2]
    q = column_linear(ctx, x, params["wq"]["w"], params["wq"].get("b"))
    k = column_linear(ctx, x, params["wk"]["w"], params["wk"].get("b"))
    v = column_linear(ctx, x, params["wv"]["w"], params["wv"].get("b"))
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"]["w"])
        k = rms_norm(k, params["k_norm"]["w"])
    if positions is not None:
        rope = make_rope(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    return q, k.reshape(B, S, cfg.kv_dim), v


def quantize_kv_pages(k: torch.Tensor, v: torch.Tensor, spec: MXSpec):
    """Quantize dense K/V (..., kv_dim) into wire pages — the single
    append-path codec entry (the quantize kernel on the card)."""
    return ops.mx_quantize(k, spec), ops.mx_quantize(v, spec)


def paged_attention_mixed(
    ctx: TPContext,
    params,
    x: torch.Tensor,                   # (1, T, d_model) — the flattened budget
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,           # (T,) int32 per-token positions
    slot_ids: torch.Tensor,            # (T,) int32 owning slot per token
    slot_starts: torch.Tensor,         # (n_slots,) int32 pre-step history end
    valid: torch.Tensor,               # (T,) bool — False rows are budget pads
    is_decode: torch.Tensor,           # (T,) bool — decode vs prefill token
    tables: torch.Tensor,              # (n_slots, max_blocks) int32 block ids
    pool_k,                            # dense pool or MXCompressed wire pool
    pool_v,
    window: Optional[int] = None,
    cache_spec: Optional[KVCacheSpec] = None,
):
    """ONE mixed-batch token-budget step: several slots' prefill chunks plus
    one decode token per decoding slot, flattened into one (1, T) batch.

    Token t reads its slot's paged history through ``tables[slot_ids[t]]``
    (valid below ``slot_starts[slot_ids[t]]``) and attends the batch's
    same-slot tokens at positions <= its own. Precision follows the split
    chunk/decode pair: prefill tokens see in-batch neighbours in compute
    precision, a decode token sees its own new K/V at pool precision (dense
    cast or MX round trip). Then every real token's K/V is appended to the
    pools in place; pad rows write into the reserved null block 0.
    Returns (out (1, T, d_model), pool_k, pool_v).
    """
    B, T = x.shape[:2]
    quantized = cache_spec is not None and cache_spec.quantized
    dev = x.device
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()

    q, k_new, v_new = _qkv(ctx, params, x, cfg, positions[None, :])
    sid = slot_ids.long()
    my_tables = i32(tables[sid])                         # (T, max_blocks)
    nb = tables.shape[1]
    bs = (pool_k.payload if quantized else pool_k).shape[1]
    cap = nb * bs
    start = i32(slot_starts[sid])                         # (T,)

    if quantized:
        mxs = cache_spec.mx
        kq, vq = quantize_kv_pages(k_new[0], v_new[0], mxs)
        k_rt = ops.mx_dequantize(kq, mxs, out_dtype=q.dtype)
        v_rt = ops.mx_dequantize(vq, mxs, out_dtype=q.dtype)
    else:
        k_rt = k_new[0].to(pool_k.dtype).to(q.dtype)
        v_rt = v_new[0].to(pool_v.dtype).to(q.dtype)

    # in-batch K/V: decode tokens read their own write back at pool
    # precision; prefill tokens stay in compute precision
    dec = is_decode[:, None]
    k_step = torch.where(dec, k_rt, k_new[0].to(q.dtype)).contiguous()
    v_step = torch.where(dec, v_rt, v_new[0].to(q.dtype)).contiguous()
    same = (slot_ids[None, :] == slot_ids[:, None]) & valid[None, :]
    t_step = i32(torch.where(same, positions[None, :], T_INVALID))   # (T, T)

    # the paged read: the gather-free kernel on the card, its plain version
    # (the pool[my_tables] gather) on the CPU
    out = paged_attention(
        q[0].reshape(T, 1, -1).contiguous(), pool_k, pool_v, my_tables, start,
        i32(positions[:, None]), k_step, v_step, t_step,
        spec=cache_spec.mx if quantized else None, kv_heads=cfg.n_kv_heads,
        scale=cfg.head_dim**-0.5, window=window)
    out = out[:, 0][None]                                # (1, T, H*hd)

    # append every real token's K/V; pads fall into the null block
    col = (positions.long() // bs).clamp(0, nb - 1)
    blk = torch.where(valid & (positions < cap),
                      my_tables[torch.arange(T, device=dev), col].long(),
                      torch.zeros((), dtype=torch.long, device=dev))
    offs = (positions % bs).long()
    if quantized:
        for pool, new in ((pool_k, kq), (pool_v, vq)):
            pool.payload.index_put_((blk, offs), new.payload)
            pool.scales.index_put_((blk, offs), new.scales)
    else:
        pool_k.index_put_((blk, offs), k_new[0].to(pool_k.dtype))
        pool_v.index_put_((blk, offs), v_new[0].to(pool_v.dtype))

    y = row_linear(ctx, out, params["wo"]["w"], n_tokens=B * T)
    return y, pool_k, pool_v
