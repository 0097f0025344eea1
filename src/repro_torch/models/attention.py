"""GQA attention with RoPE: the dense self-attention of whole-prompt prefill
(causal, or bidirectional for an encoder), the decoder's cross-attention
over an encoder's K/V, and the three paged geometries of the reference's
``models/attention.py`` (decode, chunk, mixed token-budget step).

Dense caches are flat ``(B, S_max, kv_dim)``; KV pools are flat
``(n_blocks, block_size, kv_dim)`` (dense) or MX wire pairs ``(payload
(n_blocks, bs, kv_dim*bits/8), scales (n_blocks, bs, kv_dim/B))``, as in the
reference. Every paged read goes through ``kernels.paged_attention`` (the
CUDA kernel on the card, its plain version on the CPU). One difference in
idiom: cache and pool writes are in place (``index_put_`` / slice
assignment; JAX returns updated copies via ``.at[].set``); the functions
still return the cache or pools so call sites read the same.

Sequence-sharded pools (``ctx.kv_sharded``): each kv rank holds a slab of
every pool. A paged step exchanges the blocks its tables name into virtual
pools in table order (``_virtual_pools``) and reads them through the
kernel's ``row_map`` addressing (decode: ``arange(B)``; chunk: ``zeros(1)``;
mixed: ``slot_ids``, one region per slot); its appends go to the owning
rank only (``_sharded_append``). The read order against the append is the
replicated path's: decode reads after its write, chunk and mixed before.
On a TP row too (the ``kv x model`` mesh) the pools hold the rank's kv
heads, so the virtual pool and the ``row_map`` read are those of its own
heads, and ``ctx.kv_group`` is the kv group of its model position.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import copy_to_group
from repro_torch.core.formats import KVCacheSpec, MXSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.core.tp import (
    TPContext, column_linear, pool_exchange, pool_scatter, row_linear,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (
    NEG_INF, T_INVALID, attend_block as _attend_block, paged_attention,
)
from repro_torch.models.common import apply_rope, int_scalar, make_rope, rms_norm

__all__ = ["KVCache", "init_cache", "attention", "paged_attention_decode",
           "paged_attention_chunk", "paged_attention_mixed", "quantize_kv_pages",
           "pool_rows", "write_pool_rows", "pool_planes", "NEG_INF", "T_INVALID",
           "_attend_block", "_qkv"]

_Q_CHUNK = 1024


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, kv_dim) flat: n_kv_heads * head_dim
    v: torch.Tensor  # (B, S_max, kv_dim)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> KVCache:
    shape = (batch, max_len, cfg.kv_dim)
    dev = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def _qkv(ctx: TPContext, params, x: torch.Tensor, cfg: ModelConfig, positions):
    """Project to q (B, S, H, hd) and flat k/v (B, S, kv_dim), RoPE applied."""
    B, S = x.shape[:2]
    x = copy_to_group(x, ctx.tp_group)   # training: one backward all-reduce for q, k, v
    q = column_linear(ctx, x, params["wq"]["w"], params["wq"].get("b"))
    k = column_linear(ctx, x, params["wk"]["w"], params["wk"].get("b"))
    v = column_linear(ctx, x, params["wv"]["w"], params["wv"].get("b"))
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, copy_to_group(params["q_norm"]["w"], ctx.tp_group))
        k = rms_norm(k, copy_to_group(params["k_norm"]["w"], ctx.tp_group))
    if positions is not None:
        rope = make_rope(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    return q, k.reshape(B, S, cfg.kv_dim), v


def _attend(q, k, v, q_pos, t_pos, *, window, scale, kv_heads, causal: bool = True,
            chunk: int = _Q_CHUNK):
    """Attention q-chunked as in the reference: q (B, S, H, hd), k/v flat
    (B, T, kv_dim), q_pos (S,), t_pos (T,); causal unless ``causal=False``
    (the encoder, cross-attention); the scores transient stays (B, chunk, H,
    T). The reference halves ``chunk`` until it divides S (1500 encoder
    frames: chunks of 4); here the last chunk is the remainder (1024 + 476),
    the same values per query row in far fewer products. Returns (B, S,
    H*hd)."""
    B, S = q.shape[:2]
    q_pos, t_pos = q_pos.expand(B, S), t_pos.expand(B, k.shape[1])
    kw = dict(window=window, scale=scale, kv_heads=kv_heads, causal=causal)
    if S <= chunk:
        return _attend_block(q, k, v, q_pos, t_pos, **kw)
    return torch.cat([_attend_block(q[:, i:i + chunk], k, v, q_pos[:, i:i + chunk], t_pos, **kw)
                      for i in range(0, S, chunk)], dim=1)


def attention(ctx: TPContext, params, x: torch.Tensor, cfg: ModelConfig, *, pos: int,
              cache: Optional[KVCache] = None, window: Optional[int] = None,
              causal: bool = True, cross_kv: Optional[KVCache] = None):
    """Dense self-attention over x (B, S, d_model) at positions ``pos + [0,
    S)``, causal unless ``causal=False`` (the encoder): without a cache
    (every key is in x), or writing the new K/V into ``cache`` at ``pos``
    (in place, cast to the cache's dtype) and attending the whole cache read
    back at that precision (the reference's prefill). With ``cross_kv``
    (the encoder's flat K/V, (B, F, kv_dim)) it is the decoder's
    cross-attention instead: q through ``column_linear`` (``q_norm`` with
    ``qk_norm``, no RoPE), every encoder position visible, no cache written;
    on a TP group ``cfg`` is the rank-local config, q the rank's heads and
    ``cross_kv`` its kv heads, as in a self-attention.
    Plain PyTorch on the reference's arithmetic: einsum products, fp32
    masked softmax, q-chunked at 1024. ``wo`` is ``row_linear``, the
    reduction the policy compresses. Returns (out (B, S, d_model), cache)."""
    B, S = x.shape[:2]
    if cross_kv is not None:
        x = copy_to_group(x, ctx.tp_group)
        q = column_linear(ctx, x, params["wq"]["w"], params["wq"].get("b"))
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, copy_to_group(params["q_norm"]["w"], ctx.tp_group))
        t_pos = torch.arange(cross_kv.k.shape[1], device=x.device, dtype=torch.int32)
        out = _attend(q, cross_kv.k.to(q.dtype), cross_kv.v.to(q.dtype),
                      torch.zeros(S, device=x.device, dtype=torch.int32), t_pos, window=None,
                      scale=cfg.head_dim**-0.5, kv_heads=cfg.n_kv_heads, causal=False)
        return row_linear(ctx, out, params["wo"]["w"], n_tokens=B * S), cache
    positions = pos + torch.arange(S, device=x.device, dtype=torch.int32)
    q, k_new, v_new = _qkv(ctx, params, x, cfg, positions[None, :])
    if cache is None:
        t_pos, k_all, v_all = positions, k_new, v_new
    else:
        cache.k[:, pos:pos + S] = k_new.to(cache.k.dtype)
        cache.v[:, pos:pos + S] = v_new.to(cache.v.dtype)
        k_all, v_all = cache
        t_pos = torch.arange(k_all.shape[1], device=x.device, dtype=torch.int32)
    out = _attend(q, k_all.to(q.dtype), v_all.to(q.dtype), positions, t_pos,
                  window=window, scale=cfg.head_dim**-0.5, kv_heads=cfg.n_kv_heads,
                  causal=causal)
    y = row_linear(ctx, out, params["wo"]["w"], n_tokens=B * S)
    return y, cache


def quantize_kv_pages(k: torch.Tensor, v: torch.Tensor, spec: MXSpec):
    """Quantize dense K/V (..., kv_dim) into wire pages — the single
    append-path codec entry (the quantize kernel on the card)."""
    return ops.mx_quantize(k, spec), ops.mx_quantize(v, spec)


def pool_rows(k: torch.Tensor, v: torch.Tensor, pool_k, cache_spec):
    """K/V rows (N, kv_dim) in the pools' storage format: MX wire pairs
    through ``quantize_kv_pages``, or cast to the dense pools' dtype."""
    if cache_spec is not None and cache_spec.quantized:
        return quantize_kv_pages(k, v, cache_spec.mx)
    return k.to(pool_k.dtype), v.to(pool_k.dtype)


def write_pool_rows(pool_k, pool_v, k_rows, v_rows, blk: torch.Tensor, offs: torch.Tensor):
    """Store rows from ``_pool_rows`` at (block, offset) pairs, in place."""
    for pool, rows in ((pool_k, k_rows), (pool_v, v_rows)):
        if isinstance(pool, MXCompressed):
            pool.payload.index_put_((blk, offs), rows.payload)
            pool.scales.index_put_((blk, offs), rows.scales)
        else:
            pool.index_put_((blk, offs), rows)


def pool_planes(pool_k, pool_v):
    """The pool planes of a K/V pair: (K, V) dense, or (K payload, K
    scales, V payload, V scales) on wire pools."""
    if isinstance(pool_k, MXCompressed):
        return [pool_k.payload, pool_k.scales, pool_v.payload, pool_v.scales]
    return [pool_k, pool_v]


def _virtual_pools(ctx: TPContext, pool_k, pool_v, tables: torch.Tensor):
    """Sharded read half: the blocks ``tables`` (R, nb) names, exchanged
    over the kv group into virtual pools (R*nb, bs, width) in table order,
    bit for bit the values the replicated pools would hold there."""
    v = pool_exchange(ctx, pool_planes(pool_k, pool_v), tables)
    if isinstance(pool_k, MXCompressed):
        return MXCompressed(v[0], v[1]), MXCompressed(v[2], v[3])
    return v[0], v[1]


def _sharded_append(ctx: TPContext, pool_k, pool_v, k_rows, v_rows, blk, offs):
    """Sharded write half: each rank writes the rows (from ``pool_rows``)
    whose block it owns, in place, and drops the rest (no communication)."""
    pool_scatter(ctx, list(zip(pool_planes(pool_k, pool_v), pool_planes(k_rows, v_rows))), blk, offs)


def _write(ctx: TPContext, pool_k, pool_v, k_rows, v_rows, blk, offs) -> None:
    """Append pool rows at (block, offset) pairs: all of them to replicated
    pools, this rank's share to sharded ones."""
    if ctx.kv_sharded:
        _sharded_append(ctx, pool_k, pool_v, k_rows, v_rows, blk, offs)
    else:
        write_pool_rows(pool_k, pool_v, k_rows, v_rows, blk, offs)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _spec_args(cfg: ModelConfig, cache_spec: Optional[KVCacheSpec], window):
    quantized = cache_spec is not None and cache_spec.quantized
    return dict(spec=cache_spec.mx if quantized else None, kv_heads=cfg.n_kv_heads,
                scale=cfg.head_dim**-0.5, window=window)


def _block_size(pool) -> int:
    return (pool.payload if isinstance(pool, MXCompressed) else pool).shape[1]


def paged_attention_decode(
    ctx: TPContext,
    params,
    x: torch.Tensor,                   # (B, 1, d_model) — one token per slot
    cfg: ModelConfig,
    *,
    lengths: torch.Tensor,             # (B,) int32 per-slot write position
    pool_k,                            # dense pool or MXCompressed wire pool
    pool_v,
    tables: torch.Tensor,              # (B, max_blocks) int32 block ids
    window: Optional[int] = None,
    cache_spec: Optional[KVCacheSpec] = None,
):
    """One decode step of every slot against the paged pools: write the new
    K/V at position ``lengths[b]`` of slot b's table first (MX-quantized on
    wire pools), then ONE paged read in which row b attends its history up
    to and including that token (``hist_len = lengths + 1``, at pool
    precision). Inactive slots point at the null block; their writes and
    rows are garbage that the engine discards. Sharded pools: the read goes
    through the exchanged virtual pools, row b's region b.
    Returns (out, pool_k, pool_v).
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(ctx, params, x, cfg, lengths[:, None])
    nb, bs = tables.shape[1], _block_size(pool_k)
    pos = lengths.long()
    blk = tables.long().gather(1, (pos // bs).clamp(max=nb - 1)[:, None])[:, 0]
    k_rows, v_rows = pool_rows(k_new[:, 0], v_new[:, 0], pool_k, cache_spec)
    _write(ctx, pool_k, pool_v, k_rows, v_rows, blk, pos % bs)
    read_k, read_v, row_map = pool_k, pool_v, None
    if ctx.kv_sharded:
        read_k, read_v = _virtual_pools(ctx, pool_k, pool_v, tables)
        row_map = torch.arange(B, device=x.device, dtype=torch.int32)
    out = paged_attention(q.reshape(B, 1, -1).contiguous(), read_k, read_v, _i32(tables),
                          _i32(lengths + 1), _i32(lengths[:, None]), row_map=row_map,
                          **_spec_args(cfg, cache_spec, window))
    y = row_linear(ctx, out, params["wo"]["w"], n_tokens=B)
    return y, pool_k, pool_v


def paged_attention_chunk(
    ctx: TPContext,
    params,
    x: torch.Tensor,                   # (1, C, d_model) — one prompt chunk
    cfg: ModelConfig,
    *,
    start,                             # position of x[:, 0]: int or int32 scalar
    table_row: torch.Tensor,           # (max_blocks,) int32: the slot's blocks
    pool_k,
    pool_v,
    window: Optional[int] = None,
    cache_spec: Optional[KVCacheSpec] = None,
):
    """Chunked-prefill attention for ONE slot: a paged read (R = 1, Sq = C)
    of the slot's history below ``start`` at pool precision, with the chunk's
    own K/V as compute-precision extras, read BEFORE the append; then the
    chunk's K/V goes into the pools at ``start + [0, C)`` (positions past the
    table, pads included, fall into the null block). Sharded pools: the
    slot's blocks are exchanged into one region (``row_map`` 0) before the
    append. ``start`` may be a 0-d int32 tensor on x's device (what a
    captured step reads from its static input). Returns (out (1, C,
    d_model), pool_k, pool_v)."""
    B, C = x.shape[:2]
    dev = x.device
    start = int_scalar(start, dev)
    p = start + torch.arange(C, device=dev, dtype=torch.int32)
    q, k_new, v_new = _qkv(ctx, params, x, cfg, p[None, :])
    nb, bs = table_row.shape[0], _block_size(pool_k)
    pl = p.long()
    blk = torch.where(pl < nb * bs, table_row.long()[(pl // bs).clamp(0, nb - 1)],
                      torch.zeros((), dtype=torch.long, device=dev))
    p_row = p[None, :].contiguous()
    read_k, read_v, row_map = pool_k, pool_v, None
    if ctx.kv_sharded:
        read_k, read_v = _virtual_pools(ctx, pool_k, pool_v, table_row[None])
        row_map = torch.zeros(1, device=dev, dtype=torch.int32)
    out = paged_attention(
        q.reshape(1, C, -1).contiguous(), read_k, read_v, _i32(table_row[None]),
        start.reshape(1), p_row,
        k_new[0].to(q.dtype).contiguous(), v_new[0].to(q.dtype).contiguous(), p_row,
        row_map, **_spec_args(cfg, cache_spec, window))
    k_rows, v_rows = pool_rows(k_new[0], v_new[0], pool_k, cache_spec)
    _write(ctx, pool_k, pool_v, k_rows, v_rows, blk, pl % bs)
    y = row_linear(ctx, out, params["wo"]["w"], n_tokens=B * C)
    return y, pool_k, pool_v


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
    pools in place; pad rows write into the reserved null block 0. Sharded
    pools: ONE region per slot is exchanged (the slots' resident context,
    not one per token) and token t reads region ``slot_ids[t]``.
    Returns (out (1, T, d_model), pool_k, pool_v).
    """
    B, T = x.shape[:2]
    quantized = cache_spec is not None and cache_spec.quantized
    dev = x.device

    q, k_new, v_new = _qkv(ctx, params, x, cfg, positions[None, :])
    sid = slot_ids.long()
    my_tables = _i32(tables[sid])                         # (T, max_blocks)
    nb = tables.shape[1]
    bs = _block_size(pool_k)
    cap = nb * bs
    start = _i32(slot_starts[sid])                         # (T,)

    k_rows, v_rows = pool_rows(k_new[0], v_new[0], pool_k, cache_spec)
    if quantized:
        k_rt = ops.mx_dequantize(k_rows, cache_spec.mx, out_dtype=q.dtype)
        v_rt = ops.mx_dequantize(v_rows, cache_spec.mx, out_dtype=q.dtype)
    else:
        k_rt, v_rt = k_rows.to(q.dtype), v_rows.to(q.dtype)

    # in-batch K/V: decode tokens read their own write back at pool
    # precision; prefill tokens stay in compute precision
    dec = is_decode[:, None]
    k_step = torch.where(dec, k_rt, k_new[0].to(q.dtype)).contiguous()
    v_step = torch.where(dec, v_rt, v_new[0].to(q.dtype)).contiguous()
    same = (slot_ids[None, :] == slot_ids[:, None]) & valid[None, :]
    t_step = _i32(torch.where(same, positions[None, :], T_INVALID))   # (T, T)

    # the paged read: the gather-free kernel on the card, its plain version
    # (the pool[my_tables] gather) on the CPU
    read_k, read_v, row_map = pool_k, pool_v, None
    if ctx.kv_sharded:
        read_k, read_v = _virtual_pools(ctx, pool_k, pool_v, tables)
        row_map = _i32(slot_ids)
    out = paged_attention(
        q[0].reshape(T, 1, -1).contiguous(), read_k, read_v, my_tables, start,
        _i32(positions[:, None]), k_step, v_step, t_step, row_map,
        **_spec_args(cfg, cache_spec, window))
    out = out[:, 0][None]                                # (1, T, H*hd)

    # append every real token's K/V; pads fall into the null block
    col = (positions.long() // bs).clamp(0, nb - 1)
    blk = torch.where(valid & (positions < cap),
                      my_tables[torch.arange(T, device=dev), col].long(),
                      torch.zeros((), dtype=torch.long, device=dev))
    _write(ctx, pool_k, pool_v, k_rows, v_rows, blk, (positions % bs).long())

    y = row_linear(ctx, out, params["wo"]["w"], n_tokens=B * T)
    return y, pool_k, pool_v
