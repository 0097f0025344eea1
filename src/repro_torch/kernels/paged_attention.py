"""Gather-free paged GQA attention: the CUDA kernel's wrapper and its plain
version.

One function serves every paged read geometry of ``models/attention.py``:
decode (R=B, Sq=1, no extras), chunk (R=1, Sq=C, extras = the chunk) and the
mixed token-budget step (R=T, Sq=1, extras = the step's K/V under the
same-slot position mask). With ``row_map`` (sequence-sharded pools) the
pools are the virtual pools of ``core.tp.pool_exchange`` and row r's block
j is virtual row ``row_map[r] * nb + j`` instead of ``tables[r, j]`` (only
``tables``' width ``nb`` is read). Row r attends pool positions ``t < hist_len[r]``
(causally against ``q_pos[r]``, optionally window-limited) at pool
precision, plus ``k_extra`` rows at positions ``t_extra[r]`` in compute
precision. Masking uses the finite ``NEG_INF = -1e30``: a row with no valid
key averages every key it addresses, as in the reference.

For a CUDA tensor ``paged_attention`` launches ``csrc/paged_attention.cu``
(which walks the block tables, or the ``row_map`` regions, itself and
stages each key tile once for all consecutive rows that share a table or a
region; any GQA group, head_dim a multiple of 32 up to 256) or raises; the
plain version, which gathers ``pool[tables]`` (or the virtual rows) at full
capacity, runs only for CPU tensors and as the kernel's reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mx as _mx
from repro_torch.core.formats import MXSpec
from repro_torch.core.mx import MXCompressed, code_tables
from repro_torch.kernels.build import check_launch, count_launch, load_kernels, stream_ptr

__all__ = ["paged_attention", "paged_attention_plain", "attend_block", "block_rows",
           "NEG_INF", "T_INVALID"]

NEG_INF = -1e30
T_INVALID = 2**30  # position of a key that no query may attend


def block_rows(tables: torch.Tensor, row_map: Optional[torch.Tensor]) -> torch.Tensor:
    """(R, nb) pool rows the read walks: ``tables``, or under ``row_map``
    the virtual rows ``row_map[r] * nb + j``."""
    if row_map is None:
        return tables
    nb = tables.shape[1]
    return (row_map.long()[:, None] * nb
            + torch.arange(nb, device=tables.device)[None]).to(torch.int32)


def _gather_pool(pool, tables: torch.Tensor, spec: Optional[MXSpec]) -> torch.Tensor:
    """pool[tables] -> (R, nb*bs, kv_dim) float32 (MX pools dequantized)."""
    R, nb = tables.shape
    idx = tables.long()
    if spec is None:
        bs = pool.shape[1]
        return pool[idx].reshape(R, nb * bs, -1).float()
    bs = pool.payload.shape[1]
    wire = MXCompressed(pool.payload[idx].reshape(R, nb * bs, -1),
                        pool.scales[idx].reshape(R, nb * bs, -1))
    return _mx.dequantize(wire, spec, torch.float32)


def paged_attention_plain(q, pool_k, pool_v, tables, hist_len, q_pos, k_extra=None,
                          v_extra=None, t_extra=None, row_map=None, *,
                          spec: Optional[MXSpec] = None, kv_heads: int, scale: float,
                          window: Optional[int] = None,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: gather each row's table blocks (its virtual
    rows under ``row_map``), concatenate the extras, masked softmax in fp32.
    Returns (R, Sq, H*hd) in ``out_dtype`` (default q's dtype)."""
    R, Sq, q_dim = q.shape
    rows = block_rows(tables, row_map)
    keys = _gather_pool(pool_k, rows, spec)
    vals = _gather_pool(pool_v, rows, spec)
    cap, kv_dim = keys.shape[1], keys.shape[2]
    t = torch.arange(cap, device=q.device, dtype=torch.int32)[None, :]
    t_pos = torch.where(t < hist_len.to(torch.int32)[:, None], t, T_INVALID)
    if k_extra is not None:
        E = k_extra.shape[0]
        keys = torch.cat([keys, k_extra.float()[None].expand(R, E, kv_dim)], dim=1)
        vals = torch.cat([vals, v_extra.float()[None].expand(R, E, kv_dim)], dim=1)
        t_pos = torch.cat([t_pos.expand(R, cap),
                           t_extra.to(torch.int32).expand(R, E)], dim=1)
    hd = kv_dim // kv_heads
    out = attend_block(q.float().reshape(R, Sq, q_dim // hd, hd), keys, vals,
                       q_pos.to(torch.int32), t_pos.expand(R, keys.shape[1]),
                       window=window, scale=scale, kv_heads=kv_heads)
    return out.to(out_dtype or q.dtype)


def attend_block(q, k, v, q_pos, t_pos, *, window, scale, kv_heads, causal=True):
    """Masked GQA attention, the reference's ``_attend_block``: q (B, Sq, H,
    hd); k/v flat (B, T, kv_dim); q_pos (B, Sq); t_pos (B, T). Key t is
    valid for query s when t_pos <= q_pos (``causal``; else when t_pos >=
    0), and t_pos > q_pos - window; masked scores are NEG_INF. Returns (B,
    Sq, H*hd) in v's dtype."""
    B, Sq, H, hd = q.shape
    T = k.shape[1]
    G = H // kv_heads
    qg = q.reshape(B, Sq, kv_heads, G, hd)
    kh = k.reshape(B, T, kv_heads, hd)
    vh = v.reshape(B, T, kv_heads, hd)
    scores = torch.einsum("bsngd,btnd->bnsgt", qg, kh).float() * scale
    tp = t_pos[:, None, :]                                      # (B, 1, T)
    qp = q_pos[:, :, None]                                      # (B, Sq, 1)
    valid = tp <= qp if causal else (tp >= 0).expand(B, Sq, T)
    if window is not None:
        valid = valid & (tp > qp - window)
    scores = torch.where(valid[:, None, :, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bnsgt,btnd->bsngd", probs, vh).reshape(B, Sq, H * hd)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def _i32(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    _require(t.dtype == torch.int32 and t.is_contiguous() and tuple(t.shape) == tuple(shape),
             f"{name} must be a contiguous int32 tensor of shape {tuple(shape)}, got "
             f"{tuple(t.shape)} {t.dtype}")
    return t


def paged_attention(q, pool_k, pool_v, tables, hist_len, q_pos, k_extra=None,
                    v_extra=None, t_extra=None, row_map=None, *,
                    spec: Optional[MXSpec] = None, kv_heads: int, scale: float,
                    window: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Gather-free paged attention, ``(R, Sq, H*hd)``; see the module doc.

    q (R, Sq, H*hd); pools (n_blocks, bs, kv_dim) dense or ``MXCompressed``
    wire pools; tables (R, nb) int32; hist_len (R,) int32; q_pos (R, Sq)
    int32; k_extra/v_extra (E, kv_dim) in q's dtype; t_extra (R, E) int32;
    row_map (R,) int32 or None. Under ``row_map`` the pools are virtual
    pools whose rows come in regions of nb blocks (n_blocks a multiple of
    nb); the kernel reads neither ``tables`` nor anything past the regions
    ``row_map`` names (not checked: that would need a device sync).
    """
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pool_k, pool_v, tables, hist_len, q_pos, k_extra, v_extra, t_extra,
            row_map, spec=spec, kv_heads=kv_heads, scale=scale, window=window,
            out_dtype=out_dtype)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    _require(q.dim() == 3 and q.is_contiguous() and q.dtype in (torch.float32, torch.bfloat16),
             f"q must be a contiguous (R, Sq, H*hd) fp32/bf16 tensor, got "
             f"{tuple(q.shape)} {q.dtype}")
    _require(out_dtype in (None, q.dtype), "the kernel writes q's dtype")
    R, Sq, q_dim = q.shape
    if spec is None:
        _require(pool_k.dtype in (torch.float32, torch.bfloat16) and pool_v.dtype == pool_k.dtype,
                 "dense pools must be fp32 or bf16")
        arrays = [pool_k, pool_v]
        n_pool, bs, kv_dim = pool_k.shape
        pool_kind, bits, n_codes, mx_block, bias, vals = int(pool_k.dtype == torch.bfloat16), \
            0, 0, 1, 0, None
        ks = vs = None
    else:
        arrays = [pool_k.payload, pool_k.scales, pool_v.payload, pool_v.scales]
        _require(all(a.dtype == torch.uint8 for a in arrays), "wire pools must be uint8")
        n_pool, bs, pbytes = pool_k.payload.shape
        kv_dim = pbytes * 8 // spec.elem.bits
        _require(kv_dim % spec.block_size == 0 and spec.elem.num_codes <= 256
                 and tuple(pool_k.scales.shape) == (n_pool, bs, kv_dim // spec.block_size),
                 f"wire pools do not describe a {spec.name} pool")
        pool_kind, bits, n_codes = 2, spec.elem.bits, spec.elem.num_codes
        mx_block, bias = spec.block_size, spec.scale.bias
        _, vals = code_tables(spec, q.device)
        ks, vs = pool_k.scales, pool_v.scales
        pool_k, pool_v = pool_k.payload, pool_v.payload
    _require(all(a.is_contiguous() and a.device == q.device for a in arrays),
             "pools must be contiguous and on q's device")
    _require(kv_dim % kv_heads == 0, "kv_dim must split into kv_heads")
    hd = kv_dim // kv_heads
    _require(hd % 32 == 0 and 0 < hd <= 256,
             f"head_dim {hd}: the kernel takes multiples of 32 up to 256")
    _require(q_dim % hd == 0 and (q_dim // hd) % kv_heads == 0, "query heads must group over kv heads")
    H = q_dim // hd
    nb = tables.shape[1]
    if row_map is None:
        _i32(tables, (R, nb), "tables")
    else:
        _require(tables.dim() == 2 and tables.shape[0] == R, "tables must be (R, nb)")
        _i32(row_map, (R,), "row_map")
        _require(row_map.device == q.device, "row_map must be on q's device")
        _require(nb > 0 and n_pool % nb == 0,
                 f"virtual pools of {n_pool} blocks do not hold regions of {nb} blocks")
    _i32(hist_len, (R,), "hist_len")
    _i32(q_pos, (R, Sq), "q_pos")
    E = 0
    if k_extra is not None:
        E = k_extra.shape[0]
        for name, e in (("k_extra", k_extra), ("v_extra", v_extra)):
            _require(e.dtype == q.dtype and e.is_contiguous() and tuple(e.shape) == (E, kv_dim),
                     f"{name} must be a contiguous ({E}, {kv_dim}) tensor in q's dtype")
        _i32(t_extra, (R, E), "t_extra")
    out = torch.empty_like(q)
    if R == 0 or Sq == 0:
        return out
    vectors = [q, out, *arrays] + ([k_extra, v_extra] if E else [])
    _require(all(t.data_ptr() % 16 == 0 for t in vectors),
             "q, out, pools and extras must start on 16-byte boundaries")
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = load_kernels().mxk_paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), ptr(ks), ptr(vs),
        ptr(tables if row_map is None else None), ptr(row_map), hist_len.data_ptr(),
        q_pos.data_ptr(), ptr(k_extra), ptr(v_extra), ptr(t_extra), out.data_ptr(), ptr(vals),
        R, Sq, H, kv_heads, hd, bs, kv_dim, nb, E, n_codes, bits, mx_block, bias,
        int(window or 0), float(scale), int(q.dtype == torch.bfloat16), pool_kind,
        stream_ptr())
    check_launch("paged_attention", err)
    count_launch("paged_attention")
    return out
