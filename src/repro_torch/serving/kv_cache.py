"""Paged KV cache of the port: host-side block allocator, mixed-step batch
geometry, device pool state and sizing (the reference's
``serving/kv_cache.py`` without the prefix index and sharded pools).

Every attention layer owns a block pool ``(n_blocks, block_size, kv_dim)``
for K and V (dense, or MX wire payload + scales); a slot's logical sequence
is the concatenation of the blocks its block-table row names. Block 0 is the
reserved null block that pads and unallocated table entries point at.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import KVCacheSpec, MXSpec
from repro_torch.core.mx import MXCompressed, wire_arrays_shape

__all__ = ["BlockAllocator", "NULL_BLOCK", "MixedBatch", "build_mixed_batch",
           "init_paged_state", "check_cache_spec", "paged_cache_bytes",
           "attn_layer_count"]

NULL_BLOCK = 0


class BlockAllocator:
    """Host-side refcounted free list over the KV block pool.

    Allocation and release never touch device memory; a block id is an index
    into the pools' leading dim. Block 0 is never handed out. Every
    transition validates its ids, so a scheduler bug that over-releases
    raises instead of handing one block to two requests.
    """

    def __init__(self, n_blocks: int):
        assert n_blocks >= 2, "need at least one allocatable block"
        self.n_blocks = n_blocks
        self._free: collections.deque = collections.deque(range(1, n_blocks))
        self._ref: Dict[int, int] = {}
        self.high_water = 0  # max blocks referenced at once

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return (self.n_blocks - 1) - self.n_free

    def refcount(self, block: int) -> int:
        return self._ref.get(int(block), 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` ids at refcount 1, or None (and no change) if short."""
        if n > self.n_free:
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        self.high_water = max(self.high_water, self.n_allocated)
        return ids

    def alloc_to(self, blocks: List[int], n_needed: int) -> Optional[List[int]]:
        """Extend ``blocks`` in place to cover ``n_needed`` blocks; returns the
        new ids ([] when covered) or None (no change) when the pool is short."""
        got = self.alloc(max(0, n_needed - len(blocks)))
        if got is None:
            return None
        blocks.extend(got)
        return got

    def _check_id(self, b: int, verb: str) -> int:
        b = int(b)
        if b == NULL_BLOCK:
            raise ValueError(f"{verb} of reserved NULL_BLOCK (block 0)")
        if not 0 < b < self.n_blocks:
            raise ValueError(f"{verb} of out-of-range block id {b} (pool has "
                             f"{self.n_blocks} blocks)")
        return b

    def share(self, ids: Sequence[int]) -> None:
        """Add one reference per id (ids must be allocated)."""
        counts = collections.Counter(self._check_id(b, "share") for b in ids)
        for b in counts:
            if b not in self._ref:
                raise ValueError(f"share of unallocated block {b}")
        for b, c in counts.items():
            self._ref[b] += c
        self.high_water = max(self.high_water, self.n_allocated)

    def release(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; at refcount 0 the block is free again.
        Over-release, the null block and garbage ids raise before any change."""
        counts = collections.Counter(self._check_id(b, "release") for b in ids)
        for b, c in counts.items():
            if c > self._ref.get(b, 0):
                raise ValueError(f"release of block {b} exceeds its refcount "
                                 f"({c} > {self._ref.get(b, 0)}) — double release?")
        for b, c in counts.items():
            self._ref[b] -= c
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)


def attn_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for spec in cfg.layers if spec.kind == "attn")


@dataclasses.dataclass
class MixedBatch:
    """Host-side flattened inputs of one mixed token-budget step; every array
    is fixed-shape in ``(token_budget, n_slots)``."""

    tokens: np.ndarray      # (1, token_budget) int32, right-padded
    slot_ids: np.ndarray    # (token_budget,) int32 owning slot (0 for pads)
    positions: np.ndarray   # (token_budget,) int32 sequence positions
    valid: np.ndarray       # (token_budget,) bool — False rows are pads
    is_decode: np.ndarray   # (token_budget,) bool — decode vs prefill token
    sample_idx: np.ndarray  # (n_slots,) int32 flat index each slot samples
    n_prefill: int          # real prefill tokens packed
    n_decode: int           # real decode tokens packed


def build_mixed_batch(prefill_segs: Sequence[Tuple[int, np.ndarray, int]],
                      decode_slots: Sequence[Tuple[int, int, int]],
                      token_budget: int, n_slots: int) -> MixedBatch:
    """Flatten a step's packing plan: ``prefill_segs`` are ``(slot,
    chunk_tokens, start_pos)`` per prefilling slot, ``decode_slots`` are
    ``(slot, cur_token, position)`` per decoding slot; prefill first, then
    decode tokens, right-padded to ``token_budget``. Raises if the plan
    exceeds the budget or packs a slot twice."""
    total = sum(len(toks) for _, toks, _ in prefill_segs) + len(decode_slots)
    if total > token_budget:
        raise ValueError(f"packed step ({total} tokens) exceeds token_budget "
                         f"({token_budget})")
    seen = [s for s, _, _ in prefill_segs] + [s for s, _, _ in decode_slots]
    if len(set(seen)) != len(seen):
        raise ValueError(f"slot packed twice in one step: {sorted(seen)}")
    tokens = np.zeros((1, token_budget), np.int32)
    slot_ids = np.zeros((token_budget,), np.int32)
    positions = np.zeros((token_budget,), np.int32)
    valid = np.zeros((token_budget,), bool)
    is_decode = np.zeros((token_budget,), bool)
    sample_idx = np.zeros((n_slots,), np.int32)
    o = 0
    for slot, toks, start in prefill_segs:
        n = len(toks)
        tokens[0, o:o + n] = toks
        slot_ids[o:o + n] = slot
        positions[o:o + n] = np.arange(start, start + n, dtype=np.int32)
        valid[o:o + n] = True
        sample_idx[slot] = o + n - 1
        o += n
    for slot, cur, pos in decode_slots:
        tokens[0, o] = cur
        slot_ids[o] = slot
        positions[o] = pos
        valid[o] = True
        is_decode[o] = True
        sample_idx[slot] = o
        o += 1
    return MixedBatch(tokens=tokens, slot_ids=slot_ids, positions=positions,
                      valid=valid, is_decode=is_decode, sample_idx=sample_idx,
                      n_prefill=total - len(decode_slots), n_decode=len(decode_slots))


def check_cache_spec(cfg: ModelConfig,
                     cache_spec: "KVCacheSpec | MXSpec | str | None") -> KVCacheSpec:
    """Validate a (possibly stringy) cache spec against the model geometry."""
    cache_spec = KVCacheSpec.parse(cache_spec)
    if cache_spec.quantized and cfg.kv_dim % cache_spec.mx.block_size != 0:
        raise ValueError(
            f"cache spec {cache_spec.mx.name}: kv_dim={cfg.kv_dim} is not divisible "
            f"by MX block size {cache_spec.mx.block_size}; pick a smaller block "
            f"(e.g. 'fp4_e2m1_b8_e8m0')")
    return cache_spec


def _wire_pool(n_blocks: int, block_size: int, kv_dim: int, spec: MXSpec,
               device: torch.device) -> MXCompressed:
    p_shape, s_shape = wire_arrays_shape((n_blocks, block_size, kv_dim), spec)
    return MXCompressed(payload=torch.zeros(p_shape, dtype=torch.uint8, device=device),
                        scales=torch.zeros(s_shape, dtype=torch.uint8, device=device))


def init_paged_state(cfg: ModelConfig, n_slots: int, n_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     cache_spec: Optional[KVCacheSpec] = None,
                     device: str | torch.device = "cuda") -> dict:
    """Device-side cache state: one K and one V pool per attention layer,
    dense at ``dtype`` or MX wire pairs when ``cache_spec`` is quantized.
    (``n_slots`` is kept for the reference's signature: dense stacks carry
    no per-slot recurrent state.)"""
    del n_slots
    cache_spec = check_cache_spec(cfg, cache_spec)
    if any(spec.kind != "attn" for spec in cfg.layers):
        raise NotImplementedError("paged state for recurrent layers is not ported yet")
    pools_k, pools_v = [], []
    for _ in cfg.layers:
        for pools in (pools_k, pools_v):
            if cache_spec.quantized:
                pools.append(_wire_pool(n_blocks, block_size, cfg.kv_dim, cache_spec.mx,
                                        torch.device(device)))
            else:
                pools.append(torch.zeros((n_blocks, block_size, cfg.kv_dim), dtype=dtype,
                                         device=device))
    return {"pools_k": pools_k, "pools_v": pools_v}


def paged_cache_bytes(cfg: ModelConfig, n_blocks: int, block_size: int,
                      dtype_bytes: int = 2,
                      cache_spec: Optional[KVCacheSpec] = None) -> int:
    """Bytes held by the paged pools: ``kv_dim * dtype_bytes`` per position
    dense, the wire bytes (packed payload + one scale byte per block) MX."""
    cache_spec = KVCacheSpec.parse(cache_spec)
    if cache_spec.quantized:
        pos_bytes = cache_spec.mx.wire_bytes(cfg.kv_dim)
    else:
        pos_bytes = cfg.kv_dim * dtype_bytes
    return 2 * attn_layer_count(cfg) * n_blocks * block_size * pos_bytes
