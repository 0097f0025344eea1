"""Paged KV cache of the port: host-side block allocator and prefix index,
mixed-step batch geometry, device pool state and sizing (the reference's
``serving/kv_cache.py``; sequence-sharded pools keep one free list per kv
shard).

Every attention layer owns a block pool ``(n_blocks, block_size, kv_dim)``
for K and V (dense, or MX wire payload + scales); a slot's logical sequence
is the concatenation of the blocks its block-table row names. Block 0 is the
reserved null block that pads and unallocated table entries point at. Every
recurrent layer owns one slot-batched recurrent cache (``rec``, ``n_slots``
rows, fp32 whatever the pools' format): a Mamba layer its conv history and
state, an mLSTM layer its (C, n, m) and conv history, an sLSTM layer its
(c, n, m, h). An xLSTM stack has no attention layer, so no pools. An
encoder-decoder's decoder layers each own the slots' cross-attention K/V
(``cross_k`` / ``cross_v``: ``(n_slots, encoder_seq, kv_dim)``, dense in the
pools' dense dtype even beside MX pools, as the reference holds them).

Block ownership is refcounted (``BlockAllocator``) so automatic prefix
caching (``PrefixIndex``) can map one block into many block tables: full
prompt blocks are published under rolling token-chain hashes, matched at
admission, and kept in an LRU at refcount 0 for later hits.
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

__all__ = ["BlockAllocator", "PrefixIndex", "NULL_BLOCK", "MixedBatch",
           "build_mixed_batch", "init_paged_state", "zero_paged_state", "check_cache_spec",
           "paged_cache_bytes", "recurrent_state_bytes", "cross_state_bytes",
           "attn_layer_count"]

NULL_BLOCK = 0


class PrefixIndex:
    """Hash-chain index over FULL prompt blocks -> resident block ids (the
    reference's ``PrefixIndex``).

    Block ``j`` of a prompt is keyed by the rolling hash of tokens ``[0,
    (j+1)*block_size)`` (``chain``), so a hit on block ``j`` certifies the
    whole token prefix up to it. Block content is deterministic given the
    chain (dense pools hold the computed values, wire pools deterministic
    post-quantization bytes), so sharing by reference is sound in both modes.

    A registered block is ACTIVE while some slot holds a reference, and
    CACHED at refcount 0: it keeps its pool bytes and sits in an LRU
    (``n_cached``) that the allocator reclaims lazily, coldest first, only
    when its free list runs dry (``pop_lru``).
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_hash: Dict[int, int] = {}     # chain hash -> block id
        self._by_block: Dict[int, int] = {}    # block id -> chain hash
        # refcount-0 registered blocks, insertion order = cold .. hot
        self._lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self.hit_blocks = 0      # blocks mapped into slot tables (engine-kept)
        self.evicted_blocks = 0  # cached blocks recycled under pressure

    def __len__(self) -> int:
        return len(self._by_hash)

    @property
    def n_cached(self) -> int:
        """Registered blocks at refcount 0 (lazily reclaimable)."""
        return len(self._lru)

    @staticmethod
    def chain(tokens, block_size: int) -> List[int]:
        """Rolling hashes of every FULL token block: entry ``j`` keys tokens
        ``[0, (j+1)*block_size)``; a trailing partial block is not hashed."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        h = hash(("kv-prefix-chain", block_size))
        out = []
        for j in range(len(toks) // block_size):
            h = hash((h, toks[j * block_size:(j + 1) * block_size].tobytes()))
            out.append(h)
        return out

    def match(self, hashes: Sequence[int]) -> List[int]:
        """Longest indexed prefix of ``hashes`` -> block ids (a pure lookup:
        the caller shares what it keeps)."""
        ids = []
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None:
                break
            ids.append(b)
        return ids

    def register(self, h: int, block: int) -> bool:
        """Publish a fully written prompt block. False (no change) when the
        hash is already served by another block or the block is registered."""
        if h in self._by_hash or block in self._by_block:
            return False
        self._by_hash[h] = block
        self._by_block[block] = h
        return True

    def contains_block(self, block: int) -> bool:
        return block in self._by_block

    def is_cached(self, block: int) -> bool:
        return block in self._lru

    def deactivate(self, block: int) -> None:
        """Refcount reached 0: park the block in the LRU instead of freeing."""
        self._lru[block] = None
        self._lru.move_to_end(block)

    def activate(self, block: int) -> None:
        """A cached block was matched again: take it out of the LRU."""
        del self._lru[block]

    def pop_lru(self, n: int) -> List[int]:
        """Recycle up to ``n`` coldest cached blocks (their index entries go)."""
        out = []
        while self._lru and len(out) < n:
            b, _ = self._lru.popitem(last=False)
            del self._by_hash[self._by_block.pop(b)]
            out.append(b)
        self.evicted_blocks += len(out)
        return out


class BlockAllocator:
    """Host-side refcounted free list over the KV block pool.

    Allocation and release never touch device memory; a block id is an index
    into the pools' leading dim. Block 0 is never handed out. ``alloc`` hands
    out blocks at refcount 1, ``share`` adds a holder, ``release`` drops one.
    With a ``PrefixIndex`` attached, a registered block that reaches
    refcount 0 parks in the index's LRU with its bytes kept, and ``alloc``
    reclaims such blocks only after the free list runs dry. Every transition
    validates its ids, so a scheduler bug that over-releases raises instead
    of handing one block to two requests. Fault injection may ``hold``
    free blocks out of circulation (``n_held``) until ``unhold``.

    Sequence-sharded pools (``shards > 1``): the block dim is split
    contiguously over the kv ranks, so global id ``b`` belongs to shard ``b
    // per_shard``. The allocator keeps one free deque per shard and hands
    blocks out round-robin across shards (skipping dry ones) for residency
    balance; ``release``, ``unhold`` and lazy reclaim return every id to its
    owner's deque, so each shard's free, held, referenced and cached blocks
    always sum to its capacity. ``shards == 1`` is one FIFO deque. Every kv
    rank runs the same allocator on the same calls, so all make the same
    choices.
    """

    def __init__(self, n_blocks: int, prefix_index: Optional[PrefixIndex] = None,
                 *, shards: int = 1):
        assert n_blocks >= 2, "need at least one allocatable block"
        assert shards >= 1 and n_blocks % shards == 0, (
            f"pool capacity {n_blocks} must divide over {shards} kv shards")
        self.n_blocks = n_blocks
        self.shards = shards
        self.per_shard = n_blocks // shards
        self.index = prefix_index
        self._free: List[collections.deque] = [collections.deque() for _ in range(shards)]
        for b in range(1, n_blocks):
            self._free[b // self.per_shard].append(b)
        self._n_free = n_blocks - 1
        self._cursor = 0                   # next shard to hand a block from
        self._ref: Dict[int, int] = {}
        self._held: List[int] = []         # fault-injection holds (see hold())
        self.high_water = 0  # max blocks referenced at once

    def shard_of(self, block: int) -> int:
        """Owning kv shard of a global block id (contiguous split)."""
        return int(block) // self.per_shard

    @property
    def free_per_shard(self) -> List[int]:
        """Free-list length per kv shard."""
        return [len(d) for d in self._free]

    def _pop_free(self, n: int) -> List[int]:
        """Pop ``n`` free ids round-robin across shards, skipping dry ones
        (the caller checked ``n <= n_free``); one shard: plain FIFO."""
        ids = []
        for _ in range(n):
            for _ in range(self.shards):
                d = self._free[self._cursor]
                self._cursor = (self._cursor + 1) % self.shards
                if d:
                    ids.append(d.popleft())
                    break
        self._n_free -= len(ids)
        return ids

    def _push_free(self, block: int) -> None:
        self._free[self.shard_of(block)].append(block)
        self._n_free += 1

    @property
    def n_free(self) -> int:
        """Immediately allocatable blocks (the free lists only)."""
        return self._n_free

    @property
    def n_cached(self) -> int:
        """Refcount-0 blocks kept by the prefix index (lazily reclaimable)."""
        return self.index.n_cached if self.index is not None else 0

    @property
    def n_available(self) -> int:
        """The most ``alloc`` can hand out: free + cached."""
        return self.n_free + self.n_cached

    @property
    def n_allocated(self) -> int:
        """Blocks with at least one live reference."""
        return (self.n_blocks - 1) - self.n_free - self.n_cached - len(self._held)

    @property
    def n_held(self) -> int:
        """Blocks held out of the free list by fault injection (``hold``):
        unallocatable and referenced by no request. Nonzero means the pool
        pressure is synthetic, so exhaustion sites defer instead of raising."""
        return len(self._held)

    def hold(self, n: int = 0) -> int:
        """Fault injection: take up to ``n`` free blocks (every free block
        when ``n <= 0``) out of the free list; returns how many. Held blocks
        move only between the free list and the hold, never through
        refcounts or the prefix index, so ``unhold`` conserves the pool."""
        take = self.n_free if n <= 0 else min(n, self.n_free)
        self._held.extend(self._pop_free(take))
        return take

    def unhold(self) -> int:
        """Return every held block to its shard's free list; returns how many."""
        n = len(self._held)
        for b in self._held:
            self._push_free(b)
        self._held.clear()
        return n

    def refcount(self, block: int) -> int:
        return self._ref.get(int(block), 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` ids at refcount 1, or None (and no change) if short. The
        free list goes first; cached blocks are reclaimed, coldest first,
        only to cover a shortfall."""
        if n > self.n_available:
            return None
        if n > self.n_free:
            for b in self.index.pop_lru(n - self.n_free):
                self._push_free(b)
        ids = self._pop_free(n)
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
        """Add one reference per id: to an ACTIVE block, or to a CACHED one,
        which leaves the index LRU at refcount 1. A free or unknown id
        raises before any change."""
        counts = collections.Counter(self._check_id(b, "share") for b in ids)
        for b in counts:
            if b not in self._ref and not (self.index is not None
                                           and self.index.is_cached(b)):
                raise ValueError(f"share of unallocated block {b}")
        for b, c in counts.items():
            if b not in self._ref:     # CACHED -> ACTIVE
                self.index.activate(b)
                self._ref[b] = 0
            self._ref[b] += c
        self.high_water = max(self.high_water, self.n_allocated)

    def release(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; at refcount 0 the block is free again
        (on its shard's list), or parks in the index LRU if it is registered
        there. Over-release, the null block and garbage ids raise before any
        change."""
        counts = collections.Counter(self._check_id(b, "release") for b in ids)
        for b, c in counts.items():
            if c > self._ref.get(b, 0):
                raise ValueError(f"release of block {b} exceeds its refcount "
                                 f"({c} > {self._ref.get(b, 0)}) — double release?")
        for b, c in counts.items():
            self._ref[b] -= c
            if self._ref[b] == 0:
                del self._ref[b]
                if self.index is not None and self.index.contains_block(b):
                    self.index.deactivate(b)   # bytes kept for later hits
                else:
                    self._push_free(b)


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
    """Device-side cache state: ``pools_k`` / ``pools_v``, one K and one V
    pool per attention layer, dense at ``dtype`` or MX wire pairs when
    ``cache_spec`` is quantized; ``rec``, one slot-batched ``MambaCache``,
    ``MLSTMCache`` or ``SLSTMCache`` of ``n_slots`` rows per recurrent
    layer, in layer order, always fp32 (the reference's ``init_layer_cache``
    default: recurrent state is O(slots), not O(tokens)); for an
    encoder-decoder, ``cross_k`` / ``cross_v``, one ``(n_slots,
    encoder_seq, kv_dim)`` tensor of ``dtype`` per decoder layer, on MX
    pools too (the reference's). Every size follows ``cfg``: on a TP
    group's rank-local config, this rank's kv heads of the pools and of the
    cross K/V, and its channels and heads of the recurrent state (an sLSTM
    layer's whole)."""
    from repro_torch.models.transformer import init_layer_cache

    cache_spec = check_cache_spec(cfg, cache_spec)
    pools_k, pools_v, rec = [], [], []
    for spec in cfg.layers:
        if spec.kind != "attn":
            rec.append(init_layer_cache(cfg, spec, n_slots, 0, device=device))
            continue
        for pools in (pools_k, pools_v):
            if cache_spec.quantized:
                pools.append(_wire_pool(n_blocks, block_size, cfg.kv_dim, cache_spec.mx,
                                        torch.device(device)))
            else:
                pools.append(torch.zeros((n_blocks, block_size, cfg.kv_dim), dtype=dtype,
                                         device=device))
    state = {"pools_k": pools_k, "pools_v": pools_v, "rec": rec}
    if cfg.encoder_decoder:
        for key in ("cross_k", "cross_v"):
            state[key] = [torch.zeros((n_slots, cfg.encoder_seq, cfg.kv_dim), dtype=dtype,
                                      device=device) for _ in cfg.layers]
    return state


def zero_paged_state(state: dict) -> None:
    """Put every pool plane and recurrent cache of ``state`` back to what
    ``init_paged_state`` returns, in place, at the same addresses (a
    captured step program keeps reading and writing those): zeros, and an
    xLSTM cache's stabilizer ``m`` at its start value."""
    from repro_torch.models.xlstm import reset_cache

    for pool in state["pools_k"] + state["pools_v"]:
        for plane in ((pool.payload, pool.scales) if isinstance(pool, MXCompressed)
                      else (pool,)):
            plane.zero_()
    for cache in state.get("rec", []):
        reset_cache(cache)
    for t in state.get("cross_k", []) + state.get("cross_v", []):
        t.zero_()


def recurrent_state_bytes(cfg: ModelConfig, n_slots: int) -> int:
    """Bytes of the slot-batched recurrent caches (``rec``), fp32, per slot:
    a Mamba layer's conv history ``(d_conv - 1) x d_inner`` and state
    ``d_inner x N``; an mLSTM layer's ``H x (dh^2 + dh + 1)`` of (C, n, m)
    and its conv history ``(xlstm_conv - 1) x d_inner``; an sLSTM layer's
    ``4 x d_model`` of (c, n, m, h) (the reference's ``cache_bytes`` terms).
    Rank-local on a TP group's config: this rank's Mamba channels, mLSTM
    heads and channels, and the whole sLSTM state."""
    def values(kind: str) -> int:
        if kind == "mamba":
            return (cfg.ssm_d_conv - 1) * cfg.ssm_d_inner + cfg.ssm_d_inner * cfg.ssm_d_state
        if kind == "mlstm":
            di, H = cfg.mlstm_d_inner, cfg.mlstm_heads
            return H * ((di // H) ** 2 + di // H + 1) + (cfg.xlstm_conv - 1) * di
        return 4 * cfg.d_model if kind == "slstm" else 0

    return n_slots * 4 * sum(values(spec.kind) for spec in cfg.layers)


def cross_state_bytes(cfg: ModelConfig, n_slots: int, dtype_bytes: int = 2) -> int:
    """Bytes of an encoder-decoder's per-slot cross K/V (``cross_k`` /
    ``cross_v``): the reference's ``cache_bytes`` term, 2 x n_layers x
    n_slots x encoder_seq x kv_dim values of ``dtype_bytes`` (0 for a
    decoder); one rank's share on a TP group's rank-local config."""
    if not cfg.encoder_decoder:
        return 0
    return 2 * cfg.n_layers * n_slots * cfg.encoder_seq * cfg.kv_dim * dtype_bytes


def paged_cache_bytes(cfg: ModelConfig, n_blocks: int, block_size: int,
                      dtype_bytes: int = 2,
                      cache_spec: Optional[KVCacheSpec] = None, *,
                      kv_shards: int = 1, per_device: bool = False,
                      n_slots: int = 0) -> int:
    """Bytes held by the paged pools: ``kv_dim * dtype_bytes`` per position
    dense, the wire bytes (packed payload + one scale byte per block) MX.
    The global pools by default; ``per_device=True`` gives what one kv rank
    holds of ``kv_shards`` (``n_blocks / kv_shards`` blocks). With
    ``n_slots``, an encoder-decoder's cross K/V of that many slots is
    counted too (``cross_state_bytes``, dense ``dtype_bytes`` whatever the
    pools' format; whole on every kv rank, so ``per_device`` counts all of
    it); without it the count is the reference's."""
    cache_spec = KVCacheSpec.parse(cache_spec)
    if cache_spec.quantized:
        pos_bytes = cache_spec.mx.wire_bytes(cfg.kv_dim)
    else:
        pos_bytes = cfg.kv_dim * dtype_bytes
    total = 2 * attn_layer_count(cfg) * n_blocks * block_size * pos_bytes
    return ((total // kv_shards if per_device else total)
            + cross_state_bytes(cfg, n_slots, dtype_bytes))
