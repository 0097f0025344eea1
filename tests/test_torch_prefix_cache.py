"""The port's prefix cache: ``PrefixIndex`` and the refcounted allocator
(mirroring ``tests/test_prefix_cache.py``'s unit tests, plus the chain
hashes against the reference's), the copy-on-write block fork, and the
engine against the reference Engine — greedy tokens identical, and steps,
dispatches (COW forks included), preemptions and skipped prefill tokens
equal — on shared-prefix traffic over both schedulers and both pool
formats, full-duplicate prompts on exact pools (fp32 cache at fp32 model
dtype: the COW fork of the tail block, L-1 tokens skipped) and on fp4 pools
(the aligned resume), and ``persistent_cache`` across two runs. All
arrivals at t=0, the reference's host arrays copied. TF32 is off.
"""
import numpy as np
import pytest
import torch

from repro.serving import PrefixIndex as JPrefixIndex
from repro_torch.core.tp import TPContext
from repro_torch.serving import BlockAllocator, Engine, PrefixIndex, Request
from tests.test_torch_serving import (  # noqa: F401 (fixtures)
    models, reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BS = 16
SCHEDULERS = {"mixed": dict(token_budget=18), "split": dict(token_budget=0)}


# ------------------------------------------------------ allocator refcounts


def test_share_release_conservation():
    a = BlockAllocator(10)
    ids = a.alloc(3)
    assert all(a.refcount(b) == 1 for b in ids)
    a.share(ids)
    a.share(ids[:1])
    assert a.refcount(ids[0]) == 3 and a.refcount(ids[1]) == 2
    a.release(ids)
    assert a.n_free == 6 and a.n_allocated == 3
    a.release(ids)
    assert a.n_free == 8 and a.refcount(ids[0]) == 1
    a.release(ids[:1])
    assert a.n_free == 9 and a.n_allocated == 0
    assert sorted(b for shard in a._free for b in shard) == list(range(1, 10))


def test_release_beyond_refcount_rejected():
    a = BlockAllocator(8)
    ids = a.alloc(2)
    a.share(ids)
    a.release(ids)
    a.release(ids[:1])
    with pytest.raises(ValueError, match="double release"):
        a.release(ids[:1])
    with pytest.raises(ValueError, match="double release"):
        a.release([ids[1], ids[1]])
    a.release(ids[1:])
    assert a.n_free == 7


def test_share_of_free_block_rejected():
    a = BlockAllocator(8)
    ids = a.alloc(1)
    with pytest.raises(ValueError, match="share of unallocated"):
        a.share([ids[0] + 1])
    a.release(ids)
    with pytest.raises(ValueError, match="share of unallocated"):
        a.share(ids)
    with pytest.raises(ValueError, match="NULL_BLOCK"):
        a.share([0])


def test_cached_blocks_park_in_lru_and_revive():
    """A registered block at refcount 0 parks in the index LRU; a hit
    revives it; only a free-list shortfall reclaims, coldest first."""
    idx = PrefixIndex(BS)
    a = BlockAllocator(6, prefix_index=idx)
    ids = a.alloc(3)
    for j, b in enumerate(ids):
        idx.register(100 + j, b)
    a.release(ids)
    assert a.n_free == 2 and a.n_cached == 3 and a.n_allocated == 0
    assert a.n_available == 5 and a.n_held == 0
    assert idx.match([100, 101]) == ids[:2]
    a.share(ids[:2])
    assert a.n_cached == 1 and a.refcount(ids[0]) == 1
    a.release(ids[:2])
    got = a.alloc(2)
    assert set(got).isdisjoint(ids)
    assert a.alloc(1) == [ids[2]]
    assert not idx.contains_block(ids[2]) and idx.match([102]) == []
    assert idx.evicted_blocks == 1
    assert not idx.register(100, 5) and not idx.register(999, ids[0])  # taken


def test_chain_is_prefix_consistent():
    toks = np.arange(40, dtype=np.int32)
    h = PrefixIndex.chain(toks, BS)
    assert len(h) == 2
    assert h == PrefixIndex.chain(toks[:32], BS)
    other = toks.copy()
    other[20] += 1
    h2 = PrefixIndex.chain(other, BS)
    assert h2[0] == h[0] and h2[1] != h[1]


def test_chain_hashes_equal_the_reference():
    toks = (np.arange(100, dtype=np.int32) * 7) % 512
    for bs in (8, 16):
        assert PrefixIndex.chain(toks, bs) == JPrefixIndex.chain(toks, bs)


# ------------------------------------------------------------ COW mechanics


@pytest.mark.parametrize("cache", ["fp32", "fp4_e2m1"])
def test_cow_fork_leaves_source_block_untouched(models, cache):
    cfg, _, _, model_t, params_t = models
    eng = Engine(model_t, params_t, TPContext(), max_slots=1, max_len=64,
                 cache_dtype=torch.float32, prefill_chunk=32, prefix_cache=True,
                 cache_spec=None if cache == "fp32" else cache, device="cpu")
    eng.run([Request(prompt=np.arange(32, dtype=np.int32), max_new_tokens=2)])

    def leaves():
        out = []
        for p in eng._state["pools_k"] + eng._state["pools_v"]:
            out += [p.payload, p.scales] if hasattr(p, "payload") else [p]
        return [t.clone() for t in out]

    before = leaves()
    eng._cow(1, 3)
    for b, a in zip(before, leaves()):
        assert torch.equal(a[1], b[1])        # source untouched
        assert torch.equal(a[3], b[1])        # the destination is the copy
        assert torch.equal(a[2], b[2])        # a bystander untouched
        assert b[1].abs().sum() > 0           # the block held real content


# ------------------------------------------------------------- engine level


def shared_prefix_traffic(vocab, n=5, shared=32, suffix=16, new=4):
    """Every prompt opens with the same two full blocks, then its own
    tokens (``tests/test_prefix_cache.py``'s shape at the parity sizes)."""
    rng = np.random.default_rng(3)
    pre = rng.integers(0, vocab, shared).astype(np.int32)
    return [(np.concatenate([pre, rng.integers(0, vocab, suffix).astype(np.int32)]), new)
            for _ in range(n)]


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_prefix_cache_identical_to_reference(models, cache, scheduler,
                                            reference_copies_host_arrays):
    _, eng_t, _ = serve_both(models, shared_prefix_traffic(models[0].vocab_size),
                             cache_spec=cache, max_slots=2, max_len=64, block_size=16,
                             prefill_chunk=16, prefix_cache=True, **SCHEDULERS[scheduler])
    s = eng_t.stats.summary()
    assert s["prefill_tokens_skipped"] > 0 and 0 < s["prefix_hit_rate"] <= 1
    assert eng_t.prefix_index.hit_blocks > 0


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_full_duplicate_prompt_cow_identical_to_reference(models, scheduler,
                                                         reference_copies_host_arrays):
    """Exact pools (fp32 cache at the fp32 model dtype): the second and third
    copies of a 32-token prompt share both blocks, fork the tail block and
    recompute only the last token (31 tokens skipped, one COW dispatch
    each)."""
    cfg = models[0]
    prompt = (np.arange(32, dtype=np.int32) * 7) % cfg.vocab_size
    eng_j, eng_t, _ = serve_both(models, [(prompt, 5)] * 3, cache_spec=None, max_slots=1,
                                 max_len=64, prefill_chunk=32, prefix_cache=True,
                                 **({"token_budget": 0} if scheduler == "split" else {}))
    assert eng_t._exact_pools
    skipped = [t.n_cached_prompt for t in sorted(eng_t.stats.timings,
                                                 key=lambda t: t.admitted_s)]
    assert skipped == [0, 31, 31]


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_full_duplicate_prompt_fp4_resumes_aligned(models, scheduler,
                                                  reference_copies_host_arrays):
    """Lossy fp4 pools: a full-prompt match resumes at the last chunk-aligned
    boundary and recomputes the tail chunk (32 of 64 tokens skipped, no COW
    fork)."""
    cfg = models[0]
    prompt = (np.arange(64, dtype=np.int32) * 13) % cfg.vocab_size
    _, eng_t, _ = serve_both(models, [(prompt, 5)] * 2, cache_spec="fp4_e2m1", max_slots=1,
                             max_len=96, prefill_chunk=32, prefix_cache=True,
                             **({"token_budget": 0} if scheduler == "split" else {}))
    assert not eng_t._exact_pools
    skipped = [t.n_cached_prompt for t in sorted(eng_t.stats.timings,
                                                 key=lambda t: t.admitted_s)]
    assert skipped == [0, 32]


@pytest.mark.parametrize("cache", ["fp32", "fp4_e2m1"])
def test_persistent_cache_across_runs_identical_to_reference(models, cache,
                                                             reference_copies_host_arrays):
    """The second run of the same prompts finds them in the index kept from
    the first: it skips their prefill and decodes the same tokens."""
    traffic = shared_prefix_traffic(models[0].vocab_size, n=3)
    _, eng_t, outs = serve_both(models, traffic, runs=2,
                                cache_spec=None if cache == "fp32" else cache, max_slots=2,
                                max_len=64, block_size=16, prefill_chunk=16,
                                prefix_cache=True, persistent_cache=True)
    assert outs[0] == outs[1]
    assert eng_t.stats.summary()["prefill_tokens_skipped"] >= 3 * 32
