"""LIFO preemption (evict-and-recompute) in the port against the reference
Engine: the traffic of ``tests/test_chunked_prefill.py``'s eviction test
(two 20-token prompts, 30 new tokens each, 2 slots, blocks of 16, a pool of
7 blocks, chunk 8), on the mixed scheduler, the split scheduler and
whole-prompt prefill, over dense fp32 and fp4_e2m1 pools; the same traffic
with the eviction-storm guard tightened; and a preemption that must release
shared prefix blocks rather than free them. Greedy tokens identical, and
steps, dispatches, preemptions and skipped prefill tokens equal; the free
list is conserved. All arrivals at t=0, the reference's host arrays copied.
TF32 is off for torch matmuls.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_prefix_cache import shared_prefix_traffic
from tests.test_torch_serving import (  # noqa: F401 (fixtures)
    models, reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCHEDULERS = {"mixed": dict(prefill_chunk=8), "split": dict(prefill_chunk=8, token_budget=0),
              "whole-prompt": dict(prefill_chunk=0)}
TINY = dict(max_slots=2, max_len=64, block_size=16, n_blocks=7)


def eviction_traffic(vocab):
    return [(np.arange(20, dtype=np.int32) % vocab, 30) for _ in range(2)]


@pytest.mark.parametrize("cache", ["fp32", "fp4_e2m1"])
@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_eviction_identical_to_reference(models, scheduler, cache,
                                         reference_copies_host_arrays):
    _, eng_t, _ = serve_both(models, eviction_traffic(models[0].vocab_size),
                             cache_spec=None if cache == "fp32" else cache,
                             **TINY, **SCHEDULERS[scheduler])
    assert eng_t.stats.summary()["n_preemptions"] >= 1
    assert eng_t.allocator.n_free == eng_t.n_blocks - 1
    assert eng_t.allocator.high_water <= eng_t.n_blocks - 1


@pytest.mark.parametrize("scheduler", ["mixed", "split"])
def test_storm_guard_identical_to_reference(models, scheduler,
                                            reference_copies_host_arrays):
    """Chunk allocation may choose no victim (``max_preempts_per_step=0``:
    chunks defer, only decode growth preempts) and one preemption in the
    window degrades the engine (``thrash_limit=1``) until a retire."""
    _, eng_t, _ = serve_both(models, eviction_traffic(models[0].vocab_size), cache_spec=None,
                             max_preempts_per_step=0, thrash_limit=1, **TINY,
                             **SCHEDULERS[scheduler])
    assert eng_t.stats.summary()["n_preemptions"] >= 1


@pytest.mark.parametrize("scheduler", ["mixed", "split"])
def test_eviction_releases_shared_blocks_identical_to_reference(
        models, scheduler, reference_copies_host_arrays):
    """Three 48-token prompts sharing their first 32 tokens, 24 new tokens
    each, on a pool of 7 blocks of 16 (``tests/test_prefix_cache.py``'s case
    with longer decodes, so that it preempts with every arrival at t=0): a
    victim's shared blocks are released (one reference dropped), not freed,
    and every block ends free or parked in the index."""
    _, eng_t, _ = serve_both(models, shared_prefix_traffic(models[0].vocab_size, n=3, new=24),
                             cache_spec=None, max_slots=2, max_len=80, block_size=16,
                             n_blocks=7, prefill_chunk=32, prefix_cache=True,
                             **({"token_budget": 0} if scheduler == "split" else {}))
    s = eng_t.stats.summary()
    assert s["n_preemptions"] >= 1 and s["prefill_tokens_skipped"] > 0
