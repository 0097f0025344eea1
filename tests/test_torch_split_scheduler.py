"""The port's split chunk-then-decode scheduler (``token_budget=0``) and
whole-prompt prefill (``prefill_chunk=0``) against the reference Engine.

Greedy tokens identical, and gate counts, steps, dispatches, prefill and
decode tokens, preemptions and skipped prefill tokens equal, on the parity
traffic of ``tests/test_torch_serving.py`` (all arrivals at t=0, the
reference's host arrays copied; ``max_slots=2, max_len=64, block_size=16``,
chunk 16, dense pools at fp32): the split scheduler over {bf16, fp4_e2m1}
pools x {dense context, gated ``simulate_tp=2``} and with
``compress_decode=True``; whole-prompt prefill over both pools and both
contexts. Also ``measure_ttft``'s keys and the constructor's validation,
error for error against the reference's. TF32 is off for torch matmuls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tp import TPContext as JTPContext
from repro.serving import Engine as JEngine
from repro_torch.core.tp import TPContext
from repro_torch.serving import Engine
from tests.test_torch_serving import (  # noqa: F401 (fixtures)
    models, parity_traffic, reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPLIT_KW = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=16, token_budget=0)


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "gated-simulate_tp2"])
@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_split_scheduler_tokens_identical_to_reference(models, cache, gated,
                                                      reference_copies_host_arrays):
    eng_j, eng_t, _ = serve_both(models, parity_traffic(models[0].vocab_size), gated=gated,
                                 cache_spec=cache, **SPLIT_KW)
    s = eng_t.stats.summary()
    assert eng_t.gate_variants() == [] and s["n_dispatches"] > s["n_steps"]


@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_split_scheduler_compress_decode_identical_to_reference(models, cache,
                                                               reference_copies_host_arrays):
    """``compress_decode=True``: the batched decode reduces through the
    codec too (ctx_decode is the compressed context)."""
    _, eng_t, _ = serve_both(models, parity_traffic(models[0].vocab_size), gated=True,
                             cache_spec=cache, compress_decode=True, **SPLIT_KW)
    assert eng_t.ctx_decode.policy.enabled


def test_mixed_compress_decode_gate_identical_to_reference(models,
                                                           reference_copies_host_arrays):
    """On the mixed engine ``compress_decode`` drops the gate's prefill-
    fraction floor: every step of at least ``min_tokens`` real tokens runs
    compressed."""
    _, eng_t, _ = serve_both(models, parity_traffic(models[0].vocab_size), gated=True,
                             cache_spec="fp4_e2m1", compress_decode=True, max_slots=2,
                             max_len=64, block_size=16, prefill_chunk=16, token_budget=18)
    assert eng_t.gate_counts["compressed"] > 0


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "gated-simulate_tp2"])
@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_whole_prompt_prefill_tokens_identical_to_reference(models, cache, gated,
                                                           reference_copies_host_arrays):
    """Prompts of 5..32 tokens prefilled whole in buckets of 16 and 32, each
    admission counted as two dispatches (prefill + insert) and its prompt as
    off-step prefill tokens."""
    _, eng_t, _ = serve_both(models, parity_traffic(models[0].vocab_size), gated=gated,
                             cache_spec=cache, max_slots=2, max_len=64, block_size=16,
                             prefill_chunk=0)
    s = eng_t.stats.summary()
    assert eng_t.token_budget == 0 and s["prefill_tokens"] == sum(5 + 9 * i for i in range(4))


@pytest.mark.parametrize("iters", [1, 3])
def test_measure_ttft_returns_its_keys(models, iters):
    cfg, _, _, model_t, params_t = models
    eng = Engine(model_t, params_t, TPContext(), max_slots=2, max_len=40, device="cpu")
    stats = eng.measure_ttft(16, iters=iters)
    assert set(stats) == {"median_s", "std_s", "iters"}
    assert stats["iters"] == max(1, iters - 1)   # the warm-up iteration dropped
    assert np.isfinite(stats["median_s"]) and stats["median_s"] > 0
    assert np.isfinite(stats["std_s"])


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=-1), "prefill_chunk must be >= 0"),
    (dict(token_budget=-1), "token_budget must be >= 0"),
    (dict(prefill_chunk=0, token_budget=8), "rides on chunked prefill"),
    (dict(prefill_chunk=16, token_budget=17), "must cover one decode token"),
    (dict(prefill_chunk=0, prefix_cache=True), "rides on chunked prefill"),
    (dict(persistent_cache=True), "requires prefix_cache=True"),
], ids=["chunk<0", "budget<0", "budget-without-chunks", "budget-below-floor",
        "prefix-without-chunks", "persistent-without-prefix"])
def test_engine_validation_matches_reference(models, kw, match):
    cfg, model_j, params_j, model_t, params_t = models
    base = dict(max_slots=2, max_len=64, block_size=16, **kw)
    with pytest.raises(ValueError, match=match):
        JEngine(model_j, params_j, JTPContext(mesh=None), cache_dtype=jnp.float32, **base)
    with pytest.raises(ValueError, match=match):
        Engine(model_t, params_t, TPContext(), device="cpu", **base)
