"""The port's mixed-step serving engine against the reference's Engine.

Greedy outputs must be token-identical to a single-device reference Engine
on the traffic of ``tests/test_serving_parity.py::parity_traffic`` (cold
prompts: lengths 5..32 straddling chunk and block boundaries, 4..7 new
tokens) with ``max_slots=2, max_len=64, block_size=16, prefill_chunk=16,
token_budget=18``, over {bf16, fp4_e2m1} pools (dense pools at fp32, as in
the parity matrix) and {dense context, gated ``simulate_tp=2``
PAPER_DEFAULT context}. Every request arrives at t=0 (the parity traffic
staggers arrivals by 2 ms): admission, and with it each step's composition
and compression gate, then depend on no clock, so both engines pack the
same steps. The reference engine runs with its host arrays copied at each
step (see ``reference_copies_host_arrays``): without that its own tokens
vary from run to run. Gate counts equal the reference's and the free list
is conserved after ``run()``; ``serve_both`` holds one traffic to all of
that, and the split-scheduler, prefix-cache and eviction test files use it.
Also: the block allocator's invariants, the batch geometry, PoolExhausted
for a request the whole pool cannot hold (on every scheduler, as the
reference), entry points that default to the card, ``launch/serve.py`` in
each mode, with its robustness flags and on the new families under the
two_phase variant, and each robustness option of the engine against the
reference's.
TF32 is off for torch matmuls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.tp import TPContext as JTPContext
from repro.models.model import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import PoolExhausted as JPoolExhausted
from repro.serving import Request as JRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.core.tp import TPContext
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serving import (
    BlockAllocator, Engine, FaultPlan, InvalidRequest, PoolExhausted, Request,
    build_mixed_batch,
)
from tests.conftest import fp32_reduced

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ENGINE_KW = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=16, token_budget=18)


class _CopyingJnp:
    """``jnp`` with an ``asarray`` that hands JAX a fresh host copy of a
    numpy array, which nothing mutates afterwards. (``jnp.array`` alone is
    not enough: on the CPU it may read its numpy input only when the
    asynchronously dispatched copy runs.)"""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kw)


@pytest.fixture
def reference_copies_host_arrays(monkeypatch):
    """The reference engine hands its block tables, lengths and current
    tokens to each step with ``jnp.asarray``, which on the CPU may alias the
    numpy buffers, and updates them in place while the asynchronously
    dispatched step may still read them: its greedy tokens then vary from
    run to run in one process. Copying them makes it deterministic (ROADMAP
    Queue 3); the port copies them itself."""
    import repro.serving.engine as reference_engine

    monkeypatch.setattr(reference_engine, "jnp", _CopyingJnp())


@pytest.fixture(scope="module")
def models():
    cfg_j = fp32_reduced("internlm2-1.8b")
    cfg_t = dataclasses.replace(reduced_config(get_config("internlm2-1.8b")), dtype="float32")
    model_j = JModel(cfg_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t, "cpu")
    return cfg_t, model_j, params_j, Model(cfg_t), params_t


def _prompts(vocab):
    """parity_traffic(cfg, shared_prefix=False): prompt i is 5 + 9 i tokens."""
    return [((np.arange(5 + 9 * i, dtype=np.int32) * 11) % vocab).astype(np.int32)
            for i in range(4)]


def parity_traffic(vocab):
    """(prompt, max_new_tokens) of the parity traffic: 4..7 new tokens."""
    return [(p, 4 + i) for i, p in enumerate(_prompts(vocab))]


def contexts(gated: bool):
    """(reference, port) contexts: dense, or PAPER_DEFAULT over simulate_tp=2."""
    if gated:
        return (JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2),
                TPContext(policy=PAPER_DEFAULT, simulate_tp=2))
    return JTPContext(mesh=None), TPContext()


SUMMARY_KEYS = ("n_steps", "n_dispatches", "prefill_tokens", "decode_tokens", "n_generated",
                "n_compressed_steps", "n_preemptions", "prefill_tokens_skipped")


def serve_both(models, traffic, *, gated=False, runs=1, cache_dtype="float32",
               extra_inputs=None, ref_kw=None, **kw):
    """Serve ``traffic`` (``(prompt, max_new_tokens)`` pairs, all arriving
    at t=0; with the model's ``extra_inputs``, one numpy row per request,
    when given) on the reference Engine and on the port's with the same
    options (``ref_kw``: options of the reference Engine alone), ``runs``
    times each on one engine. Asserts, run by run: greedy tokens
    identical, every request ``ok``, gate counts and the summary's
    ``SUMMARY_KEYS`` equal, finite logits, and the free list conserved (every
    block free or parked in the prefix index, none referenced). Returns the
    two engines and the port's outputs by run."""
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j, ctx_t = contexts(gated)
    eng_j = JEngine(model_j, params_j, ctx_j, cache_dtype=getattr(jnp, cache_dtype), **kw,
                    **(ref_kw or {}))
    eng_t = Engine(model_t, params_t, ctx_t, cache_dtype=getattr(torch, cache_dtype),
                   device="cpu", **kw)
    outs = []
    for _ in range(runs):
        extra = {"extra_inputs": extra_inputs} if extra_inputs is not None else {}
        reqs_j = eng_j.run([JRequest(prompt=p.copy(), max_new_tokens=n, arrival_s=0.0)
                            for p, n in traffic], **extra)
        reqs_t = eng_t.run([Request(prompt=p.copy(), max_new_tokens=n, arrival_s=0.0)
                            for p, n in traffic], **extra)
        out = [r.output.tolist() for r in reqs_t]
        assert out == [r.output.tolist() for r in reqs_j]
        assert all(r.outcome == "ok" and len(r.output) == n for r, (_, n) in zip(reqs_t, traffic))
        assert eng_t.gate_counts == eng_j.gate_counts
        assert eng_t.gate_variants() == eng_j.gate_variants()
        s_t, s_j = eng_t.stats.summary(), eng_j.stats.summary()
        for key in SUMMARY_KEYS:
            assert s_t[key] == s_j[key], key
        a = eng_t.allocator
        assert a.n_free + a.n_cached == eng_t.n_blocks - 1 and a.n_allocated == 0
        assert a.n_cached == eng_j.allocator.n_cached
        assert eng_t.logits_finite()
        outs.append(out)
    return eng_j, eng_t, outs


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "gated-simulate_tp2"])
@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_greedy_tokens_identical_to_reference_engine(models, cache, gated,
                                                    reference_copies_host_arrays):
    eng_j, eng_t, _ = serve_both(models, parity_traffic(models[0].vocab_size), gated=gated,
                                 cache_spec=cache, **ENGINE_KW)
    if gated:
        assert eng_t.gate_counts["compressed"] > 0 and eng_t.gate_counts["dense"] > 0
    assert eng_t.allocator.n_free == eng_t.n_blocks - 1


def test_block_allocator_invariants():
    a = BlockAllocator(6)
    ids = a.alloc(3)
    assert ids == [1, 2, 3] and a.n_free == 2 and a.alloc(3) is None and a.n_free == 2
    blocks = [ids[0]]
    assert a.alloc_to(blocks, 1) == [] and a.alloc_to(blocks, 3) == [4, 5]
    a.share([1])
    a.release([1])
    assert a.refcount(1) == 1
    with pytest.raises(ValueError, match="NULL_BLOCK"):
        a.release([0])
    with pytest.raises(ValueError, match="exceeds its refcount"):
        a.release([2, 2])
    with pytest.raises(ValueError, match="out-of-range"):
        a.release([9])
    a.release([1, 2, 3, 4, 5])
    assert a.n_free == 5 and a.n_allocated == 0 and a.high_water == 5


def test_mixed_batch_geometry():
    b = build_mixed_batch([(1, np.array([7, 8, 9], np.int32), 4)], [(0, 3, 10)], 6, 2)
    assert b.tokens.tolist() == [[7, 8, 9, 3, 0, 0]]
    assert b.slot_ids.tolist() == [1, 1, 1, 0, 0, 0]
    assert b.positions.tolist() == [4, 5, 6, 10, 0, 0]
    assert b.valid.tolist() == [True] * 4 + [False] * 2
    assert b.is_decode.tolist() == [False] * 3 + [True] + [False] * 2
    assert b.sample_idx.tolist() == [3, 2] and (b.n_prefill, b.n_decode) == (3, 1)
    with pytest.raises(ValueError, match="exceeds token_budget"):
        build_mixed_batch([(0, np.arange(6, dtype=np.int32), 0)], [(1, 0, 0)], 6, 2)
    with pytest.raises(ValueError, match="twice"):
        build_mixed_batch([(0, np.arange(2, dtype=np.int32), 0)], [(0, 0, 0)], 6, 2)


def _exhaust(models, **kw):
    cfg, model_j, params_j, model_t, params_t = models
    base = dict(max_slots=2, max_len=64, block_size=8, n_blocks=4, **kw)
    prompt = (np.arange(30, dtype=np.int32) * 7) % cfg.vocab_size
    with pytest.raises(JPoolExhausted, match="pool"):
        JEngine(model_j, params_j, JTPContext(mesh=None), **base).run(
            [JRequest(prompt=prompt, max_new_tokens=8)])
    eng = Engine(model_t, params_t, TPContext(), device="cpu", **base)
    with pytest.raises(PoolExhausted, match="pool"):
        eng.run([Request(prompt=prompt, max_new_tokens=8)])


def test_pool_exhaustion_raises_without_preemption(models):
    """A single request that the whole pool cannot hold: with nothing to
    preempt the engine raises PoolExhausted, as the reference does (its
    ``test_pool_exhausted_and_slot_exhausted_typed``: a 30-token prompt and
    8 new tokens need 5 blocks of 8, the pool has 3)."""
    _exhaust(models)


@pytest.mark.parametrize("kw", [dict(token_budget=0), dict(prefill_chunk=0)],
                         ids=["split", "whole-prompt"])
def test_pool_exhaustion_raises_on_the_other_schedulers(models, kw):
    _exhaust(models, **kw)


def test_request_validation(models):
    cfg, _, _, model_t, params_t = models
    with pytest.raises(InvalidRequest):
        Request(prompt=np.zeros((0,), np.int32))
    with pytest.raises(InvalidRequest):
        Request(prompt=np.ones(3, np.int32), max_new_tokens=0)
    eng = Engine(model_t, params_t, TPContext(), device="cpu", **ENGINE_KW)
    with pytest.raises(InvalidRequest, match="max_len"):
        eng.run([Request(prompt=np.ones(60, np.int32), max_new_tokens=10)])


ROBUSTNESS_OPTIONS = {  # option -> (reference value, port value)
    "fault_plan": (lambda: JFaultPlan.parse("exhaust@2x3"), lambda: FaultPlan.parse("exhaust@2x3")),
    "deadline_s": (lambda: 60.0,) * 2, "deadline_ttft_s": (lambda: 60.0,) * 2,
    "max_queue": (lambda: 1,) * 2, "step_timeout_s": (lambda: 60.0,) * 2,
    "stall_limit": (lambda: 3,) * 2,
}


@pytest.mark.parametrize("option", list(ROBUSTNESS_OPTIONS))
def test_engine_takes_robustness_options_like_reference(models, option,
                                                       reference_copies_host_arrays):
    """Each robustness option, built and run on the parity traffic: the
    port's outcomes, tokens and step counts equal the reference's (a hold of
    every free block from step 2 for 3 steps; deadlines and a watchdog no
    step reaches; one of four requests rejected past ``max_queue=1``; a
    stall guard of 3 steps that never trips)."""
    cfg, model_j, params_j, model_t, params_t = models
    make_j, make_t = ROBUSTNESS_OPTIONS[option]
    eng_j = JEngine(model_j, params_j, JTPContext(mesh=None), cache_dtype=jnp.float32,
                    **ENGINE_KW, **{option: make_j()})
    eng_t = Engine(model_t, params_t, TPContext(), cache_dtype=torch.float32, device="cpu",
                   **ENGINE_KW, **{option: make_t()})
    traffic = parity_traffic(cfg.vocab_size)
    reqs_j = eng_j.run([JRequest(prompt=p.copy(), max_new_tokens=n) for p, n in traffic])
    reqs_t = eng_t.run([Request(prompt=p.copy(), max_new_tokens=n) for p, n in traffic])
    assert [r.output.tolist() for r in reqs_t] == [r.output.tolist() for r in reqs_j]
    assert [r.outcome for r in reqs_t] == [r.outcome for r in reqs_j]
    expect = ["ok"] * 4 if option != "max_queue" else ["ok"] * 3 + ["rejected"]
    assert sorted(r.outcome for r in reqs_t) == expect
    s_t, s_j = eng_t.stats.summary(), eng_j.stats.summary()
    for key in SUMMARY_KEYS + ("n_rejected",):
        assert s_t[key] == s_j[key], key
    assert eng_t.allocator.n_allocated == 0 and eng_t.allocator.n_held == 0


def test_entry_points_default_to_the_card(models, monkeypatch):
    """Without device="cpu" the entry points ask for CUDA and raise when
    there is none (this test forces the no-GPU answer)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, model_t, params_t = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_t.init_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model_t, params_t, TPContext(), **ENGINE_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--requests", "1"])


@pytest.mark.parametrize("flags,expect", [
    (["--fault-plan", "die@3"], ["fault plan: die@3 (seed 0)", "4 ok, 0 rejected",
                                 "recoveries: 1 (1 hard, 0 warm)", "errors=['EngineDead']"]),
    (["--fault-plan", "exhaust@2x2;corrupt@3", "--cache-spec", "fp4_e2m1"],
     ["4 ok, 0 rejected", "recoveries: 1 (1 hard, 0 warm)", "errors=['WireCorruption']"]),
    (["--max-queue", "1"], ["3 ok, 1 rejected, 0 timed out, 0 cancelled"]),
    (["--deadline-ms", "60000", "--ttft-deadline-ms", "60000"], ["4 ok, 0 rejected"])],
    ids=["die", "exhaust-corrupt", "max-queue", "deadlines"])
def test_serve_cli_robustness_flags_on_cpu(capsys, flags, expect):
    """The serving CLI's robustness flags on the CPU: a fault plan wraps the run in
    a supervisor and reports its recoveries; the outcome line counts every
    terminal outcome."""
    engine, out = serve.main(["--reduced", "--device", "cpu", "--slots", "2", "--requests", "4",
                              "--prompt-len", "20", "--new-tokens", "3", "--policy", "none",
                              *flags])
    text = capsys.readouterr().out
    for line in expect:
        assert line in text, line
    assert all(r.outcome is not None for r in out)
    assert engine.allocator.n_allocated == 0 and engine.allocator.n_held == 0


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-4b"])
def test_serve_cli_families_two_phase_on_cpu(capsys, arch):
    """The serving CLI on a new family's reduced config under the two_phase
    variant (and the reference launcher's ``--overlap-chunks``): the banner
    names the arch and the variant and says the overlap chunks are ignored,
    the compressed steps run, and every request finishes."""
    engine, out = serve.main(["--reduced", "--device", "cpu", "--arch", arch, "--slots", "2",
                              "--requests", "3", "--prompt-len", "40", "--new-tokens", "3",
                              "--cache-spec", "fp4_e2m1", "--variant", "two_phase",
                              "--overlap-chunks", "2"])
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "variant=two_phase" in text
    assert "overlap_chunks=2 (ignored: no effect under simulate_tp)" in text
    assert "3 requests, 9 tokens" in text and "compression gate:" in text
    assert engine.ctx.policy.variant == "two_phase" and engine.ctx.policy.overlap_chunks == 2
    assert engine.gate_counts["compressed"] > 0
    assert all(r.outcome == "ok" and len(r.output) == 3 for r in out)


@pytest.mark.parametrize("flags,banner", [
    (["--token-budget", "0"], "step: split, chunked 32 tokens/step"),
    (["--prefill-chunk", "0"], "step: split, whole-prompt"),
    (["--prefix-cache", "1", "--slots", "1"], "prefix cache: on")],
    ids=["split", "whole-prompt", "prefix-cache"])
def test_serve_cli_runs_new_modes_on_cpu(capsys, flags, banner):
    engine, out = serve.main(["--reduced", "--device", "cpu", "--slots", "2", "--requests", "3",
                              "--prompt-len", "64", "--new-tokens", "3",
                              "--cache-spec", "fp4_e2m1", *flags])
    text = capsys.readouterr().out
    assert banner in text and "3 requests, 9 tokens" in text and "preemptions: 0" in text
    assert all(r.outcome == "ok" and len(r.output) == 3 for r in out)
    if engine.prefix_cache:
        assert engine.stats.summary()["prefill_tokens_skipped"] > 0
        assert "prompt tokens skipped" in text


def test_serve_driver_runs_on_cpu(capsys):
    engine, out = serve.main(["--reduced", "--device", "cpu", "--slots", "2", "--requests", "3",
                              "--prompt-len", "20", "--new-tokens", "3",
                              "--cache-spec", "fp4_e2m1", "--simulate-tp", "2"])
    text = capsys.readouterr().out
    assert "3 requests, 9 tokens" in text and "compression gate:" in text
    assert "TTFT p50" in text and "first request tokens:" in text
    assert all(r.outcome == "ok" and len(r.output) == 3 for r in out)
    assert engine.gate_counts["compressed"] > 0
