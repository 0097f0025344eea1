"""The port's ``EngineSupervisor`` against the reference's: engine death,
pool corruption (fp4_e2m1 and dense fp32 pools; the corruption watch at each
of its call sites: the mixed step, the split scheduler's last chunk and
decode, whole-prompt admission), a stuck step (warm recovery with
``persistent_cache``, hard without) and death during gated compressed
serving (``simulate_tp=2``) give the reference's outputs, outcomes,
recovery events ``(error, mode, n_replayed)`` and merged step and dispatch
counts, and the fault-free run's tokens; ``max_restarts`` and the backoff
sequence with an injected ``sleep``. Reduced internlm2-1.8b in fp32 on the
CPU, all requests at t=0, the reference's host arrays copied.

The stuck cases run both engines on a clock whose ``sleep`` moves
``perf_counter`` on instead of waiting (``sleep_advances_clock`` of
``tests/test_torch_faults.py``), with
``step_timeout_s=30``: the ``stuck`` fault's 60 s sleep trips the watchdog
at once, and no ordinary step, however loaded the CPU, reaches 30 s. Both
engines run once with the plan disarmed first (the reference compiles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tp import TPContext as JTPContext
from repro.serving import Engine as JEngine
from repro.serving import EngineDead as JEngineDead
from repro.serving import EngineSupervisor as JEngineSupervisor
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import Request as JRequest
from repro_torch.core.tp import TPContext
from repro_torch.serving import Engine, EngineDead, EngineSupervisor, FaultPlan, Request
from tests.test_torch_faults import (  # noqa: F401 (fixture)
    BASE, port_outputs, run_both, sleep_advances_clock, traffic,
)
from tests.test_torch_serving import models, reference_copies_host_arrays  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCHEDULERS = {"mixed": {}, "split": dict(token_budget=0), "whole-prompt": dict(prefill_chunk=0)}


def test_die_hard_recovery_like_reference(models, reference_copies_host_arrays):
    tr = traffic(models[0].vocab_size, 3, 16, 8)
    free = port_outputs(models, tr, **BASE)
    reqs_j, reqs_t, _, eng_t, sup_j, sup_t = run_both(models, tr, plan="die@3",
                                                      supervised=True, **BASE)
    assert [(e.error, e.mode) for e in sup_t.events] == [("EngineDead", "hard")]
    assert all(r.outcome == "ok" for r in reqs_t) and [r.output.tolist() for r in reqs_t] == free
    r_j, r_t = sup_j.report(), sup_t.report()
    assert set(r_t) == set(r_j) and r_t["n_recoveries"] == 1 and r_t["errors"] == r_j["errors"]
    assert (r_t["serve"]["n_steps"], r_t["serve"]["n_dispatches"]) == (
        r_j["serve"]["n_steps"], r_j["serve"]["n_dispatches"])


@pytest.mark.parametrize("scheduler,cache,gated", [
    ("mixed", "fp4_e2m1", False), ("mixed", "fp32", False), ("split", "fp4_e2m1", False),
    ("whole-prompt", "fp4_e2m1", False), ("mixed", "fp4_e2m1", True)],
    ids=["mixed-fp4", "mixed-fp32", "split-fp4", "whole-prompt-fp4", "mixed-fp4-gated"])
def test_corrupt_detected_and_recovered_like_reference(models, scheduler, cache, gated,
                                                       reference_copies_host_arrays):
    """A poisoned block is caught at the sampling boundary at the reference's
    step and rows (``WireCorruption``); hard recovery rebuilds the pools and
    the replay gives the fault-free tokens. Gated (``simulate_tp=2``, chunk
    8, 24-token prompts): the block is poisoned at step 2, a compressed step,
    and the watch fires at the same later step in both engines."""
    spec = None if cache == "fp32" else cache
    tr = traffic(models[0].vocab_size, 2, 24 if gated else 16, 8)
    kw = dict(cache_spec=spec, **BASE, **SCHEDULERS[scheduler],
              **(dict(prefill_chunk=8) if gated else {}))
    free = port_outputs(models, tr, gated=gated, **kw)
    reqs_j, reqs_t, _, eng_t, sup_j, sup_t = run_both(
        models, tr, plan="corrupt@2" if gated else "corrupt@3", supervised=True, gated=gated,
        **kw)
    assert [(e.error, e.mode) for e in sup_t.events] == [("WireCorruption", "hard")]
    assert sup_t.events[0].detail == sup_j.events[0].detail   # same rows, same step
    assert all(r.outcome == "ok" for r in reqs_t) and [r.output.tolist() for r in reqs_t] == free
    assert eng_t.logits_finite()   # the replay ran on rebuilt pools


@pytest.mark.parametrize("persistent", [True, False], ids=["warm", "hard"])
def test_stuck_step_recovers_like_reference(models, persistent, reference_copies_host_arrays,
                                            sleep_advances_clock):
    """A stuck step trips the watchdog; with a persistent prefix index the
    pools stay warm, without one recovery is hard."""
    tr = traffic(models[0].vocab_size, 2, 16, 8)
    free = port_outputs(models, tr, **BASE)
    reqs_j, reqs_t, _, eng_t, sup_j, sup_t = run_both(
        models, tr, plan="stuck@4", supervised=True, warm_up=True, prefix_cache=True,
        persistent_cache=persistent, step_timeout_s=30.0, **BASE)
    mode = "warm" if persistent else "hard"
    assert [(e.error, e.mode) for e in sup_t.events] == [("StepStuck", mode)]
    assert sup_t.report()["n_warm"] == int(persistent)
    assert all(r.outcome == "ok" for r in reqs_t) and [r.output.tolist() for r in reqs_t] == free


def test_die_during_gated_compressed_serving_like_reference(models,
                                                            reference_copies_host_arrays):
    """Death at step 2, a compressed step of the per-step gate under
    ``simulate_tp=2``: the replay takes the compressed variant again and
    gives the ungated-by-faults run's tokens."""
    tr = traffic(models[0].vocab_size, 2, 24, 8)
    kw = dict(prefill_chunk=8, **BASE)
    free = port_outputs(models, tr, gated=True, **kw)
    reqs_j, reqs_t, _, eng_t, sup_j, sup_t = run_both(models, tr, plan="die@2", supervised=True,
                                                      gated=True, **kw)
    assert [(e.error, e.mode) for e in sup_t.events] == [("EngineDead", "hard")]
    assert [r.output.tolist() for r in reqs_t] == free
    assert eng_t.gate_variants() == ["dense", "compressed"]
    assert eng_t.gate_counts["compressed"] > 0
    assert sup_t.stats.summary()["n_compressed_steps"] == sup_j.stats.summary()[
        "n_compressed_steps"] > 0


def test_max_restarts_and_backoff_like_reference(models):
    """Three deaths, two restarts allowed: two recoveries with backoff 0.01
    then 0.02 s (slept through the injected ``sleep``), then the third death
    propagates, in both supervisors."""
    cfg, model_j, params_j, model_t, params_t = models
    plan, got = "die@1;die@2;die@3", {}
    for name, eng, sup_cls, req_cls, err in (
            ("j", JEngine(model_j, params_j, JTPContext(mesh=None), cache_dtype=jnp.float32,
                          fault_plan=JFaultPlan.parse(plan), **BASE),
             JEngineSupervisor, JRequest, JEngineDead),
            ("t", Engine(model_t, params_t, TPContext(), cache_dtype=torch.float32,
                         device="cpu", fault_plan=FaultPlan.parse(plan), **BASE),
             EngineSupervisor, Request, EngineDead)):
        sleeps = []
        sup = sup_cls(eng, max_restarts=2, backoff_s=0.01, backoff_mult=2.0, sleep=sleeps.append)
        with pytest.raises(err, match="engine died at step 3"):
            sup.run([req_cls(prompt=p.copy(), max_new_tokens=n)
                     for p, n in traffic(cfg.vocab_size, 2, 16, 8)])
        got[name] = (sleeps, [(e.error, e.mode, e.n_replayed) for e in sup.events],
                     sup.stats.n_steps, sup.stats.n_dispatches)
    assert got["t"] == got["j"]
    np.testing.assert_allclose(got["t"][0], [0.01, 0.02])
    assert got["t"][1] == [("EngineDead", "hard", 2)] * 2
    assert eng.allocator.n_held == 0   # the run's finally returned the holds
    eng.recover()                      # a dead engine keeps its blocks until recovered
    assert eng.allocator.n_allocated == 0 and eng.allocator.n_free == eng.n_blocks - 1
