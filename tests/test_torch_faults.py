"""The port's request lifecycle and fault injection against the reference's:
``FaultPlan`` grammar, one-shot ``take``, ``reset``, ``describe`` and
``garbage_bytes``; the allocator's fault holds; ``Request`` validation;
``RequestTiming`` and ``ServeStats`` (outcome counts, goodput, ``merge``);
and engine runs under bounded admission (``max_queue``), a TTFT deadline, a
cancel before the run, an ``eos_id`` stop and an ``exhaust`` fault, each
giving the reference Engine's outcomes, tokens and stats; the default stall
guard and a forced livelock. The engines run reduced internlm2-1.8b in
fp32 on the CPU, all requests at t=0, the reference's host arrays copied
(``reference_copies_host_arrays``). A cancel mid-decode (from another
thread, after a chosen step) and a total deadline that a ``slow`` fault
overruns (on a clock that the fault's sleep moves on) hold both engines to
the same outcomes at the same step.
"""
import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tp import TPContext as JTPContext
from repro.serving import BlockAllocator as JBlockAllocator
from repro.serving import Engine as JEngine
from repro.serving import EngineSupervisor as JEngineSupervisor
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import InvalidRequest as JInvalidRequest
from repro.serving import Request as JRequest
from repro.serving import RequestTiming as JRequestTiming
from repro.serving import ServeStats as JServeStats
from repro.serving import StepStuck as JStepStuck
from repro_torch.core.tp import TPContext
from repro_torch.serving import (
    OUTCOME_CANCELLED, OUTCOME_OK, OUTCOME_REJECTED, OUTCOME_TIMED_OUT, TERMINAL_OUTCOMES,
    BlockAllocator, Engine, EngineSupervisor, FaultPlan, InvalidRequest, Request,
    RequestTiming, ServeStats, StepStuck,
)
from tests.test_torch_serving import (  # noqa: F401 (fixtures)
    SUMMARY_KEYS, contexts, models, reference_copies_host_arrays,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BASE = dict(max_slots=2, max_len=64)
OUTCOME_KEYS = SUMMARY_KEYS + ("n_requests", "n_ok", "n_rejected", "n_timed_out", "n_cancelled")


def traffic(vocab, n, plen, new):
    """The reference fault tests' ``_reqs``: prompt i is ``(arange(plen) + 3 i)
    % vocab``, every request ``new`` tokens, all at t=0."""
    return [((np.arange(plen, dtype=np.int32) + 3 * i) % vocab, new) for i in range(n)]


def make_requests(cls, traffic, req_kw=None):
    req_kw = req_kw or [{}] * len(traffic)
    return [cls(prompt=p.copy(), max_new_tokens=n, **kw) for (p, n), kw in zip(traffic, req_kw)]


def warm(eng, cls, prompt):
    """One short run with the fault plan and the watchdog disarmed, so that
    the reference's compiles (and the port's first launches) fall outside
    the measured run. Four prompt tokens fill no block, so a prefix index
    stays empty."""
    plan, timeout = eng.fault_plan, eng.step_timeout_s
    eng.fault_plan = eng.step_timeout_s = None
    eng.run([cls(prompt=prompt[:4].copy(), max_new_tokens=2)])
    eng.fault_plan, eng.step_timeout_s = plan, timeout


def run_both(models, traffic, *, plan=None, supervised=False, gated=False, req_kw=None,
             sup_kw=None, warm_up=False, hook=None, extra_inputs=None, **kw):
    """Serve ``traffic`` (with the model's ``extra_inputs``, one numpy row
    per request, when given) on the reference Engine and on the port's with the
    same options and a fault plan parsed from the same string for each,
    under an ``EngineSupervisor`` when ``supervised``, after
    ``hook(engine, requests)`` when given. Asserts outputs,
    outcomes, the summary's counts and (supervised) the recovery events
    ``(error, mode, n_replayed)`` equal, every request terminal, and the
    port's free list conserved with nothing held. Returns
    ``(reqs_j, reqs_t, eng_j, eng_t, sup_j, sup_t)``."""
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j, ctx_t = contexts(gated)
    eng_j = JEngine(model_j, params_j, ctx_j, cache_dtype=jnp.float32,
                    fault_plan=JFaultPlan.parse(plan) if plan else None, **kw)
    eng_t = Engine(model_t, params_t, ctx_t, cache_dtype=torch.float32, device="cpu",
                   fault_plan=FaultPlan.parse(plan) if plan else None, **kw)
    if warm_up:
        warm(eng_j, JRequest, traffic[0][0])
        warm(eng_t, Request, traffic[0][0])
    reqs_j, reqs_t = make_requests(JRequest, traffic, req_kw), make_requests(Request, traffic, req_kw)
    if hook is not None:   # hook(engine, requests) before the run
        hook(eng_j, reqs_j)
        hook(eng_t, reqs_t)
    sup_j = sup_t = None
    extra = {"extra_inputs": extra_inputs} if extra_inputs is not None else {}
    if supervised:
        sup_j = JEngineSupervisor(eng_j, **{"backoff_s": 0.0, **(sup_kw or {})})
        sup_t = EngineSupervisor(eng_t, **{"backoff_s": 0.0, **(sup_kw or {})})
        sup_j.run(reqs_j, **extra)
        sup_t.run(reqs_t, **extra)
    else:
        eng_j.run(reqs_j, **extra)
        eng_t.run(reqs_t, **extra)
    assert [r.output.tolist() for r in reqs_t] == [r.output.tolist() for r in reqs_j]
    assert [r.outcome for r in reqs_t] == [r.outcome for r in reqs_j]
    assert all(r.outcome in TERMINAL_OUTCOMES for r in reqs_t)
    s_j = (sup_j or eng_j).stats.summary()
    s_t = (sup_t or eng_t).stats.summary()
    for key in OUTCOME_KEYS:
        assert s_t.get(key) == s_j.get(key), key
    if supervised:
        ev = lambda sup: [(e.error, e.mode, e.n_replayed) for e in sup.events]
        assert ev(sup_t) == ev(sup_j)
        assert len(sup_t.stats.timings) == len(traffic)
    a = eng_t.allocator
    assert a.n_held == 0 and a.n_allocated == 0
    assert a.n_free + a.n_cached == eng_t.n_blocks - 1
    return reqs_j, reqs_t, eng_j, eng_t, sup_j, sup_t


def port_outputs(models, traffic, *, gated=False, **kw):
    """The port's fault-free greedy tokens on ``traffic`` (``run_both`` holds
    the port to the reference under the same options)."""
    cfg, _, _, model_t, params_t = models
    eng = Engine(model_t, params_t, contexts(gated)[1], cache_dtype=torch.float32, device="cpu",
                 **kw)
    return [r.output.tolist() for r in eng.run(make_requests(Request, traffic))]


# ------------------------------------------------------------------ fault plans

PLANS = ["exhaust@6:8x4; corrupt@9;slow@3:0.25;die@12", "exhaust@6x4", "corrupt@9:3",
         "stuck@7", "stuck@7:1.5", "", None]
BAD_PLANS = ["exhaust", "explode@3", "die@3:5", "die@3x2", "exhaust@2x0"]


@pytest.mark.parametrize("text", PLANS, ids=lambda t: repr(t))
def test_fault_plan_parse_equals_reference(text):
    j, t = JFaultPlan.parse(text, seed=7), FaultPlan.parse(text, seed=7)
    assert [dataclasses.asdict(f) for f in t.faults] == [dataclasses.asdict(f) for f in j.faults]
    assert t.describe() == j.describe() and len(t) == len(j) and t.seed == j.seed
    assert [f.describe() for f in t.faults] == [f.describe() for f in j.faults]
    for step in (0, 3, 6, 9, 99):
        assert [f.kind for f in t.take(step)] == [f.kind for f in j.take(step)]
        assert t.n_pending == j.n_pending


@pytest.mark.parametrize("text", BAD_PLANS)
def test_fault_plan_errors_equal_reference(text):
    with pytest.raises(ValueError) as ej:
        JFaultPlan.parse(text)
    with pytest.raises(ValueError) as et:
        FaultPlan.parse(text)
    assert str(et.value) == str(ej.value)


def test_fault_plan_take_reset_and_garbage_equal_reference():
    j, t = JFaultPlan.parse("exhaust@2;die@5", seed=3), FaultPlan.parse("exhaust@2;die@5", seed=3)
    assert t.take(1) == [] and [f.kind for f in t.take(3)] == ["exhaust"]
    assert t.take(3) == [] and t.n_pending == 1
    assert [f.kind for f in t.take(99)] == ["die"] and t.n_pending == 0
    g_t, g_j = t.garbage_bytes((4, 5)), j.garbage_bytes((4, 5))
    np.testing.assert_array_equal(g_t, g_j)
    t.reset()
    j.reset()
    assert t.n_pending == 2
    np.testing.assert_array_equal(t.garbage_bytes((7,)), j.garbage_bytes((7,)))
    np.testing.assert_array_equal(FaultPlan(seed=3).garbage_bytes((4, 5)), g_t)


def test_hold_unhold_conserves_like_reference():
    """One sequence of alloc / hold / release / unhold / share on both
    allocators: the same ids and counts after every operation."""
    ops = [("alloc", 3), ("hold", 2), ("alloc", 5), ("alloc", 2), ("hold", 0), ("release", 0),
           ("alloc", 1), ("share", 1), ("unhold", None), ("hold", 4), ("release", 1),
           ("release", 1), ("unhold", None), ("alloc", 7)]
    a_j, a_t = JBlockAllocator(n_blocks=10), BlockAllocator(10)
    got = {"j": [], "t": []}
    for op, arg in ops:
        for name, a in (("j", a_j), ("t", a_t)):
            if op == "alloc":
                got[name].append(a.alloc(arg))
            elif op == "hold":
                got[name].append(a.hold(arg))
            elif op == "unhold":
                got[name].append(a.unhold())
            elif op == "release":
                a.release(got[name][0] if arg == 0 else got[name][3])
            else:
                a.share(got[name][3])
        assert got["t"] == got["j"], op
        assert (a_t.n_free, a_t.n_held, a_t.n_allocated) == (a_j.n_free, a_j.n_held,
                                                             a_j.n_allocated), op
    assert a_t.n_held == 0 and a_t.n_free + a_t.n_allocated == 9


# ------------------------------------------------------ requests and stats

@pytest.mark.parametrize("kw", [dict(deadline_s=-1.0), dict(deadline_ttft_s=0.0),
                                dict(deadline_s=0)], ids=lambda kw: str(kw))
def test_request_validation_equals_reference(kw):
    prompt = np.arange(4, dtype=np.int32)
    with pytest.raises(JInvalidRequest) as ej:
        JRequest(prompt=prompt, max_new_tokens=4, **kw)
    with pytest.raises(InvalidRequest, match="must be > 0 seconds") as et:
        Request(prompt=prompt, max_new_tokens=4, **kw)
    assert str(et.value) == str(ej.value)
    r = Request(prompt=prompt, eos_id=3, deadline_s=1.0, deadline_ttft_s=0.5)
    assert not r.cancelled and r.outcome is None
    r.cancel()
    assert r.cancelled


@pytest.mark.parametrize("outcome", TERMINAL_OUTCOMES)
def test_request_timing_nan_safe_for_every_outcome(outcome):
    kw = dict(arrival_s=0.5, admitted_s=None, first_token_s=None, finished_s=1.0, n_prompt=4,
              n_generated=0, outcome=outcome)
    t, j = RequestTiming(**kw), JRequestTiming(**kw)
    assert np.isnan(t.ttft_s) and np.isnan(t.queue_s) and np.isnan(j.ttft_s)
    assert t.latency_s == j.latency_s == 0.5
    with pytest.raises(ValueError, match="unknown outcome"):
        RequestTiming(**{**kw, "outcome": "exploded"})


def test_serve_stats_merge_and_outcome_counts_equal_reference():
    def timings(cls):
        def t(outcome, first, gen, fin):
            return cls(arrival_s=0.0, admitted_s=0.0 if first else None, first_token_s=first,
                       finished_s=fin, n_prompt=4, n_generated=gen, outcome=outcome,
                       inter_token_s=[0.01] * max(gen - 1, 0))
        return ([t(OUTCOME_OK, 0.1, 10, 1.0), t(OUTCOME_TIMED_OUT, 0.2, 6, 2.0)],
                [t(OUTCOME_OK, 0.3, 4, 2.0), t(OUTCOME_REJECTED, None, 0, 0.5),
                 t(OUTCOME_CANCELLED, 0.4, 2, 1.5)])

    summaries = []
    for stats_cls, timing_cls in ((JServeStats, JRequestTiming), (ServeStats, RequestTiming)):
        first, second = timings(timing_cls)
        a, b = stats_cls(), stats_cls()
        for t in first:
            a.record(t)
        for t in second:
            b.record(t)
        a.record_step(8, 2, compressed=True)
        b.record_step(8, 4)
        b.record_dispatch(2, prefill_tokens=5)
        a.merge(b)
        summaries.append(a.summary())
    s_j, s_t = summaries
    assert s_t == s_j
    assert (s_t["n_ok"], s_t["n_rejected"], s_t["n_timed_out"], s_t["n_cancelled"]) == (2, 1, 1, 1)
    assert s_t["goodput_tokens_per_s"] == pytest.approx(14 / 2.0)
    assert (s_t["n_steps"], s_t["n_dispatches"], s_t["prefill_tokens"]) == (2, 4, 21)


# ------------------------------------------------ engine outcomes vs reference

def test_max_queue_rejects_like_reference(models, reference_copies_host_arrays):
    """Four requests at t=0 on two slots with ``max_queue=1``: two admitted,
    one queued, one rejected with no output."""
    reqs_j, reqs_t, *_ = run_both(models, traffic(models[0].vocab_size, 4, 16, 4),
                                  max_queue=1, **BASE)
    outs = [r.outcome for r in reqs_t]
    assert outs.count(OUTCOME_REJECTED) == 1 and outs.count(OUTCOME_OK) == 3
    rej = reqs_t[outs.index(OUTCOME_REJECTED)]
    assert rej.timing.admitted_s is None and len(rej.output) == 0


def test_ttft_deadline_times_out_like_reference(models, reference_copies_host_arrays):
    reqs_j, reqs_t, _, eng_t, _, _ = run_both(
        models, traffic(models[0].vocab_size, 2, 16, 8), deadline_ttft_s=1e-6, **BASE)
    assert all(r.outcome == OUTCOME_TIMED_OUT and r.timing.first_token_s is None
               and np.isnan(r.timing.ttft_s) and r.ttft_s is None for r in reqs_t)
    assert eng_t.stats.summary()["ttft_p50_s"] == 0.0


def test_cancel_before_run_like_reference(models, reference_copies_host_arrays):
    tr = traffic(models[0].vocab_size, 3, 16, 6)
    cfg, model_j, params_j, model_t, params_t = models
    outs = {}
    for name, eng, cls in (
            ("j", JEngine(model_j, params_j, JTPContext(mesh=None), cache_dtype=jnp.float32,
                          **BASE), JRequest),
            ("t", Engine(model_t, params_t, TPContext(), cache_dtype=torch.float32,
                         device="cpu", **BASE), Request)):
        reqs = make_requests(cls, tr)
        reqs[1].cancel()
        eng.run(reqs)
        s = eng.stats.summary()
        outs[name] = ([r.outcome for r in reqs], [r.output.tolist() for r in reqs],
                      [s[k] for k in OUTCOME_KEYS], reqs[1].timing.admitted_s)
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == [OUTCOME_OK, OUTCOME_CANCELLED, OUTCOME_OK] and outs["t"][3] is None


def test_eos_id_stops_like_reference(models, reference_copies_host_arrays):
    """Request 0's eos_id is the third token of its run without one: it
    stops at that token's first occurrence, ``ok``; the rest run on."""
    tr = traffic(models[0].vocab_size, 3, 16, 8)
    free = port_outputs(models, tr, **BASE)
    eos = free[0][2]
    stop = free[0].index(eos) + 1
    reqs_j, reqs_t, *_ = run_both(models, tr, req_kw=[dict(eos_id=eos), {}, {}], **BASE)
    assert reqs_t[0].outcome == OUTCOME_OK and reqs_t[0].output.tolist() == free[0][:stop]
    assert all(len(r.output) == 8 for r in reqs_t[1:])


def test_exhaust_fault_defers_and_conserves_like_reference(models, reference_copies_host_arrays):
    """Every free block held from step 2 for 5 steps: the schedulers defer,
    the hold returns on schedule, tokens equal the reference's and the
    fault-free run's."""
    tr = traffic(models[0].vocab_size, 2, 16, 8)
    free = port_outputs(models, tr, **BASE)
    reqs_j, reqs_t, _, eng_t, _, _ = run_both(models, tr, plan="exhaust@2x5", **BASE)
    assert eng_t.fault_plan.n_pending == 0
    assert all(r.outcome == OUTCOME_OK for r in reqs_t)
    assert [r.output.tolist() for r in reqs_t] == free


def test_stall_guard_default_and_livelock_like_reference(models):
    """``stall_limit`` defaults to 256 as in the reference; a step that never
    makes a token (a livelocked scheduler, forced here) raises StepStuck at
    the 256th step in both engines, with the same message."""
    cfg, model_j, params_j, model_t, params_t = models
    eng_j = JEngine(model_j, params_j, JTPContext(mesh=None), cache_dtype=jnp.float32, **BASE)
    eng_t = Engine(model_t, params_t, TPContext(), cache_dtype=torch.float32, device="cpu",
                   **BASE)
    assert eng_t.stall_limit == eng_j.stall_limit == 256
    msgs = []
    for eng, cls, err in ((eng_j, JRequest, JStepStuck), (eng_t, Request, StepStuck)):
        eng._step_mixed = lambda: 0
        with pytest.raises(err, match="scheduler livelock") as e:
            eng.run(make_requests(cls, traffic(cfg.vocab_size, 2, 16, 4)))
        msgs.append((str(e.value), eng._step_i))
    assert msgs[1] == msgs[0] and msgs[1][1] == 256
    assert eng_t.allocator.n_held == 0


@pytest.mark.parametrize("plan,watch", [(None, False), ("die@99", False), ("corrupt@99", True)])
def test_corruption_watch_shares_the_token_copy(models, monkeypatch, plan, watch):
    """The watch is on only under a plan that can corrupt, and its finite
    flags ride in the tokens' device-to-host copy: a run makes as many
    copies with the watch as without it, one per step, and gives the same
    tokens."""
    cfg, _, _, model_t, params_t = models
    tr = traffic(cfg.vocab_size, 2, 16, 6)
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *args, **kwargs):
        copies.append(tuple(self.shape))
        return real_cpu(self, *args, **kwargs)

    eng = Engine(model_t, params_t, TPContext(), cache_dtype=torch.float32, device="cpu",
                 fault_plan=FaultPlan.parse(plan) if plan else None, **BASE)
    assert eng._nan_watch is watch
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    reqs = eng.run(make_requests(Request, tr))
    monkeypatch.undo()
    assert len(copies) == eng.stats.n_steps   # every mixed step samples once
    assert set(copies) == {(2, 2) if watch else (2,)}
    assert [r.output.tolist() for r in reqs] == port_outputs(models, tr, **BASE)


# --------------------------------------- mid-run cancel and deadline, on a clock

class AdvancingClock:
    """``time`` for the engines: ``sleep`` adds to an offset of
    ``perf_counter`` instead of waiting, so a ``slow`` or ``stuck`` fault
    moves the engines' clock on at once and the same step in both."""

    def __init__(self):
        self.offset = 0.0

    def perf_counter(self):
        return time.perf_counter() + self.offset

    def sleep(self, seconds):
        self.offset += seconds

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def sleep_advances_clock(monkeypatch):
    import repro.serving.engine as reference_engine
    import repro_torch.serving.engine as port_engine

    for module in (reference_engine, port_engine):
        monkeypatch.setattr(module, "time", AdvancingClock())


def test_cancel_mid_decode_like_reference(models, reference_copies_host_arrays):
    """``cancel()`` called from another thread after step 5 (the engines'
    step check starts the thread and joins it, so both engines see it at the
    same step): request 0 leaves ``cancelled`` with the tokens of its first
    steps, its blocks freed; request 1 runs to the end."""
    def cancel_after_step_5(eng, reqs):
        guard = eng._guard_step

        def hooked(n_tok, elapsed_s):
            guard(n_tok, elapsed_s)
            if eng._step_i == 5:
                t = threading.Thread(target=reqs[0].cancel)
                t.start()
                t.join()
        eng._guard_step = hooked

    tr = traffic(models[0].vocab_size, 2, 16, 12)
    free = port_outputs(models, tr, **BASE)
    reqs_j, reqs_t, *_ = run_both(models, tr, hook=cancel_after_step_5, **BASE)
    assert reqs_t[0].outcome == OUTCOME_CANCELLED and 0 < len(reqs_t[0].output) < 12
    assert reqs_t[0].output.tolist() == free[0][:len(reqs_t[0].output)]
    assert reqs_t[1].outcome == OUTCOME_OK and reqs_t[1].output.tolist() == free[1]


def test_total_deadline_times_out_mid_decode_like_reference(models, reference_copies_host_arrays,
                                                           sleep_advances_clock):
    """A 100 s ``slow`` fault at step 5 against a 50 s engine deadline: both
    requests leave ``timed_out`` at the next sweep with the tokens of their
    first steps, blocks freed."""
    tr = traffic(models[0].vocab_size, 2, 16, 12)
    free = port_outputs(models, tr, **BASE)
    reqs_j, reqs_t, *_ = run_both(models, tr, plan="slow@5:100", deadline_s=50.0, **BASE)
    assert all(r.outcome == OUTCOME_TIMED_OUT and 0 < len(r.output) < 12
               and r.output.tolist() == f[:len(r.output)] for r, f in zip(reqs_t, free))
    assert all(r.latency_s >= 50.0 for r in reqs_t)
