"""The port's compile-once step programs (``serving/graphs.py``) against the
reference Engine's jitted ones, on reduced llama2-7b in fp32 on the CPU.

``decode_cache_size()`` / ``prefill_cache_size()`` equal the reference's
after the same traffic (tokens and stats held by ``serve_both``): the mixed
step under a dense context and under PAPER_DEFAULT over ``simulate_tp=2``
(both gate variants), the split chunked scheduler, whole-prompt prefill over
prompts in 3 buckets and over 9 buckets and a repeat (the LRU of 8 evicts
and counts), and after ``measure_ttft`` (its bucket counts on a
whole-prompt engine only). Also: the chunk step with ``start`` / ``n_valid``
as device scalars and the prefill with a tensor ``last_index`` are
bit-identical to the int calls; the capture accounting of
``kernels/build.py`` with a stand-in launcher; a ``StepProgram``'s static
buffers (one fixed address per input, host arrays copied at the call); a
hard ``recover`` zeroes every pool plane at its own address, and a
supervised run under ``corrupt@3`` gives the reference supervisor's tokens.
TF32 is off for torch matmuls.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serving import Engine
from repro_torch.serving.graphs import PREFILL_PROGRAMS_MAX, StepProgram, StepPrograms
from tests.conftest import fp32_reduced
from tests.test_torch_faults import run_both
from tests.test_torch_serving import (  # noqa: F401 (fixtures)
    reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CHUNKED = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=16)


@pytest.fixture(scope="module")
def llama():
    cfg_j = fp32_reduced("llama2-7b")
    cfg_t = dataclasses.replace(reduced_config(get_config("llama2-7b")), dtype="float32")
    model_j = JModel(cfg_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t, "cpu")
    return cfg_t, model_j, params_j, Model(cfg_t), params_t


def traffic(vocab, lengths, new=3):
    return [(((np.arange(n, dtype=np.int32) * 7 + i) % vocab).astype(np.int32), new)
            for i, n in enumerate(lengths)]


def counts(eng):
    return eng.decode_cache_size(), eng.prefill_cache_size()


# (engine options, prompt lengths, gated, the counts expected after the traffic)
CASES = {
    "mixed-dense": (dict(CHUNKED, token_budget=18), (5, 14, 23, 32), False, (1, 1)),
    "mixed-gated-simulate_tp2": (dict(CHUNKED, token_budget=18), (5, 14, 23, 32), True,
                                 (2, 2)),
    "split-chunked": (dict(CHUNKED, token_budget=0), (5, 14, 23, 32), False, (1, 1)),
    # buckets 16, 32, 64
    "whole-3-buckets": (dict(max_slots=2, max_len=80, block_size=16, prefill_chunk=0),
                        (5, 20, 40, 9), False, (1, 3)),
    # buckets 2..256 and the capacity, 264 (9 of them), then bucket 2 again
    # after the LRU dropped it
    "whole-9-buckets-lru": (dict(max_slots=2, max_len=264, block_size=2, prefill_chunk=0),
                            (1, 3, 5, 9, 17, 33, 65, 129, 257, 2), False, (1, 10)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_counts_equal_reference(llama, case, reference_copies_host_arrays):
    kw, lengths, gated, expect = CASES[case]
    eng_j, eng_t, _ = serve_both(llama, traffic(llama[0].vocab_size, lengths), gated=gated,
                                 cache_spec="bf16", **kw)
    assert counts(eng_t) == counts(eng_j) == expect
    if gated:
        assert eng_t.gate_counts["compressed"] > 0 and eng_t.gate_counts["dense"] > 0


@pytest.mark.parametrize("case", ["mixed-dense", "whole-3-buckets"])
def test_program_counts_after_measure_ttft(llama, case, reference_copies_host_arrays):
    """``measure_ttft`` prefills through the whole-prompt bucket programs:
    its probe bucket counts on a whole-prompt engine, not on a mixed one."""
    kw, lengths, gated, expect = CASES[case]
    eng_j, eng_t, _ = serve_both(llama, traffic(llama[0].vocab_size, lengths), gated=gated,
                                 cache_spec="bf16", **kw)
    for eng in (eng_j, eng_t):
        r = eng.measure_ttft(kw["max_len"] - 10, iters=2)   # a bucket not served
        assert r["iters"] == 1
    whole = not kw["prefill_chunk"]
    assert counts(eng_t) == counts(eng_j) == (expect[0], expect[1] + whole)


def test_chunk_step_device_scalars_bit_identical(llama):
    """``prefill_chunk`` with ``start`` / ``n_valid`` as 0-d int32 tensors
    (what a captured chunk reads from its static buffer) and ``prefill``
    with a tensor ``last_index`` equal the int calls bit for bit, logits and
    pools."""
    from repro_torch.core.tp import TPContext
    from repro_torch.serving.kv_cache import init_paged_state

    cfg, _, _, model, params = llama
    rng = np.random.default_rng(0)
    table = torch.tensor([3, 1, 4, 0], dtype=torch.int32)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 16)), dtype=torch.int32)
    outs = []
    for scalar in (lambda v: v, lambda v: torch.tensor(v, dtype=torch.int32)):
        state = init_paged_state(cfg, 2, 6, 16, torch.float32, device="cpu")
        logits = []
        for start, n_valid in ((0, 16), (16, 16), (32, 9)):
            lg, state = model.prefill_chunk(TPContext(), params, tokens, state, table,
                                            scalar(start), scalar(n_valid))
            logits.append(lg)
        outs.append((logits, state))
    (lg_int, st_int), (lg_dev, st_dev) = outs
    assert all(torch.equal(a, b) for a, b in zip(lg_int, lg_dev))
    assert all(torch.equal(a, b) for a, b in zip(st_int["pools_k"] + st_int["pools_v"],
                                                 st_dev["pools_k"] + st_dev["pools_v"]))
    cache = lambda: model.init_cache(1, 32, torch.float32, "cpu")
    batch = {"tokens": torch.cat([tokens, tokens], dim=1)}
    a, _ = model.prefill(TPContext(), params, batch, cache(), last_index=20)
    b, _ = model.prefill(TPContext(), params, batch, cache(),
                         last_index=torch.tensor(20, dtype=torch.int32))
    assert torch.equal(a, b) and a.shape == (1, cfg.vocab_size)


def test_capture_launch_accounting(monkeypatch):
    """A stand-in launcher counting through ``count_launch``: launches made
    while a capture's record is open go to the record, not the counters;
    each replay adds the record; records nest and close on an error."""
    monkeypatch.setattr(build, "_LAUNCHES", {n: 0 for n in build.KERNEL_NAMES})

    def launcher(n_quant, n_paged):
        for _ in range(n_quant):
            build.count_launch("mx_quant")
        for _ in range(n_paged):
            build.count_launch("paged_attention")

    launcher(2, 1)                       # the warm-up: real launches, counted
    with build.record_launches() as record:
        launcher(3, 2)                   # the capture: recorded only
    assert build.launch_counts()["mx_quant"] == 2 and record == {"mx_quant": 3,
                                                                 "paged_attention": 2}
    for _ in range(4):                   # four replays
        build.add_launches(record)
    got = build.launch_counts()
    assert got["mx_quant"] == 2 + 4 * 3 and got["paged_attention"] == 1 + 4 * 2
    with build.record_launches() as outer:
        launcher(1, 0)
        with pytest.raises(RuntimeError):
            with build.record_launches() as inner:
                launcher(0, 1)
                raise RuntimeError("capture failed")
        launcher(1, 0)
    assert outer == {"mx_quant": 2} and inner == {"paged_attention": 1}
    build.check_launch("mx_quant", 0)
    with pytest.raises(RuntimeError, match="failed to launch"):
        build.check_launch("mx_quant", 700)
    build.reset_launch_counts()
    assert not any(build.launch_counts().values())


def test_step_program_static_buffers():
    """One fixed address per input across calls; the host arrays are copied
    at the call (mutating them afterwards does not reach the buffers); bool
    and 0-d inputs; wrong input names refused; an LRU of prefill programs
    counting only those that ran."""
    seen = []

    def fn(tokens, valid, start):
        seen.append((tokens.data_ptr(), valid.data_ptr(), start.data_ptr()))
        return tokens.sum() + start + valid.sum()

    prog = StepProgram("t", fn, dict(tokens=((1, 5), torch.int32), valid=((5,), torch.bool),
                                     start=((), torch.int32)),
                       torch.device("cpu"), graphed=False)
    assert not prog.built
    host = np.arange(5, dtype=np.int32)[None]
    valid = np.array([True, False, True, True, False])
    assert int(prog(tokens=host, valid=valid, start=7)) == 10 + 7 + 3
    host[0, 0] = 100
    assert prog.inputs["tokens"].tolist() == [[0, 1, 2, 3, 4]]
    assert int(prog(tokens=host, valid=valid, start=np.int64(1))) == 110 + 1 + 3
    assert seen[0] == seen[1] and prog.built and prog.n_calls == 2
    assert prog.inputs["valid"].dtype == torch.bool and prog.inputs["start"].shape == ()
    with pytest.raises(TypeError, match="inputs"):
        prog(tokens=host, valid=valid)

    progs = StepPrograms(torch.device("cpu"), graphed=False)
    make = lambda: (lambda x: x + 1, dict(x=((1,), torch.int32)))
    for b in range(PREFILL_PROGRAMS_MAX + 2):
        p = progs.prefill(b, make)
        if b != 1:                       # bucket 1 is made, never run
            p(x=np.array([b]))
    assert progs.evicted_prefill == 1 and progs.prefill_count() == PREFILL_PROGRAMS_MAX + 1
    assert progs.capture_seconds() == {}


def test_hard_recover_zeroes_pools_in_place(llama, reference_copies_host_arrays):
    """A supervised mixed run under ``corrupt@3`` on fp4 pools recovers hard
    with the reference supervisor's tokens, outcomes and recoveries
    (``run_both``), and the pools keep their addresses through it; a hard
    ``recover`` after the run zeroes every plane at its own address, and the
    engine's program counts equal the reference's (programs survive a
    recovery)."""
    planes = {}

    def record(eng, _reqs):
        if isinstance(eng, Engine):
            planes["before"] = [a.data_ptr() for a in eng._pool_planes()]

    _, _, eng_j, eng_t, sup_j, sup_t = run_both(
        llama, traffic(llama[0].vocab_size, (5, 14, 23, 32), new=5), plan="corrupt@3",
        supervised=True, hook=record, cache_spec="fp4_e2m1", token_budget=18, **CHUNKED)
    assert [e.mode for e in sup_t.events] == ["hard"]
    assert [a.data_ptr() for a in eng_t._pool_planes()] == planes["before"]
    assert any(bool(a.any()) for a in eng_t._pool_planes())
    eng_t.recover(hard=True)
    assert [a.data_ptr() for a in eng_t._pool_planes()] == planes["before"]
    assert not any(bool(a.any()) for a in eng_t._pool_planes())
    assert counts(eng_t) == counts(eng_j)
