"""Sequence-sharded paged KV pools of the port against the reference.

* The sharded ``BlockAllocator`` against the reference's
  (``repro.serving.BlockAllocator(shards=N)``), in process: the same ids
  through seeded random churn of alloc, release, share, fault holds and
  prefix-index reclaim, and per-shard conservation after every operation;
  ``shards=1`` is the plain FIFO.
* ``paged_cache_bytes`` (global and per device) against the reference for
  every ported config.
* The five pool ops and ``masked_owner_psum`` on 2 gloo ranks against a
  numpy model of the reference's semantics, bit for bit, over uint8 wire
  bytes (scale byte 255 included), bf16 and fp32 planes holding ``-0.0``,
  infinities and NaN payloads.
* The kv-sharded engine on 2 gloo ranks: greedy tokens identical on both
  ranks, to the port's replicated engine and to the reference's
  single-device ``Engine``, in every cache mode (fp32 and bf16 pools, fp4
  wire pools under the gated ``simulate_tp=2`` policy), through eviction on
  the split scheduler, with a prefix-cache COW fork, and in one supervised
  ``corrupt@`` run; each rank holds ``n_blocks / 2`` blocks of every pool,
  and the exchange's all-reduces are exactly layers x planes per paged
  read. At a fixed per-rank pool budget the sharded engine serves a prompt
  at least 1.9x longer than the replicated one admits, and the replicated
  engine refuses it.
* The whole-prompt stacks on the same 2 kv ranks: reduced jamba (Mamba,
  Mamba + MoE, attention), xlstm-125m (mLSTM, sLSTM: no pools), whisper
  (encoder-decoder, 24 encoder frames) and pixtral (an 8-patch vision
  prefix), whole-prompt on fp4 pools under the gated ``simulate_tp=2``
  policy: greedy tokens and counts identical on both ranks and to the
  reference's single-device ``Engine`` (built with ``donate_cache=False``
  for the sLSTM stack, ROADMAP.md Queue 3 item 17); each rank holds half of
  the attention pools (pixtral's prefix blocks among them) and the whole
  recurrent state and cross K/V; only the decode steps' paged reads
  exchange blocks.
* ``launch/serve.py --shard-pools 2`` on the CPU.

Reduced internlm2-1.8b in fp32 on the CPU, every request at t=0, the
reference's host arrays copied. One pair of ranks serves every case of this
module (``file://`` rendezvous in a temporary directory, no fixed port); the
ranks import torch and the port only (``tests/torch_kv_worker.py``).
TF32 is off for torch matmuls.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as reference_engine
from repro.configs import get_config as jget_config
from repro.models.model import Model as JModel
from repro.serving import BlockAllocator as JBlockAllocator
from repro.serving import Engine as JEngine
from repro.serving import EngineSupervisor as JEngineSupervisor
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import Request as JRequest
from repro.serving.kv_cache import PrefixIndex as JPrefixIndex
from repro.serving.kv_cache import paged_cache_bytes as jpaged_cache_bytes
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core.formats import KVCacheSpec
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.serving import BlockAllocator, PrefixIndex, paged_cache_bytes
from repro_torch.serving.kv_cache import cross_state_bytes, recurrent_state_bytes
from tests.conftest import fp32_reduced
from tests.test_torch_frontends import stub_arrays
from tests.test_torch_serving import (  # noqa: F401 (fixture)
    SUMMARY_KEYS, _CopyingJnp, contexts, models, parity_traffic,
)
from tests.torch_kv_worker import run_cases, run_rank

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KV = 2


# ------------------------------------------------------------------ allocator


def _churn(shards: int, seed: int, n_blocks: int = 24, steps: int = 300):
    """Drive the port's and the reference's allocators (each with a prefix
    index) through the same seeded operations; returns the log of results,
    checked equal op by op, and the port's allocator."""
    rng = np.random.default_rng(seed)
    pi_t, pi_j = PrefixIndex(4), JPrefixIndex(4)
    a_t = BlockAllocator(n_blocks, pi_t, shards=shards)
    a_j = JBlockAllocator(n_blocks, pi_j, shards=shards)
    live, held, next_hash = [], 0, 0
    for _ in range(steps):
        op = rng.choice(["alloc", "release", "share", "register", "hold", "unhold"],
                        p=[0.35, 0.25, 0.1, 0.15, 0.075, 0.075])
        if op == "alloc":
            n = int(rng.integers(1, 5))
            got_t, got_j = a_t.alloc(n), a_j.alloc(n)
            assert got_t == got_j
            live += got_t or []
        elif op == "release" and live:
            drop = [live.pop(int(rng.integers(len(live)))) for _ in range(
                int(rng.integers(1, len(live) + 1)))]
            a_t.release(drop)
            a_j.release(drop)
        elif op == "share" and live:
            b = live[int(rng.integers(len(live)))]
            a_t.share([b])
            a_j.share([b])
            live.append(b)
        elif op == "register" and live:
            b = live[int(rng.integers(len(live)))]
            assert pi_t.register(next_hash, b) == pi_j.register(next_hash, b)
            next_hash += 1
        elif op == "hold" and not held:
            held = int(rng.integers(0, 4))
            assert a_t.hold(held) == a_j.hold(held)
        elif op == "unhold":
            assert a_t.unhold() == a_j.unhold()
            held = 0
        assert a_t.free_per_shard == a_j.free_per_shard
        assert (a_t.n_free, a_t.n_cached, a_t.n_allocated, a_t.n_held) == (
            a_j.n_free, a_j.n_cached, a_j.n_allocated, a_j.n_held)
        # per-shard conservation: free + held + referenced + cached = capacity
        per = collections.Counter(a_t.shard_of(b) for b in
                                  [*a_t._ref, *a_t._held, *pi_t._lru])
        for s in range(shards):
            assert a_t.free_per_shard[s] + per[s] == a_t.per_shard - (s == 0)
            assert all(a_t.shard_of(b) == s for b in a_t._free[s])
    return a_t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_allocator_matches_reference_through_churn(shards, seed):
    _churn(shards, seed)


def test_allocator_round_robin_and_single_shard_fifo():
    a = BlockAllocator(16, shards=4)
    ids = a.alloc(8)
    assert ids == JBlockAllocator(16, shards=4).alloc(8)
    per = [sum(1 for b in ids if a.shard_of(b) == s) for s in range(4)]
    assert max(per) - min(per) <= 1, per
    a.release(ids)
    assert a.free_per_shard == [3, 4, 4, 4] and a.n_free == 15
    one = BlockAllocator(16)
    assert (one.shards, one.per_shard) == (1, 16) and one.alloc(5) == [1, 2, 3, 4, 5]
    one.release([3])
    assert one.alloc(2) == [6, 7] and list(one._free[0])[-1] == 3
    with pytest.raises(AssertionError):
        BlockAllocator(10, shards=4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_paged_cache_bytes_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for spec in (None, "fp4_e2m1", "int8_b16_e8m0"):
        for shards, per_device in ((1, False), (KV, False), (KV, True), (4, True)):
            kw = dict(cache_spec=spec, kv_shards=shards, per_device=per_device)
            assert paged_cache_bytes(cfg, 64, 16, **kw) == jpaged_cache_bytes(jcfg, 64, 16, **kw)
    total = paged_cache_bytes(cfg, 32, 16)
    assert paged_cache_bytes(cfg, 64, 16, kv_shards=KV, per_device=True) == total


# ---------------------------------------------------- 2 ranks: probe and engine

ENGINE = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=16, token_budget=18)


def _cases(vocab):
    parity = parity_traffic(vocab)
    evict = [(np.arange(20, dtype=np.int32) * 3 % vocab, 30) for _ in range(2)]
    shared = [((np.arange(32, dtype=np.int32) * 7 + 3) % vocab, 6) for _ in range(2)]
    fault = [((np.arange(16, dtype=np.int32) + 3 * i) % vocab, 8) for i in range(2)]
    long_s = (2 * 9 - 1) * 16 - 4 + 1            # what 17 usable blocks of 16 hold
    longp = [((np.arange(long_s, dtype=np.int32) * 5) % vocab, 4)]
    return {
        "mixed-fp32": dict(engine=dict(ENGINE), traffic=parity),
        "mixed-bf16": dict(engine=dict(ENGINE, cache_dtype="bfloat16"), traffic=parity),
        "mixed-fp4-gated": dict(engine=dict(ENGINE, cache_spec="fp4_e2m1"), traffic=parity,
                                gated=True),
        # 5 usable blocks for two requests of 4 blocks each: the split
        # scheduler preempts (an even pool, so every engine has 6 blocks)
        "split-evict-fp4": dict(engine=dict(max_slots=2, max_len=64, block_size=16, n_blocks=6,
                                            prefill_chunk=8, token_budget=0,
                                            cache_spec="fp4_e2m1"), traffic=evict),
        # exact pools: the warm run's full-prompt hits fork their tail block;
        # 7 blocks by default, rounded up to 8 on 2 ranks
        "prefix-cow": dict(engine=dict(max_slots=2, max_len=48, prefix_cache=True,
                                       persistent_cache=True), traffic=shared, runs=2),
        "corrupt-fp4": dict(engine=dict(max_slots=2, max_len=64, cache_spec="fp4_e2m1"),
                            traffic=fault, plan="corrupt@3"),
        # a fixed per-rank budget of 9 blocks: 18 blocks over 2 ranks
        "capacity": dict(engine=dict(max_slots=1, max_len=288, block_size=16, n_blocks=18,
                                     cache_spec="fp4_e2m1"), traffic=longp),
    }


# the whole-prompt stacks: key -> (arch, overrides of the reduced config)
STACKS = {"jamba": ("jamba-v0.1-52b", dict(n_layers=3)), "xlstm": ("xlstm-125m", {}),
          "whisper": ("whisper-medium", dict(encoder_seq=24)),
          "pixtral": ("pixtral-12b", dict(n_patches=8))}


def _stack_models(arch, over):
    """(port cfg, reference model, reference params, None, None) of a
    reduced fp32 whole-prompt stack."""
    n = over.get("n_layers")
    rest = {k: v for k, v in over.items() if k != "n_layers"}
    cfg_j = dataclasses.replace(fp32_reduced(arch, **({"n_layers": n} if n else {})), **rest)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch), **({"n_layers": n} if n else {})),
                                dtype="float32", **rest)
    model_j = JModel(cfg_j)
    return cfg_t, model_j, model_j.init_params(jax.random.PRNGKey(0)), None, None


def _stack_case(key, cfg):
    """The whole-prompt engine (the stack's only scheduler) on fp4 pools,
    gated, over prompts of 12, 20 and 12 tokens, with one row of extra
    inputs each for a vision prefix or an encoder-decoder."""
    traffic = [(((np.arange(n, dtype=np.int32) * 7 + i) % cfg.vocab_size).astype(np.int32),
                4 + i) for i, n in enumerate((12, 20, 12))]
    case = dict(engine=dict(max_slots=2, max_len=64, block_size=16, cache_spec="fp4_e2m1"),
                traffic=traffic, gated=True)
    if key == "xlstm":
        case["ref_engine"] = dict(donate_cache=False)   # ROADMAP.md Queue 3 item 17
    if key in ("whisper", "pixtral"):
        case["extra"] = stub_arrays(cfg, len(traffic), 33)
    return case


def _probe():
    """Global planes of 8 blocks x 4 positions (uint8 wire bytes with scale
    byte 255, bf16 and fp32 with -0.0, infinities and NaN payloads), the
    table rows to exchange and what each write op writes."""
    rng = np.random.default_rng(21)
    u8 = rng.integers(0, 256, (8, 4, 6), dtype=np.uint8)
    u8[3, 1, :] = 255
    b16 = rng.integers(0, 2**16, (8, 4, 5), dtype=np.uint16)
    b16[2, 0, :] = [0x8000, 0x7fc1, 0xff81, 0x7f81, 0xff80]    # -0, NaNs, -inf
    f32 = rng.integers(0, 2**32, (8, 4, 3), dtype=np.uint32)
    f32[6, 3, :] = [0x80000000, 0x7fc00001, 0xffc12345]          # -0, NaN payloads
    f32[1, 0, :] = [0x7f800001, 0x7f800000, 0x00000001]          # sNaN, inf, denormal
    planes = [u8, b16, f32]
    dtypes = [torch.uint8, torch.bfloat16, torch.float32]
    as_bytes = lambda a: np.ascontiguousarray(a).view(np.uint8)
    rows = [rng.integers(0, 256, (6, a.shape[2] * a.itemsize), dtype=np.uint8) for a in planes]
    rows[2][0, :4] = np.array([0x80000000], np.uint32).view(np.uint8)   # a -0.0 row value
    blocks = [rng.integers(0, 256, (2, 4, a.shape[2] * a.itemsize), dtype=np.uint8)
              for a in planes]
    return dict(planes=[as_bytes(a) for a in planes], dtypes=dtypes,
                tables=np.array([[1, 6, 0, 3], [5, 5, 2, 7], [0, 0, 0, 0]], np.int32),
                blk=np.array([0, 3, 4, 7, 5, 2], np.int64), offs=np.array([1, 0, 3, 2, 2, 1]),
                rows=rows, blocks=blocks, block_ids=[1, 6], fills=[255, float("nan"),
                                                                   float("nan")],
                fill_block=5, copies=[(2, 7), (6, 3), (1, 2)])


def _probe_model(probe):
    """The reference's semantics on the global planes, in numpy bytes:
    (psum, exchange, and the pools after scatter, write, fill, copy)."""
    pools = [a.copy() for a in probe["planes"]]
    out = {"psum": [a.copy() for a in pools],
           "exchange": [a[probe["tables"].reshape(-1)] for a in pools]}
    for a, v in zip(pools, probe["rows"]):
        for i, (b, o) in enumerate(zip(probe["blk"], probe["offs"])):
            a[b, o] = v[i]
    out["scatter"] = [a.copy() for a in pools]
    for a, v in zip(pools, probe["blocks"]):
        a[probe["block_ids"]] = v
    out["write"] = [a.copy() for a in pools]
    fill_bytes = [np.array([255], np.uint8), np.array([np.nan], jnp.bfloat16).view(np.uint8),
                  np.array([np.nan], np.float32).view(np.uint8)]
    for a, f in zip(pools, fill_bytes):
        a[probe["fill_block"]] = np.tile(f, a.shape[2] // len(f))
    out["fill"] = [a.copy() for a in pools]
    for src, dst in probe["copies"]:
        for a in pools:
            a[dst] = a[src]
    out["copy"] = [a.copy() for a in pools]
    return out


def _reference(models, case):
    """The reference's single-device Engine on one case (with the model's
    ``case["extra"]`` inputs when given, and ``case["ref_engine"]``, options
    of the reference Engine alone): per run, outputs, the summary's counts
    and the recovery events."""
    cfg, model_j, params_j, _, _ = models
    kw = dict(case["engine"], **case.get("ref_engine", {}))
    kw["cache_dtype"] = getattr(jnp, kw.get("cache_dtype", "float32"))
    plan = case.get("plan")
    eng = JEngine(model_j, params_j, contexts(case.get("gated", False))[0],
                  fault_plan=JFaultPlan.parse(plan) if plan else None, **kw)
    runs = []
    for _ in range(case.get("runs", 1)):
        reqs = [JRequest(prompt=np.asarray(p).copy(), max_new_tokens=n, arrival_s=0.0)
                for p, n in case["traffic"]]
        sup = JEngineSupervisor(eng, backoff_s=0.0) if plan else None
        (sup or eng).run(reqs, extra_inputs=case.get("extra"))
        s = (sup or eng).stats.summary()
        runs.append(dict(outputs=[r.output.tolist() for r in reqs],
                         summary={k: s[k] for k in SUMMARY_KEYS},
                         events=[(e.error, e.mode, e.n_replayed, e.detail)
                                 for e in (sup.events if sup else [])]))
    return runs


@pytest.fixture(scope="module")
def served(models):
    """Every case on the reference Engine, the port's replicated engine and
    2 kv ranks of the port (one spawn for the module), and the pool-op
    probe on the ranks."""
    cfg, _, params_j, _, _ = models
    cases = _cases(cfg.vocab_size)
    params_np = jax.tree.map(np.asarray, params_j)
    probe = _probe()
    stack_models = {k: _stack_models(*v) for k, v in STACKS.items()}
    stacks = {k: dict(cfg=m[0], params=jax.tree.map(np.asarray, m[2]),
                      cases={"whole-fp4": _stack_case(k, m[0])})
              for k, m in stack_models.items()}
    job = dict(cfg=cfg, params=params_np, cases=cases, probe=probe, stacks=stacks)
    ranks = spawn_ranks(run_rank, KV, job, device="cpu", threads=2, timeout_s=600)
    # the replicated port engine; a 9-block pool (the per-rank budget) must
    # refuse the long prompt
    refused = dict(cases["capacity"], engine=dict(cases["capacity"]["engine"], n_blocks=9))
    replicated = run_cases(None, "cpu", cfg, params_np, {**cases, "capacity-refused": refused})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reference_engine, "jnp", _CopyingJnp())
        reference = {name: _reference(models, case) for name, case in cases.items()
                     if name != "capacity"}
        stack_reference = {k: _reference(stack_models[k], m["cases"]["whole-fp4"])
                           for k, m in stacks.items()}
    return dict(cases=cases, probe=probe, ranks=ranks, replicated=replicated,
                reference=reference, stacks=stacks, stack_reference=stack_reference)


@pytest.mark.parametrize("op", ["psum", "exchange", "scatter", "write", "fill", "copy"])
def test_pool_ops_bit_exact_on_two_ranks(served, op):
    """``masked_owner_psum`` and ``pool_exchange`` give every rank the global
    values; after each write op the ranks' slabs, put together, are the
    global pools the reference's semantics give. Bytes compared."""
    want = _probe_model(served["probe"])[op]
    got = [r["pool_ops"][op] for r in served["ranks"]]
    for i, w in enumerate(want):
        if op in ("psum", "exchange"):
            for rank in range(KV):
                np.testing.assert_array_equal(got[rank][i].reshape(w.shape), w)
        else:
            np.testing.assert_array_equal(
                np.concatenate([got[rank][i] for rank in range(KV)]).reshape(w.shape), w)


ENGINE_CASES = ["mixed-fp32", "mixed-bf16", "mixed-fp4-gated", "split-evict-fp4", "prefix-cow",
                "corrupt-fp4"]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_sharded_tokens_identical_to_replicated_and_reference(served, case):
    ranks = [r["cases"][case] for r in served["ranks"]]
    rep, ref = served["replicated"][case], served["reference"][case]
    for i, ref_run in enumerate(ref):
        rep_run = rep["runs"][i]
        assert rep_run["outputs"] == ref_run["outputs"]
        for rank in ranks:
            run = rank["runs"][i]
            assert run["outputs"] == rep_run["outputs"]
            assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
            assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref_run["summary"]
            assert run["gate"] == rep_run["gate"]
            assert run["events"] == ref_run["events"]
            # every block back on its owner's free list (or parked in the index)
            assert run["n_free"] + run["n_cached"] == rank["n_blocks"] - 1
            assert run["n_allocated"] == run["n_held"] == 0 and run["owners_ok"]
    if case == "split-evict-fp4":
        assert ranks[0]["runs"][0]["summary"]["n_preemptions"] >= 1
    if case == "prefix-cow":
        warm = ranks[0]["runs"][1]["summary"]
        assert warm["n_dispatches"] > warm["n_steps"]          # COW forks ran
        assert ranks[0]["runs"][1]["hit_blocks"] > 0
    if case == "corrupt-fp4":
        assert [e[:2] for e in ranks[0]["runs"][0]["events"]] == [("WireCorruption", "hard")]
    if case == "mixed-fp4-gated":
        gate = ranks[0]["runs"][0]["gate"]
        assert gate["compressed"] > 0 and gate["dense"] > 0


def test_each_rank_holds_half_of_every_pool(served):
    for name in served["cases"]:
        rep = served["replicated"][name]
        for r in served["ranks"]:
            c = r["cases"][name]
            assert c["kv_shards"] == KV and c["n_blocks"] % KV == 0
            assert c["slab_rows"] == [c["n_blocks"] // KV]
            assert c["slab_bytes"] == c["pool_bytes_per_device"] == c["pool_bytes"] // KV
        assert rep["slab_bytes"] == rep["pool_bytes"]
    # capacity rounds up to a multiple of the kv shards (7 -> 8)
    assert served["replicated"]["prefix-cow"]["n_blocks"] == 7
    assert served["ranks"][0]["cases"]["prefix-cow"]["n_blocks"] == 8


def _paged_reads(summary, step_tokens, split):
    """Paged reads of a run: one per mixed step, or one per split chunk and
    one per split decode; the rest of the dispatches are COW forks."""
    if not split:
        return summary["n_steps"], summary["n_dispatches"] - summary["n_steps"]
    n = sum(1 for p, _ in step_tokens if p) + sum(1 for _, d in step_tokens if d)
    return n, summary["n_dispatches"] - n


def test_exchange_is_layers_times_planes_per_read(served, models):
    """Each paged read exchanges every layer's planes once (K, V; payload
    and scales of each on wire pools), each COW fork too."""
    L = models[0].n_layers
    for name, case in served["cases"].items():
        split = case["engine"].get("token_budget") == 0
        for r in served["ranks"]:
            c = r["cases"][name]
            planes = 4 if KVCacheSpec.parse(case["engine"].get("cache_spec")).quantized else 2
            assert c["planes_per_layer"] == planes
            for run in c["runs"]:
                reads, forks = _paged_reads(run["summary"], run["step_tokens"], split)
                assert run["exchange"] == L * planes * (reads + forks), (name, run["exchange"])
    assert served["ranks"][0]["cases"]["prefix-cow"]["runs"][1]["exchange"] > 0


def test_sharded_long_context_capacity(served):
    """At a fixed per-rank pool budget (9 blocks of 16) the 2-rank engine
    serves a prompt at least 1.9x longer than the replicated engine admits,
    with the tokens of a replicated engine large enough to hold it; the
    replicated engine at that budget refuses it."""
    long_s = len(served["cases"]["capacity"]["traffic"][0][0])
    long_r = (9 - 1) * 16 - 4 + 1
    assert long_s / long_r >= 1.9
    refused = served["replicated"]["capacity-refused"]
    assert "exhausted" in refused["runs"][0]
    rep = served["replicated"]["capacity"]["runs"][0]
    for r in served["ranks"]:
        c = r["cases"]["capacity"]
        assert c["pool_bytes_per_device"] == refused["pool_bytes_per_device"]
        assert c["runs"][0]["outputs"] == rep["outputs"] and len(rep["outputs"][0]) == 4
        assert c["runs"][0]["max_resident_ctx"] >= long_s


@pytest.mark.parametrize("key", sorted(STACKS))
def test_whole_prompt_stack_on_kv_ranks(served, key):
    """A whole-prompt stack on 2 kv ranks: tokens, outcomes and counts equal
    on both ranks and to the reference's single-device Engine; each rank
    holds half of the attention pools (none for xlstm), the whole
    recurrent state and the whole cross K/V; the exchange runs once per
    pool plane of each attention layer per decode step (the whole-prompt
    insert writes its owned blocks without one)."""
    cfg = served["stacks"][key]["cfg"]
    ref = served["stack_reference"][key][0]
    L = sum(sp.kind == "attn" for sp in cfg.layers)
    for r in served["ranks"]:
        c = r["stacks"][key]["whole-fp4"]
        run = c["runs"][0]
        assert run["outputs"] == ref["outputs"]
        assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
        assert run["n_free"] + run["n_cached"] == c["n_blocks"] - 1 and run["owners_ok"]
        assert c["kv_shards"] == KV and c["n_blocks"] % KV == 0
        if L:
            assert c["slab_rows"] == [c["n_blocks"] // KV]
            assert c["planes_per_layer"] == 4
        assert c["slab_bytes"] * KV == paged_cache_bytes(cfg, c["n_blocks"], 16,
                                                         cache_spec="fp4_e2m1")
        assert c["rec_bytes"] == recurrent_state_bytes(cfg, 2)
        assert c["cross_bytes"] == cross_state_bytes(cfg, 2, 4)
        assert c["pool_bytes_per_device"] == c["slab_bytes"] + c["cross_bytes"]
        n_dec = sum(1 for _, d in run["step_tokens"] if d)
        assert run["exchange"] == L * 4 * n_dec, (key, run["exchange"])
    if key == "xlstm":
        assert served["ranks"][0]["stacks"][key]["whole-fp4"]["slab_bytes"] == 0
    else:
        assert served["ranks"][0]["stacks"][key]["whole-fp4"]["runs"][0]["exchange"] > 0


def test_serve_cli_shard_pools_on_cpu(capfd):
    """``launch/serve.py --shard-pools 2`` on the CPU: two kv ranks over
    gloo, rank 0's banner names the shards and the MB per rank, every rank
    samples the replicated run's tokens."""
    argv = ["--reduced", "--device", "cpu", "--slots", "2", "--requests", "3", "--prompt-len",
            "40", "--new-tokens", "3", "--cache-spec", "fp4_e2m1", "--simulate-tp", "2"]
    _, out = serve.main(argv)
    replicated = [r.output.tolist() for r in out]
    capfd.readouterr()
    engine, ranks = serve.main(argv + ["--shard-pools", "2"])
    text = capfd.readouterr().out
    assert engine is None and ranks == [replicated, replicated]
    assert "kv_shards=2" in text and "MB per rank" in text and "3 requests, 9 tokens" in text
    assert "kv ranks: all 2 sampled identical tokens" in text
    with pytest.raises(ValueError, match="lockstep"):
        serve.main(argv + ["--shard-pools", "2", "--stagger", "0.01"])
