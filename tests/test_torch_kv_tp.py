"""Sequence-sharded pools on TP rows and on the ``data x model`` grid: the
port's ``kv x data x model`` mesh (the reference's ``make_kv_mesh``) against
the port's own replicated rows and the reference, on the CPU, fp32.

* One spawn of ``kv 2 x model 2`` gloo ranks (``spawn_ranks(..., tp=2,
  kv=2)``: rank ``k * 2 + m``), reduced internlm2 (4 query over 4 kv heads,
  hd 32: 2 kv heads a rank). Each rank serves every case first with
  replicated pools (``kv_group=None``: its row is a TP group of its own) and
  then with the pools sharded over its kv group: tokens, steps, dispatches,
  preemptions and skipped prompt tokens equal on the four ranks, to their
  row's replicated run and to the reference's single-device ``Engine``
  under ``simulate_tp=2`` (PAPER_DEFAULT, or NO_COMPRESSION) on the same
  weights, over fp32, bf16 and fp4 pools, on the mixed and split
  schedulers, through eviction, a prefix-cache COW fork and a supervised
  ``corrupt@3``. Two mixed steps (the second reads the first's blocks,
  which lie on both kv ranks) give bit for bit the replicated row's logits,
  and the exchanged virtual pool is the replicated rank's pool rows, byte
  for byte, every plane at the rank's width (fp4: payload ``kv_dim / 2 /
  2``, scales ``kv_dim / 2 / 32``). A rank holds exactly ``1 / (2 * 2)`` of
  the single-rank engine's pool bytes, measured on its tensors; the
  reference's ``paged_cache_bytes(per_device=True)`` reads twice that
  (ROADMAP.md Queue 3). At equal per-rank pool bytes the sharded row serves
  a prompt at least 1.9x longer than the replicated row admits, with the
  tokens of a replicated row that holds it. Reduced jamba (Mamba, Mamba +
  MoE, attention) whole-prompt on fp4 pools gives its replicated row's
  tokens, its recurrent state split over the row and whole over the kv
  group. The weights a rank holds are its TP shard, the same on both kv
  ranks.
* One spawn of ``kv 2 x data 2 x model 2`` ranks (the reference test's
  mesh): reduced internlm2 gives the reference Engine's tokens; reduced
  mixtral (4 experts, 2 a data rank) on the split scheduler over 66 slots,
  whose every decode step enters the MoE island, gives its ``data x model``
  grid's tokens and island counts (the same ranks with replicated pools),
  dense and with compressed all-to-alls.
* ``launch/serve.py --shard-pools 2 --tp 2 --dp 2`` on the CPU.

The reference's own tests of this mesh do not run on this JAX (ROADMAP.md
Queue 3 item 4). The references are computed in this process while the
ranks run. TF32 is off for torch matmuls.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as reference_engine
from repro.serving.kv_cache import paged_cache_bytes as jpaged_cache_bytes
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.formats import KVCacheSpec
from repro_torch.core.tp import TPContext
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.model import Model
from repro_torch.serving import Engine
from repro_torch.serving.kv_cache import recurrent_state_bytes
from tests.conftest import fp32_reduced
from tests.test_torch_data_parallel import ENGINE as ISLAND_ENGINE
from tests.test_torch_data_parallel import ENGINE_CFG, configs, reference_tree
from tests.test_torch_serving import SUMMARY_KEYS, _CopyingJnp, parity_traffic
from tests.test_torch_sharded_pools import _reference
from tests.test_torch_tp import _jamba_models
from tests.torch_tp_worker import run_kvtp_rank

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KV, TP = 2, 2
BOTH = ("replicated", "sharded")
ENGINE = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=16, token_budget=18)
SPLIT = dict(ENGINE, token_budget=0)
CAP_BLOCKS = 9                               # the capacity cases' per-rank budget (blocks)
ENGINE_CASES = ["mixed-fp32", "mixed-fp4", "split-fp32", "split-fp4", "mixed-bf16-dense",
                "split-evict-fp4", "prefix-cow", "corrupt-fp4"]


def _case(engine, traffic, gated, modes=BOTH, **kw):
    return dict(engine=engine, traffic=traffic, gated=gated,
                policy="compressed" if gated else "dense", modes=modes, **kw)


def _cases(vocab):
    """The kv x model grid's engine cases (``gated``: PAPER_DEFAULT on the
    row, the reference under ``simulate_tp=2``)."""
    parity = parity_traffic(vocab)
    evict = [(np.arange(20, dtype=np.int32) * 3 % vocab, 30) for _ in range(2)]
    shared = [((np.arange(32, dtype=np.int32) * 7 + 3) % vocab, 6) for _ in range(2)]
    fault = [((np.arange(16, dtype=np.int32) + 3 * i) % vocab, 8) for i in range(2)]
    long_s = (2 * CAP_BLOCKS - 1) * 16 - 4 + 1   # what 17 usable blocks of 16 hold
    longp = [((np.arange(long_s, dtype=np.int32) * 5) % vocab, 4)]
    cap = dict(max_slots=1, max_len=288, block_size=16, n_blocks=2 * CAP_BLOCKS,
               cache_spec="fp4_e2m1")
    return {
        "mixed-fp32": _case(dict(ENGINE), parity, True),
        "mixed-fp4": _case(dict(ENGINE, cache_spec="fp4_e2m1"), parity, True),
        "split-fp32": _case(dict(SPLIT), parity, True),
        "split-fp4": _case(dict(SPLIT, cache_spec="fp4_e2m1"), parity, True),
        "mixed-bf16-dense": _case(dict(ENGINE, cache_dtype="bfloat16"), parity, False),
        # 5 usable blocks for two requests of 4 blocks each: the split
        # scheduler preempts
        "split-evict-fp4": _case(dict(max_slots=2, max_len=64, block_size=16, n_blocks=6,
                                      prefill_chunk=8, token_budget=0, cache_spec="fp4_e2m1"),
                                 evict, False),
        # exact pools: the warm run's full-prompt hits fork their tail block
        "prefix-cow": _case(dict(max_slots=2, max_len=48, prefix_cache=True,
                                 persistent_cache=True), shared, False, runs=2),
        "corrupt-fp4": _case(dict(max_slots=2, max_len=64, cache_spec="fp4_e2m1"), fault, True,
                             plan="corrupt@3"),
        # 2 x 9 blocks on 2 kv ranks; a replicated row of 18 blocks holds the
        # prompt too, one of 9 (the per-rank budget) refuses it
        "capacity": _case(cap, longp, True),
        "capacity-refused": _case(dict(cap, n_blocks=CAP_BLOCKS), longp, True,
                                  modes=("replicated",)),
    }


def _probes(vocab):
    """Two mixed steps of 32 tokens over 8 blocks (4 a kv rank), table row
    [1, 5, 2, 6]: both kv ranks own blocks of it."""
    tokens = ((np.arange(64, dtype=np.int32) * 13 + 5) % vocab).astype(np.int32)
    return {spec: dict(tokens=tokens, table=[1, 5, 2, 6], n_blocks=8, cache_spec=spec,
                       policy="compressed") for spec in ("float32", "fp4_e2m1")}


@pytest.fixture(scope="module")
def models():
    """Reduced internlm2 in fp32: (port cfg, reference model, reference
    params, numpy tree)."""
    cfg_t = dataclasses.replace(reduced_config(get_config("internlm2-1.8b")), dtype="float32")
    return (cfg_t, *reference_tree(fp32_reduced("internlm2-1.8b")))


def _references(models, cases):
    """The reference Engine on every case it serves (not the capacity
    cases: the port's replicated rows are their anchor)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reference_engine, "jnp", _CopyingJnp())
        return {name: _reference(models[:3] + (None, None), case)
                for name, case in cases.items() if not name.startswith("capacity")}


@pytest.fixture(scope="module")
def kvtp(models):
    """The kv 2 x model 2 grid's results (one spawn), the reference Engine's
    runs (computed while the ranks run) and the job."""
    cfg, _, _, tree = models
    cases = _cases(cfg.vocab_size)
    probes = _probes(cfg.vocab_size)
    jamba_cfg, _, jamba_params_j = _jamba_models()[:3]
    traffic = [(((np.arange(n, dtype=np.int32) * 11 + i) % cfg.vocab_size).astype(np.int32),
                4 + i) for i, n in enumerate((12, 20, 12))]
    job = {"models": {
        "internlm2": dict(cfg=cfg, params=tree, cases=cases, probes=probes),
        "jamba": dict(cfg=jamba_cfg, params=jax.tree.map(np.asarray, jamba_params_j),
                      cases={"whole-fp4": _case(dict(max_slots=2, max_len=64, block_size=16,
                                                     cache_spec="fp4_e2m1"), traffic, True)})}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, run_kvtp_rank, KV * TP, job, device="cpu", threads=1,
                            timeout_s=600, tp=TP, kv=KV)
        reference = _references(models, cases)
        ranks = ranks.result()
    return dict(job=job, ranks=ranks, reference=reference)


@pytest.fixture(scope="module")
def kvdm(models, kvtp):
    """The kv 2 x data 2 x model 2 grid's results (one spawn): reduced
    internlm2 sharded, reduced mixtral replicated and sharded."""
    cfg, _, _, tree = models
    mix_j, mix_t = configs("mixtral-8x22b", **ENGINE_CFG)
    mix_tree = reference_tree(mix_j)[2]
    traffic = [(((np.arange(n, dtype=np.int32) * 11 + i) % mix_t.vocab_size).astype(np.int32),
                4 + i) for i, n in enumerate((20, 12, 30))]
    job = {"models": {
        "internlm2": dict(cfg=cfg, params=tree,
                          cases={"mixed-fp4": dict(kvtp["job"]["models"]["internlm2"]["cases"]
                                                   ["mixed-fp4"], modes=("sharded",))}),
        "mixtral": dict(cfg=mix_t, params=mix_tree, cases={
            "split-dense": dict(engine=dict(ISLAND_ENGINE), traffic=traffic, policy="dense",
                                modes=BOTH),
            "split-compressed-a2a": dict(engine=dict(ISLAND_ENGINE, compress_decode=True),
                                         traffic=traffic, policy="compressed-a2a",
                                         modes=BOTH)})}}
    ranks = spawn_ranks(run_kvtp_rank, KV * 2 * TP, job, device="cpu", threads=1,
                        timeout_s=600, tp=TP, kv=KV)
    return dict(job=job, ranks=ranks)


def _place(r, dp):
    """(kv, data, model) rank of grid rank r on a kv x dp x TP grid."""
    k, p = divmod(r, dp * TP)
    return (k, *divmod(p, TP))


@pytest.mark.parametrize("grid", ["kvtp", "kvdm"])
def test_grid_places_ranks_on_kv_data_model(request, grid):
    """Rank r = k * D * M + d * M + m sits at kv rank k, data rank d, model
    rank m, in the reference's axis order ("kv", "data", "model")."""
    res = request.getfixturevalue(grid)
    dp = 1 if grid == "kvtp" else 2
    assert [r["grid"] for r in res["ranks"]] == [(*_place(i, dp), KV, dp, TP)
                                                 for i in range(KV * dp * TP)]


def _runs(res, key, mode, case, i=0):
    return [r[key][mode][case]["runs"][i] for r in res["ranks"]]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_kv_tp_tokens_equal_replicated_rows_and_reference(kvtp, case):
    """Every rank's tokens, counts, gate counts and recoveries equal its
    row's replicated run's and the reference Engine's (``simulate_tp=2``);
    every block back on its owner's free list."""
    ref = kvtp["reference"][case]
    for i, ref_run in enumerate(ref):
        for r in kvtp["ranks"]:
            rep = r["internlm2"]["replicated"][case]["runs"][i]
            assert rep["outputs"] == ref_run["outputs"]
            sh = r["internlm2"]["sharded"][case]
            run = sh["runs"][i]
            assert run["outputs"] == rep["outputs"]
            assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
            assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref_run["summary"]
            assert run["gate"] == rep["gate"] and run["events"] == ref_run["events"]
            assert run["n_free"] + run["n_cached"] == sh["n_blocks"] - 1
            assert run["n_allocated"] == run["n_held"] == 0 and run["owners_ok"]
    rank0 = kvtp["ranks"][0]["internlm2"]["sharded"][case]
    assert rank0["kv_shards"] == KV
    if case == "split-evict-fp4":
        assert rank0["runs"][0]["summary"]["n_preemptions"] >= 1
    if case == "prefix-cow":
        warm = rank0["runs"][1]
        assert warm["summary"]["n_dispatches"] > warm["summary"]["n_steps"] and warm["hit_blocks"]
    if case == "corrupt-fp4":
        assert [e[:2] for e in rank0["runs"][0]["events"]] == [("WireCorruption", "hard")]
    if case in ("mixed-fp32", "mixed-fp4"):
        gate = rank0["runs"][0]["gate"]
        assert gate["compressed"] > 0 and gate["dense"] > 0


@pytest.mark.parametrize("spec", ["float32", "fp4_e2m1"])
def test_exchange_and_first_logits_bit_exact(kvtp, models, spec):
    """Two mixed steps on each rank: the logits of both (the second reads
    blocks of both kv ranks) are its row's replicated logits bit for bit,
    and the exchanged virtual pool is the replicated rank's pool rows, byte
    for byte; every plane at the rank's width and a slab of half the
    blocks."""
    cfg = models[0]
    local = cfg.kv_dim // TP
    widths = [local] * 2 if spec == "float32" else [local // 2, local // 32] * 2
    for r in kvtp["ranks"]:
        rep = r["internlm2"]["replicated"][f"probe/{spec}"]
        sh = r["internlm2"]["sharded"][f"probe/{spec}"]
        assert len(sh["logits"]) == 2
        for a, b in zip(sh["logits"], rep["logits"]):
            np.testing.assert_array_equal(a, b)
        assert len(sh["virtual"]) == 2 * cfg.n_layers * (1 if spec == "float32" else 2)
        for a, b in zip(sh["virtual"], rep["virtual"]):
            np.testing.assert_array_equal(a, b)
        assert sh["widths"] == widths * cfg.n_layers and rep["widths"] == sh["widths"]
        assert (sh["slab_rows"], rep["slab_rows"]) == (4, 8)
    # the logits differ between the TP ranks' rows by nothing: one row's bits
    first = [r["internlm2"]["sharded"][f"probe/{spec}"]["logits"][1] for r in kvtp["ranks"]]
    for f in first[1:]:
        np.testing.assert_array_equal(f, first[0])


def _single_slab_bytes(cfg, tree, case, n_blocks):
    """Pool bytes the port's single-rank engine holds for ``case`` at
    ``n_blocks``, measured on its tensors."""
    kw = dict(case["engine"], n_blocks=n_blocks)
    kw["cache_dtype"] = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        kw.get("cache_dtype", "float32")]
    eng = Engine(Model(cfg), params_from_numpy(tree, cfg, "cpu"), TPContext(), device="cpu",
                 **kw)
    return eng.pool_bytes_held()


def test_pool_bytes_per_rank_are_one_over_kv_times_tp(kvtp, models):
    """Each rank holds exactly 1/(K*M) of the single-rank engine's pool
    bytes (measured tensors, the same block count), its replicated row rank
    1/M; ``kv_pool_bytes(per_device=True)`` says so, while the reference's
    ``paged_cache_bytes(per_device=True)`` on the whole config reads M
    times the bytes a rank holds (it divides by the kv shards only)."""
    cfg, _, _, tree = models
    jcfg = fp32_reduced("internlm2-1.8b")
    for name, case in kvtp["job"]["models"]["internlm2"]["cases"].items():
        if "sharded" not in case["modes"]:
            continue
        for r in kvtp["ranks"]:
            sh = r["internlm2"]["sharded"][name]
            rep = r["internlm2"]["replicated"][name]
            one = _single_slab_bytes(cfg, tree, case, sh["n_blocks"])
            assert sh["slab_bytes"] * KV * TP == one, name
            assert sh["slab_bytes"] == sh["pool_bytes_per_device"]
            assert sh["slab_rows"] == [sh["n_blocks"] // KV]
            assert rep["slab_bytes"] * TP == _single_slab_bytes(cfg, tree, case,
                                                                rep["n_blocks"])
            spec = case["engine"].get("cache_spec")
            dtb = 2 if case["engine"].get("cache_dtype") == "bfloat16" else 4
            ref = jpaged_cache_bytes(jcfg, sh["n_blocks"], 16, dtype_bytes=dtb, cache_spec=spec,
                                     kv_shards=KV, per_device=True)
            assert ref == TP * sh["slab_bytes"], name


def _paged_reads(run, split):
    s, steps = run["summary"], run["step_tokens"]
    if not split:
        return s["n_steps"], s["n_dispatches"] - s["n_steps"]
    n = sum(1 for p, _ in steps if p) + sum(1 for _, d in steps if d)
    return n, s["n_dispatches"] - n


def test_exchange_per_read_and_row_collectives_unchanged(kvtp, models):
    """Sharded: each paged read and COW fork exchanges every layer's planes
    over the kv group once (K, V; payload and scales of wire pools); the
    row's collectives are the replicated row's, call for call and byte for
    byte."""
    L = models[0].n_layers
    for name, case in kvtp["job"]["models"]["internlm2"]["cases"].items():
        if "sharded" not in case["modes"]:
            continue
        split = case["engine"].get("token_budget") == 0
        planes = 4 if KVCacheSpec.parse(case["engine"].get("cache_spec")).quantized else 2
        for r in kvtp["ranks"]:
            sh, rep = r["internlm2"]["sharded"][name], r["internlm2"]["replicated"][name]
            assert sh["planes_per_layer"] == planes
            for run, rrun in zip(sh["runs"], rep["runs"]):
                reads, forks = _paged_reads(run, split)
                assert run["exchange"] == L * planes * (reads + forks), (name, run["exchange"])
                assert rrun["exchange"] == 0
                drop = lambda c: {k: v for k, v in c.items() if k != "seconds"}
                assert drop(run["tp"]) == drop(rrun["tp"]), name


def test_kv_tp_long_context_capacity(kvtp):
    """At the per-rank budget of 9 blocks the sharded row serves a prompt at
    least 1.9x longer than a replicated row admits (which refuses it), with
    the tokens of a replicated row of 18 blocks, at equal per-rank pool
    bytes."""
    long_s = len(kvtp["job"]["models"]["internlm2"]["cases"]["capacity"]["traffic"][0][0])
    long_r = (CAP_BLOCKS - 1) * 16 - 4 + 1
    assert long_s / long_r >= 1.9
    for r in kvtp["ranks"]:
        m = r["internlm2"]
        refused = m["replicated"]["capacity-refused"]
        assert "exhausted" in refused["runs"][0]
        sh = m["sharded"]["capacity"]
        rep = m["replicated"]["capacity"]["runs"][0]
        assert sh["slab_bytes"] == refused["slab_bytes"]
        assert sh["runs"][0]["outputs"] == rep["outputs"] and len(rep["outputs"][0]) == 4
        assert sh["runs"][0]["max_resident_ctx"] >= long_s


def test_jamba_whole_prompt_on_kv_tp_grid(kvtp):
    """Reduced jamba whole-prompt on fp4 pools: tokens and counts equal on
    the four ranks and to each row's replicated run; half the blocks of the
    rank's pools, its share of the recurrent state over the row and all of
    it over the kv group; the exchange once per plane per decode step."""
    cfg = kvtp["job"]["models"]["jamba"]["cfg"]
    L = sum(sp.kind == "attn" for sp in cfg.layers)
    for r in kvtp["ranks"]:
        sh, rep = r["jamba"]["sharded"]["whole-fp4"], r["jamba"]["replicated"]["whole-fp4"]
        run, rrun = sh["runs"][0], rep["runs"][0]
        assert run["outputs"] == rrun["outputs"] == kvtp["ranks"][0]["jamba"]["replicated"][
            "whole-fp4"]["runs"][0]["outputs"]
        assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == {
            k: rrun["summary"][k] for k in SUMMARY_KEYS}
        assert sh["rec_bytes"] == rep["rec_bytes"] == recurrent_state_bytes(cfg.tp_shard(TP), 2)
        assert sh["slab_rows"] == [sh["n_blocks"] // KV] and rep["slab_bytes"] > 0
        assert sh["slab_bytes"] * KV * rep["n_blocks"] == rep["slab_bytes"] * sh["n_blocks"]
        n_dec = sum(1 for _, d in run["step_tokens"] if d)
        assert run["exchange"] == L * 4 * n_dec > 0


def _shard_bytes(tree, cfg, m, dp_rank=0, dp=1):
    shard = shard_params(tree, cfg, m, TP, dp_rank=dp_rank, dp=dp)
    return sum(t.numel() * t.element_size()
               for t in jax.tree.leaves(params_from_numpy(shard, cfg.tp_shard(TP, dp), "cpu")))


def test_rank_holds_its_tp_shard_of_the_weights(kvtp, kvdm, models):
    """A rank holds exactly its (data, model) position's shard of the
    weights, the same bytes on every kv rank: no rank holds the whole
    tree."""
    cfg, _, _, tree = models
    for r in kvtp["ranks"]:
        k, d, m = r["grid"][:3]
        assert r["internlm2"]["weight_bytes"] == _shard_bytes(tree, cfg, m)
    mix = kvdm["job"]["models"]["mixtral"]
    for r in kvdm["ranks"]:
        k, d, m = r["grid"][:3]
        assert r["mixtral"]["weight_bytes"] == _shard_bytes(mix["params"], mix["cfg"], m, d, 2)


def test_overlapping_groups_refused(kvtp):
    for r in kvtp["ranks"]:
        msg = r["overlap"]
        assert msg and "tp_group and kv_group overlap in ranks" in msg


def test_dense_model_on_kv_data_model_grid(kvdm, kvtp):
    """kv 2 x data 2 x model 2: reduced internlm2's tokens and counts on
    every rank equal the reference Engine's (``simulate_tp=2``)."""
    ref = kvtp["reference"]["mixed-fp4"][0]
    for r in kvdm["ranks"]:
        run = r["internlm2"]["sharded"]["mixed-fp4"]["runs"][0]
        assert run["outputs"] == ref["outputs"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
        assert run["exchange"] > 0 and run["tp"]["island"] == 0


@pytest.mark.parametrize("case", ["split-dense", "split-compressed-a2a"])
def test_mixtral_island_on_kv_data_model_grid(kvdm, case):
    """kv 2 x data 2 x model 2: reduced mixtral's split decode over 66 slots
    enters the island in every MoE layer of every decode step; every rank's
    tokens and island counts (entries, all-to-alls, data all-gathers, the
    bytes of each) equal its data x model grid's with replicated pools."""
    cfg = kvdm["job"]["models"]["mixtral"]["cfg"]
    L = sum(s.moe for s in cfg.layers)
    want = kvdm["ranks"][0]["mixtral"]["replicated"][case]["runs"][0]["outputs"]
    keys = ("island", "island_down_bytes", "compressed_all_to_all",
            "compressed_all_to_all_bytes", "dense_all_to_all", "dense_all_to_all_bytes",
            "dp_all_gather", "dp_all_gather_bytes", "all_gather", "all_reduce")
    for r in kvdm["ranks"]:
        sh = r["mixtral"]["sharded"][case]["runs"][0]
        rep = r["mixtral"]["replicated"][case]["runs"][0]
        assert sh["outputs"] == rep["outputs"] == want
        assert all(o == "ok" for o in sh["outcomes"]) and sh["finite"]
        assert {k: sh["tp"][k] for k in keys} == {k: rep["tp"][k] for k in keys}
        n_dec = sum(1 for _, d in sh["step_tokens"] if d)
        assert sh["tp"]["island"] == L * n_dec > 0 and sh["exchange"] > 0
        assert (sh["tp"]["compressed_all_to_all"] > 0) == (case == "split-compressed-a2a")


def test_serve_cli_kv_data_model_on_cpu(capfd):
    """``launch/serve.py --shard-pools 2 --tp 2 --dp 2`` on the CPU: 8 ranks,
    the banner names the three extents, the report the kv exchange, and
    every rank samples the tokens of ``--simulate-tp 2``."""
    argv = ["--reduced", "--device", "cpu", "--slots", "2", "--requests", "2", "--prompt-len",
            "24", "--new-tokens", "3", "--cache-spec", "fp4_e2m1"]
    _, out = serve.main(argv + ["--simulate-tp", "2"])
    simulated = [r.output.tolist() for r in out]
    capfd.readouterr()
    engine, ranks = serve.main(argv + ["--shard-pools", "2", "--tp", "2", "--dp", "2"])
    text = capfd.readouterr().out
    assert engine is None and ranks == [simulated] * 8
    assert "tp=2 dp=2 kv=2 transport=gloo-staged" in text
    assert "MB held; the reference's paged_cache_bytes(per_device=True)" in text
    assert "kv exchange (gloo-staged):" in text and "grid ranks: all 8 sampled identical" in text
