"""Tensor parallelism of the port across ``torch.distributed`` ranks against
the port's simulated path and the reference.

* The rank collective (``collectives.rank_compressed_psum``) on 2 and 4
  gloo ranks, each reducing its own slice of the same numpy partials (fp32
  at a spread of scales, and bf16): bit-identical to the port's simulated
  ``compressed_psum`` on the stacked partials (plus the ``two_phase``
  re-quantize) for the gather variant at ``overlap_chunks`` 1, 2 and 4,
  ``two_phase`` and a bf16 accumulator; the gathered wire bytes are the
  stacked partials' quantize; every rank's output identical, except under
  ``keep_local_fp``, which equals ``total - dequant(quant(own)) + own`` in
  fp32; the downgrade of an indivisible ``two_phase`` warns once or raises
  under ``strict``, as the reference's; the counters count each collective
  and its bytes; ``compressed_all_gather``, the dense all-reduce and the
  dense all-gather (``rank_all_gather``, counted apart).
* The same collectives against the reference's ``compressed_psum`` under
  ``shard_map`` on 4 host CPU devices (a subprocess, as
  ``tests/test_collectives.py`` runs them), within rel-L2 1e-4: the
  reference's exp2 of a scale can be inexact (ROADMAP Queue 3 item 2).
* Sharded ``Model.init_params(tp=...)`` and ``convert.shard_params``
  concatenate to the single-rank tree.
* Reduced llama2 in fp32 on 2 TP ranks: one mixed step's logits against
  the single-rank port (dense; compressed against ``simulate_tp=2``)
  within rel-L2 1e-5; greedy tokens, steps, dispatches, gate counts,
  preemptions and recovery events equal on both ranks, to the port's
  single-rank engine (``simulate_tp=2`` under the policy) and to the
  reference's single-device ``Engine(simulate_tp=2)``, on the mixed and
  split schedulers over dense fp32 and fp4 pools, bf16 pools
  uncompressed, and a supervised ``corrupt@3`` run; each rank holds half
  the pool bytes, and its collectives are exactly two all-gathers per
  compressed reduction and one all-reduce per dense one.
* Reduced mixtral (MoE, 4 experts top-2, 6 query heads over 2 kv heads at
  hd 32) in fp32 on the same 2 ranks: each rank holds half of every
  expert's ``d_ff``; one mixed step's logits (80 tokens: the sort-based
  dispatch) within rel-L2 1e-5 of the single-rank port's; the mixed
  scheduler over an 80-token budget on fp4 pools, gated: tokens equal on
  both ranks, to the single-rank engine's and to the reference Engine's,
  and one dense all-reduce per MoE layer per step for the routed experts
  beside the ``wo`` reduction.
* Reduced jamba (Mamba, Mamba + MoE, attention; 4 query heads over 4 kv
  heads) in fp32 on the same 2 ranks: each rank holds half of every Mamba
  layer's d_inner channels (and of its recurrent state), half of every
  expert's ``d_ff`` and two of the kv heads; a whole-prompt prefill's logits
  within rel-L2 1e-5 of the single-rank port's, dense and compressed; the
  whole-prompt engine on fp4 pools, gated, over prompts of two exact
  lengths: tokens equal on both ranks and to the single-rank engine's
  (``simulate_tp=2``), and per pass two all-gathers per compressed
  reduction (``wo``, each Mamba ``out_proj``, each dense ``down``), one
  all-reduce per dense one, one per Mamba layer for ``x_proj`` and one per
  MoE layer for the routed experts.
* Reduced pixtral (4 query heads over 2 kv heads, 8 patches) and reduced
  whisper (2 + 2 layers, 4 heads over 4 kv heads, 24 encoder frames) in
  fp32 on the same 2 ranks: ``init_params(tp=...)`` and ``shard_params``
  concatenate to the single-rank tree (``mm_proj`` by its output columns,
  ``enc_layers`` and each ``xattn[i].core`` as a decoder layer,
  ``enc_norm`` and the ``xattn`` norms whole); a whole-prompt prefill's
  logits within rel-L2 1e-5 of the single-rank port's, dense and
  compressed; the whole-prompt engine on fp4 pools, gated, with the same
  extra inputs on every rank: tokens, steps and dispatches equal on both
  ranks, to the single-rank engine (``simulate_tp=2``) and to the
  reference's ``Engine(simulate_tp=2)``; per prefill two all-gathers per
  compressed reduction (whisper's encoder ``wo`` and ``down``, each
  cross-attention's ``wo``, the decoder's ``wo`` and ``down``) and
  pixtral's one dense all-gather of its prefix, per decode step one
  all-reduce per reduction; each rank holds half the pools and half the
  cross K/V, at the rank's ``kv_dim``.
* Reduced xlstm at d_model 384 (``[mlstm, slstm]``: mLSTM d_inner 768 in 4
  heads, sLSTM FF 512; at the default 256 the FF of 341 splits over no
  group) in fp32 on the same 2 ranks: each rank holds half of the mLSTM
  channels and heads (``up``, ``z``, conv, ``norm``; the rows of ``wq``,
  ``wk``, ``wv``, ``wi``, ``wf.w`` and ``down``) and of the sLSTM FF, and
  every other sLSTM leaf whole; ``init_params(tp=...)`` and
  ``shard_params`` concatenate to the tree; a whole-prompt prefill's logits
  within rel-L2 1e-5 of the single-rank port's, dense and compressed; the
  whole-prompt engine on fp4 pools (none: no attention layer), gated, over
  prompts of two exact lengths: tokens, steps and dispatches equal on both
  ranks, to the single-rank engine (``simulate_tp=2``) and to the
  reference's ``Engine(simulate_tp=2, donate_cache=False)``; per pass two
  all-gathers per compressed reduction (each mLSTM ``down``, each sLSTM
  ``ff_down``) and one all-reduce per dense one, plus one all-reduce per
  mLSTM layer for its q/k/v/i/f partial.
* Refusals: ``keep_local_fp`` in the engine on the rank path (ROADMAP
  Queue 3 item 11), a TP group with ``simulate_tp`` or with a kv group
  that overlaps it, heads or MLP columns that do not divide; the backend
  rule; ``launch/serve.py --tp 2`` on the CPU, and with ``--shard-pools 2``
  (a kv x model grid of 4 ranks).

One spawn of 4 ranks (collectives only) and one of 2 ranks (everything)
per module; the ranks import torch and the port only
(``tests/torch_tp_worker.py``). TF32 is off for torch matmuls.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as reference_engine
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.collectives import compressed_psum
from repro_torch.core.mx import MXCompressed
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.kernels import ops
from repro_torch.launch import mesh, serve
from repro_torch.models.convert import shard_params
from repro_torch.models.model import Model, layer_block, param_shapes, shard_axis
from tests.conftest import fp32_reduced
from tests.test_torch_families import family_traffic
from tests.test_torch_frontends import WHOLE, stub_arrays, whole_traffic
from tests.test_torch_serving import SUMMARY_KEYS, _CopyingJnp, parity_traffic
from tests.test_torch_sharded_pools import _reference
from tests.torch_tp_worker import run_rank, run_tp_cases

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPEC = PAPER_DEFAULT.spec
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _probe(n):
    """Partials of n ranks: fp32 (n, 24, 256) at row scales 10^[-2, 2), and
    bf16 (n, 2, 12, 256); a feature dim of 96 for the downgrade."""
    rng = np.random.default_rng(40 + n)
    f32 = rng.normal(size=(n, 24, 256)) * 10.0 ** rng.uniform(-2, 2, (n, 24, 1))
    bf = rng.normal(size=(n, 2, 12, 256))
    return dict(partials={"f32": (f32.astype(np.float32), "float32"),
                          "bf16": (bf.astype(np.float32), "bfloat16")}, odd_width=96)


def _stacked(probe, name):
    arr, dtype = probe["partials"][name]
    return torch.from_numpy(arr).to(DT[dtype])


def _bits(t):
    return t.contiguous().view(torch.uint8).numpy()


@pytest.fixture(scope="module")
def models():
    cfg_j = fp32_reduced("llama2-7b")
    cfg_t = dataclasses.replace(reduced_config(get_config("llama2-7b")), dtype="float32")
    model_j = JModel(cfg_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    return cfg_t, model_j, params_j, None, None


ENGINE = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=16, token_budget=18)
SPLIT = dict(ENGINE, token_budget=0)


def _cases(vocab):
    parity = parity_traffic(vocab)
    fault = [((np.arange(16, dtype=np.int32) + 3 * i) % vocab, 8) for i in range(2)]
    return {
        "mixed-fp32": dict(engine=dict(ENGINE), traffic=parity, gated=True),
        "mixed-fp4": dict(engine=dict(ENGINE, cache_spec="fp4_e2m1"), traffic=parity,
                          gated=True),
        "split-fp32": dict(engine=dict(SPLIT), traffic=parity, gated=True),
        "split-fp4": dict(engine=dict(SPLIT, cache_spec="fp4_e2m1"), traffic=parity,
                          gated=True),
        "mixed-bf16-dense": dict(engine=dict(ENGINE, cache_dtype="bfloat16"), traffic=parity),
        "corrupt-fp4": dict(engine=dict(max_slots=2, max_len=64, cache_spec="fp4_e2m1"),
                            traffic=fault, plan="corrupt@3", gated=True),
    }


def _moe_models():
    """Reduced mixtral in fp32 with 6 query heads over 2 kv heads (the kv
    heads divide over 2 ranks): (cfg, reference model, reference params)."""
    over = dict(n_heads=6, n_kv_heads=2)
    cfg_j = dataclasses.replace(fp32_reduced("mixtral-8x22b"), **over)
    cfg_t = dataclasses.replace(reduced_config(get_config("mixtral-8x22b")), dtype="float32",
                                **over)
    model_j = JModel(cfg_j)
    return cfg_t, model_j, model_j.init_params(jax.random.PRNGKey(0)), None, None


def _moe_cases(vocab):
    """The MoE engine case: the mixed scheduler over an 80-token budget (the
    dispatch path) on fp4 pools, gated."""
    return {"moe-mixed-fp4": dict(engine=dict(ENGINE, token_budget=80, cache_spec="fp4_e2m1"),
                                  traffic=family_traffic(vocab), gated=True)}


def _jamba_models():
    """Reduced jamba in fp32, 3 layers: [mamba, mamba + MoE, attn]."""
    cfg_j = fp32_reduced("jamba-v0.1-52b", n_layers=3)
    cfg_t = dataclasses.replace(reduced_config(get_config("jamba-v0.1-52b"), n_layers=3),
                                dtype="float32")
    model_j = JModel(cfg_j)
    return cfg_t, model_j, model_j.init_params(jax.random.PRNGKey(0)), None, None


def _jamba_cases(vocab):
    """The whole-prompt engine (a recurrent stack's only scheduler) on fp4
    pools, gated, over prompts of 12 and 20 tokens."""
    traffic = [(((np.arange(n, dtype=np.int32) * 11 + i) % vocab).astype(np.int32), 4 + i)
               for i, n in enumerate((12, 20, 12))]
    return {"jamba-whole-fp4": dict(engine=dict(max_slots=2, max_len=64, block_size=16,
                                                cache_spec="fp4_e2m1"),
                                    traffic=traffic, gated=True)}


XLSTM_D = 384   # reduced xlstm's width on 2 ranks: mLSTM d_inner 768, sLSTM FF 512


def _xlstm_models():
    """Reduced xlstm in fp32 at d_model 384: [mlstm, slstm]."""
    cfg_j = fp32_reduced("xlstm-125m", d_model=XLSTM_D)
    cfg_t = dataclasses.replace(reduced_config(get_config("xlstm-125m"), d_model=XLSTM_D),
                                dtype="float32")
    model_j = JModel(cfg_j)
    return cfg_t, model_j, model_j.init_params(jax.random.PRNGKey(0)), None, None


def _xlstm_cases(vocab):
    """The whole-prompt engine on fp4 pools (an xLSTM stack makes none),
    gated, over prompts of 12 and 20 tokens; the reference Engine without
    donating its state (ROADMAP.md Queue 3 item 17)."""
    traffic = [(((np.arange(n, dtype=np.int32) * 7 + i) % vocab).astype(np.int32), 4 + i)
               for i, n in enumerate((12, 20, 12))]
    return {"xlstm-whole-fp4": dict(engine=dict(max_slots=2, max_len=64, block_size=16,
                                                cache_spec="fp4_e2m1"),
                                    ref_engine=dict(donate_cache=False),
                                    traffic=traffic, gated=True)}


# the vision-prefix and encoder-decoder models on 2 ranks: job key -> (arch,
# overrides of the reduced config: 2 kv heads so they divide, a few patches,
# 24 encoder frames)
FRONTENDS = {"pixtral": ("pixtral-12b", dict(n_kv_heads=2, n_patches=8)),
             "whisper": ("whisper-medium", dict(encoder_seq=24))}


def _frontend_models(key):
    """Reduced pixtral or whisper in fp32: (cfg, reference model, reference
    params)."""
    arch, over = FRONTENDS[key]
    cfg_j = dataclasses.replace(fp32_reduced(arch), **over)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32", **over)
    model_j = JModel(cfg_j)
    return cfg_t, model_j, model_j.init_params(jax.random.PRNGKey(0)), None, None


def _frontend_job(cfg, params_j):
    """The rank job of a vision-prefix or encoder-decoder model: a prefill's
    logits over one request's extra inputs, and the whole-prompt engine on
    fp4 pools, gated, over prompts of 12, 20, 5 and 30 text tokens with one
    row of extra inputs each (the same numpy arrays on every rank)."""
    traffic = whole_traffic(cfg.vocab_size)
    return dict(cfg=cfg, params=jax.tree.map(np.asarray, params_j),
                logit_tokens=(np.arange(21, dtype=np.int32) * 5 + 3) % cfg.vocab_size,
                logit_extra=stub_arrays(cfg, 1, 31),
                cases={"whole-fp4": dict(engine=dict(WHOLE, cache_spec="fp4_e2m1"),
                                         traffic=traffic, gated=True,
                                         extra=stub_arrays(cfg, len(traffic), 32))})


@pytest.fixture(scope="module")
def ranks4():
    probe = _probe(4)
    return probe, mesh.spawn_ranks(run_rank, 4, dict(probe=probe), device="cpu", threads=1,
                                   timeout_s=600)


@pytest.fixture(scope="module")
def served(models):
    """2 TP ranks (probe, refusals, logits, engine cases), the port's
    single-rank engine and the reference Engine on every case."""
    cfg, _, params_j, _, _ = models
    params_np = jax.tree.map(np.asarray, params_j)
    cases = _cases(cfg.vocab_size)
    job = dict(probe=_probe(2), cfg=cfg, params=params_np, cases=cases,
               logit_tokens=(np.arange(24, dtype=np.int32) * 7 + 1) % cfg.vocab_size)
    moe_models = _moe_models()
    moe_cfg, moe_j, moe_params_j = moe_models[:3]
    job["moe"] = dict(cfg=moe_cfg, params=jax.tree.map(np.asarray, moe_params_j),
                      cases=_moe_cases(moe_cfg.vocab_size),
                      logit_tokens=(np.arange(80, dtype=np.int32) * 5 + 2) % moe_cfg.vocab_size)
    jamba_cfg, _, jamba_params_j = _jamba_models()[:3]
    job["jamba"] = dict(cfg=jamba_cfg, params=jax.tree.map(np.asarray, jamba_params_j),
                        cases=_jamba_cases(jamba_cfg.vocab_size),
                        logit_tokens=(np.arange(21, dtype=np.int32) * 3 + 1)
                        % jamba_cfg.vocab_size)
    frontend_models = {key: _frontend_models(key) for key in FRONTENDS}
    for key, (f_cfg, _, f_params_j, _, _) in frontend_models.items():
        job[key] = _frontend_job(f_cfg, f_params_j)
    xlstm_models = _xlstm_models()
    xlstm_cfg, _, xlstm_params_j = xlstm_models[:3]
    job["xlstm"] = dict(cfg=xlstm_cfg, params=jax.tree.map(np.asarray, xlstm_params_j),
                        cases=_xlstm_cases(xlstm_cfg.vocab_size),
                        logit_tokens=(np.arange(21, dtype=np.int32) * 5 + 2)
                        % xlstm_cfg.vocab_size)
    ranks = mesh.spawn_ranks(run_rank, 2, job, device="cpu", threads=2, timeout_s=600)
    single = run_tp_cases(None, "cpu", cfg, params_np, job)
    moe = job["moe"]
    single_moe = run_tp_cases(None, "cpu", moe_cfg, moe["params"], moe)
    single_jamba = run_tp_cases(None, "cpu", jamba_cfg, job["jamba"]["params"], job["jamba"])
    single_frontends = {key: run_tp_cases(None, "cpu", job[key]["cfg"], job[key]["params"],
                                          job[key]) for key in FRONTENDS}
    single_xlstm = run_tp_cases(None, "cpu", xlstm_cfg, job["xlstm"]["params"], job["xlstm"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reference_engine, "jnp", _CopyingJnp())
        reference = {name: _reference(models, case) for name, case in cases.items()}
        reference_moe = {name: _reference(moe_models, case) for name, case in moe["cases"].items()}
        reference_frontends = {key: _reference(frontend_models[key], job[key]["cases"]["whole-fp4"])
                               for key in FRONTENDS}
        reference_xlstm = _reference(xlstm_models, job["xlstm"]["cases"]["xlstm-whole-fp4"])
    return dict(job=job, ranks=ranks, single=single, reference=reference, single_moe=single_moe,
                reference_moe=reference_moe, single_jamba=single_jamba,
                single_frontends=single_frontends, reference_frontends=reference_frontends,
                single_xlstm=single_xlstm, reference_xlstm=reference_xlstm)


def _ranks(n, ranks4, served):
    if n == 4:
        return ranks4
    return served["job"]["probe"], served["ranks"]


# ---------------------------------------------------------------- collectives


def _simulated(probe, name, kind):
    """What the port's simulated path gives for ``kind`` on the stacked
    partials."""
    x = _stacked(probe, name)
    if kind == "accum_bf16":
        comp = ops.mx_quantize(x, SPEC)
        return ops.mx_dequant_reduce(comp, SPEC, out_dtype=torch.bfloat16).to(x.dtype)
    y = compressed_psum(x, SPEC)
    if kind.startswith("two_phase"):
        y = ops.mx_dequantize(ops.mx_quantize(y, SPEC), SPEC, out_dtype=x.dtype)
    return y


@pytest.mark.parametrize("kind", ["gather/1", "gather/2", "gather/4", "two_phase",
                                  "two_phase/strict", "accum_bf16", "maybe/compressed"])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_reduction_bit_identical_to_simulated(n, kind, ranks4, served):
    probe, ranks = _ranks(n, ranks4, served)
    for name in probe["partials"]:
        want = _simulated(probe, name, kind)
        for r in ranks:
            got = r["collectives"][name][kind]
            np.testing.assert_array_equal(got["y"].reshape(-1), _bits(want).reshape(-1),
                                          err_msg=f"{name} {kind}")
            if "shape" in got:
                assert got["shape"] == tuple(want.shape) and got["dtype"] == str(want.dtype)
    assert all(r["transport"] == "gloo-staged" for r in ranks)


@pytest.mark.parametrize("n", [2, 4])
def test_gathered_wire_is_the_stacked_quantize(n, ranks4, served):
    probe, ranks = _ranks(n, ranks4, served)
    for name in probe["partials"]:
        x = _stacked(probe, name)
        full = ops.mx_quantize(x, SPEC)
        for r in ranks:
            for k in (1, 4):
                w = r["collectives"][name][f"wire/{k}"]
                assert w["n_chunks"] == k
                chunks = [ops.mx_quantize(c.contiguous(), SPEC) for c in x.chunk(k, dim=-1)]
                for i, c in enumerate(chunks):
                    np.testing.assert_array_equal(w["payload"][i].reshape(-1),
                                                  _bits(c.payload).reshape(-1))
                    np.testing.assert_array_equal(w["scales"][i].reshape(-1),
                                                  _bits(c.scales).reshape(-1))
            pay = np.concatenate([p.reshape(*full.payload.shape[:-1], -1)
                                  for p in r["collectives"][name]["wire/4"]["payload"]], -1)
            np.testing.assert_array_equal(pay.reshape(-1), _bits(full.payload).reshape(-1))


@pytest.mark.parametrize("n", [2, 4])
def test_keep_local_fp_adds_own_partial_at_full_precision(n, ranks4, served):
    probe, ranks = _ranks(n, ranks4, served)
    for name in probe["partials"]:
        x = _stacked(probe, name)
        comp = ops.mx_quantize(x, SPEC)
        total = ops.mx_dequant_reduce(comp, SPEC, out_dtype=torch.float32)
        outs = []
        for rank, r in enumerate(ranks):
            own_q = ops.mx_dequantize(MXCompressed(comp.payload[rank], comp.scales[rank]), SPEC,
                                      out_dtype=torch.float32)
            want = (total - own_q + x[rank].float()).to(x.dtype)
            got = r["collectives"][name]["keep_local_fp"]["y"]
            np.testing.assert_array_equal(got.reshape(-1), _bits(want).reshape(-1))
            outs.append(got)
        # each rank keeps its own residual: the outputs differ across ranks
        assert any(not np.array_equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("n", [2, 4])
def test_collective_counts_and_bytes(n, ranks4, served):
    probe, ranks = _ranks(n, ranks4, served)
    for name in probe["partials"]:
        x = _stacked(probe, name)[0]
        comp = ops.mx_quantize(x, SPEC)
        wire = comp.payload.numel() + comp.scales.numel()
        slc = ops.mx_quantize(x.reshape(-1, n, x.shape[-1] // n)[:, 0].contiguous(), SPEC)
        slice_wire = slc.payload.numel() + slc.scales.numel()
        c = ranks[0]["collectives"][name]
        for k in (1, 2, 4):
            assert c[f"gather/{k}"]["counts"]["all_gather"] == 2 * k
            assert c[f"gather/{k}"]["counts"]["bytes"] == wire
            assert c[f"gather/{k}"]["counts"]["all_reduce"] == 0
        tp = c["two_phase"]["counts"]
        assert (tp["all_to_all"], tp["all_gather"], tp["bytes"]) == (2, 2, wire + slice_wire)
        for kind in ("dense", "maybe/gated", "maybe/none"):
            cnt = c[kind]["counts"]
            assert (cnt["all_reduce"], cnt["all_gather"]) == (1, 0), kind
            assert cnt["bytes"] == x.numel() * x.element_size()
        assert c["maybe/compressed"]["counts"]["all_gather"] == 2


@pytest.mark.parametrize("n", [2, 4])
def test_dense_reduction_and_compressed_all_gather(n, ranks4, served):
    probe, ranks = _ranks(n, ranks4, served)
    for name in probe["partials"]:
        x = _stacked(probe, name)
        want = x.float().sum(0).to(x.dtype)
        dense = [r["collectives"][name]["dense"]["y"] for r in ranks]
        assert all(np.array_equal(dense[0], d) for d in dense[1:])
        got = torch.from_numpy(dense[0].copy()).view(x.dtype).reshape(want.shape)
        # the all-reduce sums in its own order, rounding to the dtype at each
        # of its n - 1 adds: within (n - 1) units of the dtype's rounding of
        # the summands' magnitudes (and the final rounding)
        eps = torch.finfo(x.dtype).eps / 2
        bound = n * eps * x.float().abs().sum(0)
        assert bool(((got.float() - x.float().sum(0)).abs() <= bound).all()), name
        ag = ops.mx_dequantize(ops.mx_quantize(x, SPEC), SPEC, out_dtype=x.dtype)
        for r in ranks:
            assert r["collectives"][name]["all_gather"]["shape"] == tuple(ag.shape)
            np.testing.assert_array_equal(r["collectives"][name]["all_gather"]["y"].reshape(-1),
                                          _bits(ag).reshape(-1))
        for kind in ("maybe/gated", "maybe/none"):   # below min_tokens / no policy: dense
            np.testing.assert_array_equal(ranks[0]["collectives"][name][kind]["y"], dense[0])


@pytest.mark.parametrize("n", [2, 4])
def test_rank_all_gather_concatenates_columns(n, ranks4, served):
    """``rank_all_gather`` (a vision prefix's ``mm_proj`` columns): every
    rank's partial concatenated along the last axis in rank order, bit for
    bit, on every rank; counted as one ``dense_all_gather`` with this
    rank's bytes, and as no reduction's all-gather."""
    probe, ranks = _ranks(n, ranks4, served)
    for name in probe["partials"]:
        x = _stacked(probe, name)
        want = torch.cat(list(x.unbind(0)), dim=-1)
        nbytes = x[0].numel() * x.element_size()
        for r in ranks:
            got = r["collectives"][name]["dense_all_gather"]
            assert got["shape"] == tuple(want.shape)
            np.testing.assert_array_equal(got["y"].reshape(-1), _bits(want).reshape(-1))
            c = got["counts"]
            assert (c["dense_all_gather"], c["all_gather"], c["all_reduce"]) == (1, 0, 0)
            assert c["dense_all_gather_bytes"] == c["bytes"] == nbytes


@pytest.mark.parametrize("n", [2, 4])
def test_two_phase_downgrade_warns_once_or_raises(n, ranks4, served):
    _, ranks = _ranks(n, ranks4, served)
    for r in ranks:
        d = r["collectives"]["downgrade"]
        assert len(d["warnings"]) == 1 and "not divisible" in d["warnings"][0]
        assert d["same"]
        assert d["strict"] and "falling back" in d["strict"]


_REFERENCE_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.collectives import compressed_psum
from repro.core.policy import PAPER_DEFAULT
data = np.load(sys.argv[1])
x = jnp.asarray(data["x"])                          # (4, M, F)
mesh = compat.make_mesh((4,), ("model",))
out = {}
for name, kw in (("gather/1", {}), ("gather/2", dict(overlap_chunks=2)),
                 ("two_phase", dict(variant="two_phase", axis_size=4)),
                 ("keep_local_fp", dict(keep_local_fp=True))):
    f = compat.shard_map(
        lambda p: compressed_psum(p[0], "model", PAPER_DEFAULT.spec, **kw)[None],
        mesh=mesh, in_specs=(P("model"),), out_specs=P("model"), check_vma=False)
    out[name] = np.asarray(jax.jit(f)(x))               # (4, M, F): every worker's output
np.savez(sys.argv[2], **{k.replace("/", "_"): v for k, v in out.items()})
"""


def test_rank_collectives_match_reference_shard_map(ranks4, tmp_path):
    """The 4-rank collectives against the reference's ``compressed_psum``
    under ``shard_map`` on 4 host CPU devices (every worker's output),
    fp32 partials, within rel-L2 1e-4."""
    probe, ranks = ranks4
    x = probe["partials"]["f32"][0]
    np.savez(tmp_path / "x.npz", x=x)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT), str(tmp_path / "x.npz"),
         str(tmp_path / "ref.npz")], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu"), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    for kind in ("gather/1", "gather/2", "two_phase", "keep_local_fp"):
        for rank, r in enumerate(ranks):
            got = r["collectives"]["f32"][kind]["y"].view(np.float32).reshape(x.shape[1:])
            want = ref[kind.replace("/", "_")][rank]
            assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4, (kind, rank)


# --------------------------------------------------------------------- weights


def _leaves(tree, key="", parent=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k, key)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v, key, parent)
    else:
        yield parent, key, tree


def _to_numpy(tree):
    """A torch parameter tree as numpy, in the tree's own key order."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.float().numpy()


def _leaf_blocks(cfg):
    """The block kind ``shard_axis`` reads (``layer_block``: an xLSTM layer's
    kind, else None) of every leaf of ``cfg``'s tree, in ``_leaves``
    order."""
    def walk(tree, key, block):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, k, block)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, key, layer_block(cfg, key, i, block))
        else:
            yield block
    return list(walk(param_shapes(cfg), "", None))


def _sharded_tree_checks(cfg, n):
    """``init_params(tp=(r, n))`` draws the single-rank tree and keeps rank
    r's slice; ``shard_params`` slices a numpy tree the same way; either
    way the n shards put together are the tree, and each shard has the
    rank-local config's shapes. Returns the tree's (parent, key, tensor)
    leaves."""
    model = Model(cfg)
    full = list(_leaves(model.init_params(device="cpu", seed=3)))
    shards = [list(_leaves(model.init_params(device="cpu", seed=3, tp=(r, n))))
              for r in range(n)]
    np_tree = _to_numpy(model.init_params(device="cpu", seed=3))
    np_shards = [list(_leaves(shard_params(np_tree, cfg, r, n))) for r in range(n)]
    local = list(_leaves(param_shapes(cfg.tp_shard(n))))
    blocks = _leaf_blocks(cfg)
    assert len(local) == len(full) == len(blocks)
    for i, (parent, key, t) in enumerate(full):
        axis = shard_axis(parent, key, blocks[i])
        parts = [s[i][2] for s in shards]
        assert all(tuple(p.shape) == local[i][2] for p in parts), (parent, key)
        if axis is None:
            assert all(torch.equal(p, t) for p in parts)
        else:
            assert torch.equal(torch.cat(parts, dim=axis), t), (parent, key)
        np_parts = [s[i][2] for s in np_shards]
        np.testing.assert_array_equal(
            np_parts[0] if axis is None else np.concatenate(np_parts, axis=axis),
            t.float().numpy())
    return full


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_params_concatenate_to_single_rank_tree(n):
    """``_sharded_tree_checks`` on qwen2 with 4 kv heads."""
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-7b")), n_kv_heads=4)
    full = _sharded_tree_checks(cfg, n)
    assert any(k == "b" for _, k, _ in full)   # qwen2's q/k/v biases are sharded too


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-medium"])
def test_frontend_sharded_params_concatenate_to_single_rank_tree(arch, n):
    """``_sharded_tree_checks`` on reduced pixtral and whisper: ``mm_proj``
    by its output columns, each encoder layer and each cross-attention's
    ``core`` as a decoder layer (its heads and MLP columns), ``enc_norm``
    and the cross-attention norms whole."""
    cfg = reduced_config(get_config(arch))
    full = _sharded_tree_checks(cfg, n)
    tree = param_shapes(cfg)
    if cfg.frontend == "vision":
        assert shard_axis("mm_proj", "w") == -1 and "mm_proj" in {p for p, _, _ in full}
        return
    per_layer = len(list(_leaves(tree["layers"][0]["core"])))
    enc = [x for x in _leaves(tree["enc_layers"])]
    assert len(enc) == cfg.n_encoder_layers * (2 + per_layer + len(list(_leaves(
        tree["enc_layers"][0]["mlp"]))))
    sharded = [shard_axis(p, k) for p, k, _ in _leaves(tree["xattn"])]
    assert sharded.count(None) == cfg.n_layers        # each ln
    assert sharded.count(-1) == 3 * cfg.n_layers and sharded.count(-2) == cfg.n_layers
    assert all(shard_axis(p, k) is None for p, k, _ in _leaves(tree["enc_norm"]))


@pytest.mark.parametrize("n", [2, 4])
def test_xlstm_sharded_params_concatenate_to_single_rank_tree(n):
    """``_sharded_tree_checks`` on reduced xlstm at d_model 384: the mLSTM
    leaves by d_inner (``up``, ``z``, conv, ``norm`` by columns; ``wq``,
    ``wk``, ``wv``, ``wi``, ``wf.w``, ``down`` by rows, as the reference's
    ``mlstm_specs``), the sLSTM FF (``ff_up``, ``ff_gate`` by columns,
    ``ff_down`` by rows), every other sLSTM leaf whole."""
    cfg = reduced_config(get_config("xlstm-125m"), d_model=XLSTM_D)
    full = _sharded_tree_checks(cfg, n)
    blocks = _leaf_blocks(cfg)
    slstm = [(p, k) for (p, k, _), b in zip(full, blocks) if b == "slstm"
             and shard_axis(p, k, b) is None]
    assert len(slstm) == 11   # ln1, norm, four gates, the forget bias, four r*
    assert [shard_axis(p, k, b) for (p, k, _), b in zip(full, blocks)
            if b == "mlstm"].count(-2) == 6


def test_configs_that_do_not_shard_are_refused():
    cfg = reduced_config(get_config("llama2-7b"))          # 4 heads, d_ff 512
    assert cfg.tp_shard(1) is cfg
    assert (cfg.tp_shard(2).n_heads, cfg.tp_shard(2).n_kv_heads, cfg.tp_shard(2).d_ff) == \
        (2, 2, 256)
    for n in (3, 8):
        with pytest.raises(ValueError, match="does not shard"):
            cfg.tp_shard(n)
        with pytest.raises(ValueError, match="does not shard"):
            Model(cfg).init_params(device="cpu", tp=(0, n))
    with pytest.raises(ValueError, match="d_ff"):
        dataclasses.replace(cfg, d_ff=96).tp_shard(2)
    full = get_config("llama2-13b").tp_shard(4)
    assert (full.n_heads, full.n_kv_heads, full.d_ff) == (10, 10, 3456)
    assert get_config("llama2-7b").tp_shard(2).d_ff == 5504


# ---------------------------------------------------------------- the engine


def test_mixed_step_logits_at_tp2(served):
    for name, want in served["single"]["logits"].items():
        got = [r["cases"]["logits"][name] for r in served["ranks"]]
        assert np.array_equal(got[0], got[1]), name          # replicated logits
        assert np.isfinite(got[0]).all() and got[0].shape == want.shape
        assert np.linalg.norm(got[0] - want) / np.linalg.norm(want) <= 1e-5, name


@pytest.mark.parametrize("case", ["mixed-fp32", "mixed-fp4", "split-fp32", "split-fp4",
                                  "mixed-bf16-dense", "corrupt-fp4"])
def test_tp_engine_tokens_identical_to_simulated_and_reference(served, case):
    single, ref = served["single"][case], served["reference"][case]
    for i, ref_run in enumerate(ref):
        one = single["runs"][i]
        assert one["outputs"] == ref_run["outputs"]
        for r in served["ranks"]:
            run = r["cases"][case]["runs"][i]
            assert run["outputs"] == one["outputs"]
            assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
            assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref_run["summary"]
            assert run["gate"] == one["gate"]
            assert run["events"] == ref_run["events"]
            assert run["n_free"] + run["n_cached"] == r["cases"][case]["n_blocks"] - 1
    rank0 = served["ranks"][0]["cases"][case]
    assert rank0["tp_size"] == 2 and rank0["transport"] == "gloo-staged"
    if case.startswith("mixed") and case != "mixed-bf16-dense":
        gate = rank0["runs"][0]["gate"]
        assert gate["compressed"] > 0 and gate["dense"] > 0
    if case == "corrupt-fp4":
        assert [e[:2] for e in rank0["runs"][0]["events"]] == [("WireCorruption", "hard")]


def test_each_rank_holds_half_of_every_pool(served):
    for name in served["job"]["cases"]:
        one = served["single"][name]
        for r in served["ranks"]:
            c = r["cases"][name]
            assert c["slab_bytes"] == c["pool_bytes_per_device"] == one["pool_bytes"] // 2
            assert c["pool_bytes"] == one["pool_bytes"] and c["n_blocks"] == one["n_blocks"]


@pytest.mark.parametrize("case", ["mixed-fp32", "mixed-fp4", "split-fp32", "split-fp4",
                                  "mixed-bf16-dense"])
def test_collectives_per_step(served, models, case):
    """Two all-gathers (payload, scales) per compressed reduction and one
    all-reduce per dense one, two reductions (``wo``, ``down``) per layer:
    compressed mixed steps or split chunks, dense mixed steps or split
    decodes."""
    L = models[0].n_layers
    split = served["job"]["cases"][case]["engine"]["token_budget"] == 0
    gated = served["job"]["cases"][case].get("gated", False)
    for r in served["ranks"]:
        run = r["cases"][case]["runs"][0]
        s, tp = run["summary"], run["tp"]
        if split:
            n_c = sum(1 for p, _ in run["step_tokens"] if p) if gated else 0
            n_d = sum(1 for _, d in run["step_tokens"] if d) + (
                0 if gated else sum(1 for p, _ in run["step_tokens"] if p))
        else:
            n_c = s["n_compressed_steps"]
            n_d = s["n_steps"] - n_c
        assert (tp["all_gather"], tp["all_reduce"], tp["all_to_all"]) == (
            2 * L * 2 * n_c, 2 * L * n_d, 0), (case, tp)


def test_moe_mixed_step_logits_at_tp2(served):
    """Reduced mixtral on 2 ranks: each holds half of every expert's d_ff,
    and one mixed step's logits (the dispatch path) lie within rel-L2 1e-5
    of the single-rank port's, dense and compressed."""
    for name, want in served["single_moe"]["logits"].items():
        got = [r["moe"]["logits"][name] for r in served["ranks"]]
        assert np.array_equal(got[0], got[1]), name
        assert np.isfinite(got[0]).all() and got[0].shape == want.shape
        assert np.linalg.norm(got[0] - want) / np.linalg.norm(want) <= 1e-5, name


def test_moe_engine_tokens_identical_on_ranks(served):
    """Tokens equal on both ranks, to the single-rank engine (simulate_tp=2)
    and to the reference Engine; half the pool bytes per rank; per step two
    all-gathers per compressed ``wo`` reduction, one all-reduce per dense
    one, and one all-reduce per MoE layer for the routed experts."""
    case = "moe-mixed-fp4"
    cfg = served["job"]["moe"]["cfg"]
    L = cfg.n_layers
    assert all(s.moe for s in cfg.layers) and cfg.n_shared_experts == 0
    one, ref = served["single_moe"][case], served["reference_moe"][case][0]
    assert one["runs"][0]["outputs"] == ref["outputs"]
    for r in served["ranks"]:
        c = r["moe"][case]
        run = c["runs"][0]
        assert run["outputs"] == one["runs"][0]["outputs"]
        assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
        assert run["gate"] == one["runs"][0]["gate"]
        assert run["gate"]["compressed"] > 0 and run["gate"]["dense"] > 0
        assert c["slab_bytes"] == one["pool_bytes"] // 2 and c["tp_size"] == 2
        s, tp = run["summary"], run["tp"]
        n_c = s["n_compressed_steps"]
        n_d = s["n_steps"] - n_c
        assert (tp["all_gather"], tp["all_reduce"], tp["all_to_all"]) == (
            2 * L * n_c, L * n_d + L * s["n_steps"], 0), tp


def test_jamba_prefill_logits_at_tp2(served):
    """Reduced jamba on 2 ranks (each with half of every Mamba layer's
    channels): a whole-prompt prefill's logits within rel-L2 1e-5 of the
    single-rank port's, dense and compressed (the out-projections'
    reductions compressed between the ranks, x_proj's all-reduced)."""
    for name, want in served["single_jamba"]["logits"].items():
        got = [r["jamba"]["logits"][name] for r in served["ranks"]]
        assert np.array_equal(got[0], got[1]), name
        assert np.isfinite(got[0]).all() and got[0].shape == want.shape
        assert np.linalg.norm(got[0] - want) / np.linalg.norm(want) <= 1e-5, name


def test_jamba_engine_tokens_identical_on_ranks(served):
    """Tokens equal on both ranks and to the single-rank engine's; half the
    pool bytes per rank; the collectives of every whole-prompt prefill
    (compressed) and batched decode (dense: the split decode does not
    compress) pass exact."""
    case = "jamba-whole-fp4"
    cfg = served["job"]["jamba"]["cfg"]
    # compressed per pass: wo or out_proj, and the dense MLP's down (the
    # routed experts' partial is all-reduced, dense)
    R = sum(1 + (cfg.n_shared_experts if s.moe else 1) for s in cfg.layers)
    mamba = sum(s.kind == "mamba" for s in cfg.layers)
    moe = sum(s.moe for s in cfg.layers)
    one = served["single_jamba"][case]["runs"][0]
    assert one["summary"]["n_preemptions"] == 0 and one["gate"] == {"compressed": 0,
                                                                     "dense": 0}
    for r in served["ranks"]:
        c = r["jamba"][case]
        run = c["runs"][0]
        assert run["outputs"] == one["outputs"]
        assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == \
            {k: one["summary"][k] for k in SUMMARY_KEYS}
        assert c["slab_bytes"] == served["single_jamba"][case]["pool_bytes"] // 2
        assert c["tp_size"] == 2
        s, tp = run["summary"], run["tp"]
        n_pre = s["n_dispatches"] - s["n_steps"]     # one prefill + insert per admission
        n_dec = s["n_steps"]
        assert n_pre == 2 * len(served["job"]["jamba"]["cases"][case]["traffic"])
        n_pre //= 2
        passes = n_pre + n_dec
        assert (tp["all_gather"], tp["all_reduce"], tp["all_to_all"]) == (
            2 * R * n_pre, R * n_dec + (mamba + moe) * passes, 0), tp


def test_xlstm_prefill_logits_at_tp2(served):
    """Reduced xlstm on 2 ranks (each with half of the mLSTM heads and of the
    sLSTM FF): a whole-prompt prefill's logits within rel-L2 1e-5 of the
    single-rank port's, dense and compressed (``down`` and ``ff_down``
    compressed between the ranks; the q/k/v/i/f partial all-reduced in
    fp32)."""
    for name, want in served["single_xlstm"]["logits"].items():
        got = [r["xlstm"]["logits"][name] for r in served["ranks"]]
        assert np.array_equal(got[0], got[1]), name
        assert np.isfinite(got[0]).all() and got[0].shape == want.shape
        assert np.linalg.norm(got[0] - want) / np.linalg.norm(want) <= 1e-5, name


def test_xlstm_rank_holds_its_shard_and_the_whole_slstm(served):
    """Each rank's mLSTM core holds half the channels and every row-sharded
    weight's half of its rows; the sLSTM core's gates, recurrent matrices
    and norm have the single-rank shapes, its FF half the columns."""
    one_m, one_s = served["single_xlstm"]["core_shapes"]
    for r in served["ranks"]:
        m, s = r["xlstm"]["core_shapes"]
        assert m["up"]["w"] == (one_m["up"]["w"][0], one_m["up"]["w"][1] // 2)
        assert m["wq"]["w"] == (one_m["wq"]["w"][0] // 2, one_m["wq"]["w"][1])
        assert m["wf"]["b"] == one_m["wf"]["b"] and m["down"]["w"][0] * 2 == one_m["down"]["w"][0]
        for k in ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro", "norm"):
            assert s[k] == one_s[k], k
        assert s["ff_up"]["w"][1] * 2 == one_s["ff_up"]["w"][1] == 512
        assert s["ff_down"]["w"][0] * 2 == one_s["ff_down"]["w"][0]


def test_xlstm_engine_tokens_identical_on_ranks(served):
    """Tokens, steps and dispatches equal on both ranks, to the single-rank
    engine (``simulate_tp=2``) and to the reference Engine; no pools; the
    collectives of every whole-prompt prefill (compressed: ``down`` and
    ``ff_down``) and batched decode (dense) exact, with one dense
    all-reduce per mLSTM layer and pass for its q/k/v/i/f partial."""
    case = "xlstm-whole-fp4"
    cfg = served["job"]["xlstm"]["cfg"]
    R, M = cfg.n_layers, sum(s.kind == "mlstm" for s in cfg.layers)
    one = served["single_xlstm"][case]["runs"][0]
    ref = served["reference_xlstm"][0]
    assert one["outputs"] == ref["outputs"]
    assert {k: one["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
    for r in served["ranks"]:
        c = r["xlstm"][case]
        run = c["runs"][0]
        assert run["outputs"] == one["outputs"]
        assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
        assert c["slab_bytes"] == c["pool_bytes"] == 0 and c["tp_size"] == 2
        s, tp = run["summary"], run["tp"]
        n_pre = s["n_dispatches"] - s["n_steps"]     # one prefill + insert per admission
        assert n_pre == 2 * len(served["job"]["xlstm"]["cases"][case]["traffic"])
        n_pre //= 2
        passes = n_pre + s["n_steps"]
        assert (tp["all_gather"], tp["all_reduce"], tp["all_to_all"]) == (
            2 * R * n_pre, R * s["n_steps"] + M * passes, 0), tp


@pytest.mark.parametrize("key", list(FRONTENDS))
def test_frontend_prefill_logits_at_tp2(served, key):
    """Reduced pixtral or whisper on 2 ranks: a whole-prompt prefill's
    logits (prefix or encoder included) within rel-L2 1e-5 of the
    single-rank port's, dense and compressed (against ``simulate_tp=2``)."""
    for name, want in served["single_frontends"][key]["logits"].items():
        got = [r[key]["logits"][name] for r in served["ranks"]]
        assert np.array_equal(got[0], got[1]), name
        assert np.isfinite(got[0]).all() and got[0].shape == want.shape
        assert np.linalg.norm(got[0] - want) / np.linalg.norm(want) <= 1e-5, name


@pytest.mark.parametrize("key", list(FRONTENDS))
def test_frontend_engine_tokens_identical_on_ranks(served, key):
    """The whole-prompt engine on fp4 pools, gated, with one row of extra
    inputs per request: tokens, steps and dispatches equal on both ranks,
    to the single-rank engine (``simulate_tp=2``) and to the reference
    Engine (``simulate_tp=2``) on the same numpy weights and inputs."""
    one = served["single_frontends"][key]["whole-fp4"]["runs"][0]
    ref = served["reference_frontends"][key][0]
    assert one["outputs"] == ref["outputs"]
    assert {k: one["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
    for r in served["ranks"]:
        c = r[key]["whole-fp4"]
        run = c["runs"][0]
        assert c["tp_size"] == 2 and c["transport"] == "gloo-staged"
        assert run["outputs"] == one["outputs"]
        assert all(o == "ok" for o in run["outcomes"]) and run["finite"]
        assert {k: run["summary"][k] for k in SUMMARY_KEYS} == ref["summary"]
        assert run["summary"]["n_preemptions"] == 0


@pytest.mark.parametrize("key", list(FRONTENDS))
def test_frontend_collectives_per_pass(served, key):
    """Per whole-prompt prefill two all-gathers per compressed reduction
    (each decoder layer's ``wo`` and ``down``; whisper adds each
    cross-attention's ``wo`` and each encoder layer's ``wo`` and ``down``)
    and pixtral one dense all-gather of its prefix (``n_patches`` rows of
    the rank's ``d_model / 2`` columns); per decode step (2 tokens, under
    the ``min_tokens`` gate) one all-reduce per reduction; no all-to-all."""
    cfg = served["job"][key]["cfg"]
    L = cfg.n_layers
    r_dec = 2 * L + (L if cfg.encoder_decoder else 0)
    r_pre = r_dec + (2 * cfg.n_encoder_layers if cfg.encoder_decoder else 0)
    vision = cfg.frontend == "vision"
    for r in served["ranks"]:
        run = r[key]["whole-fp4"]["runs"][0]
        s, tp = run["summary"], run["tp"]
        n_pre = s["n_dispatches"] - s["n_steps"]     # one prefill + insert per admission
        assert n_pre == 2 * len(served["job"][key]["cases"]["whole-fp4"]["traffic"])
        n_pre //= 2
        assert (tp["all_gather"], tp["all_reduce"], tp["all_to_all"]) == (
            2 * r_pre * n_pre, r_dec * s["n_steps"], 0), tp
        assert tp["dense_all_gather"] == (n_pre if vision else 0)
        assert tp["dense_all_gather_bytes"] == (
            n_pre * cfg.n_patches * (cfg.d_model // 2) * 4 if vision else 0)


@pytest.mark.parametrize("key", list(FRONTENDS))
def test_frontend_rank_holds_half_of_pools_and_cross_kv(served, key):
    """Each rank holds half the single-rank engine's pool bytes and (whisper)
    half its cross K/V, every tensor at the rank's ``kv_dim``."""
    cfg = served["job"][key]["cfg"]
    one = served["single_frontends"][key]["whole-fp4"]
    assert (one["cross_bytes"] > 0) == cfg.encoder_decoder
    for r in served["ranks"]:
        c = r[key]["whole-fp4"]
        assert c["slab_bytes"] * 2 == one["slab_bytes"]
        assert c["cross_bytes"] * 2 == one["cross_bytes"]
        assert c["pool_bytes_per_device"] == c["slab_bytes"] + c["cross_bytes"]
        assert c["pool_bytes"] == one["pool_bytes"] == 2 * c["pool_bytes_per_device"]
        if cfg.encoder_decoder:
            assert c["cross_widths"] == [cfg.kv_dim // 2] and one["cross_widths"] == [cfg.kv_dim]


def test_refusals_on_the_rank_path(served):
    for r in served["ranks"]:
        m = r["refusals"]
        assert m["keep_local_fp"] and "Queue 3 item 11" in m["keep_local_fp"]
        assert m["simulate_tp"] and "simulate_tp=2" in m["simulate_tp"]
        assert m["kv_group"] and "tp_group and kv_group overlap in ranks [0, 1]" in m["kv_group"]


def test_backend_rule(monkeypatch):
    assert mesh.backend_for(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.backend_for(2, "cuda") == "nccl"
    assert mesh.backend_for(4, "cuda") == "gloo"


def test_serve_cli_tp_on_cpu(capfd):
    """``launch/serve.py --tp 2`` on the CPU: rank 0's banner names the
    group and its transport, the report its collectives, and both ranks
    sample the tokens of ``--simulate-tp 2``; with ``--shard-pools 2`` too,
    all 4 ranks of the kv x model grid sample them."""
    argv = ["--reduced", "--device", "cpu", "--slots", "2", "--requests", "3", "--prompt-len",
            "40", "--new-tokens", "3", "--cache-spec", "fp4_e2m1"]
    _, out = serve.main(argv + ["--simulate-tp", "2"])
    simulated = [r.output.tolist() for r in out]
    capfd.readouterr()
    engine, ranks = serve.main(argv + ["--tp", "2", "--overlap-chunks", "2"])
    text = capfd.readouterr().out
    assert engine is None and ranks == [simulated, simulated]
    assert "tp=2 transport=gloo-staged overlap_chunks=2" in text
    assert "collectives (gloo-staged):" in text and "tp ranks: all 2 sampled identical" in text
    capfd.readouterr()
    engine, ranks = serve.main(argv + ["--tp", "2", "--shard-pools", "2"])
    text = capfd.readouterr().out
    assert engine is None and ranks == [simulated] * 4
    assert "tp=2 kv=2 transport=gloo-staged" in text and "grid ranks: all 4 sampled identical" in text
    with pytest.raises(ValueError, match="give one of them"):
        serve.main(argv + ["--tp", "2", "--simulate-tp", "2"])
