"""The port's vision-prefix model, pixtral-12b, against the reference on the
CPU: fp32, TF32 off, identical weights (the reference's ``init_params``
through ``params_from_numpy``) and identical numpy patch embeddings given to
both packages.

Reduced pixtral keeps its GQA group (4 query heads over 1 kv head at hd 32)
and a 16-patch prefix. Held, rel-L2 <= 1e-5 in fp32: ``_embed_inputs`` (the
patches through ``mm_proj``, unscaled, ahead of the scaled token
embeddings), ``Model.prefill`` logits and every layer's cache over prefix +
right-padded text; under gated ``simulate_tp=2`` the logits within 5e-2
(the bound ``tests/test_torch_prefill.py`` states: a partial within
rounding of an fp4 midpoint may take the neighbouring code in one
framework). The whole-prompt engine's greedy tokens, steps and dispatches
equal the reference Engine's on bf16 and fp4 pools, dense and gated, with
``extra_inputs`` sliced per request; through a preemption (the re-prefill
carries the request's patches) and a hard recovery (``die@3`` under the
supervisor). The refusals: ``prefill_chunk``, ``token_budget``,
``prefix_cache``, sequence-sharded pools, and extra inputs that are
missing or of the wrong shape; on a TP group of 2 ranks the rank's shapes
(``tests/test_torch_tp.py`` serves both families across ranks). A bf16 patch input reaches the
model as the reference's bf16 values (``StepProgram`` casts on the host).
``param_count`` counts the tree (the reference's count plus ``mm_proj``).
The helpers here serve ``tests/test_torch_encdec.py`` too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.tp import TPContext as JTPContext
from repro.models import frontends as jfrontends
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tp import TPContext
from repro_torch.models import frontends
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.model import Model, param_shapes
from repro_torch.serving import Engine, Request
from repro_torch.serving.graphs import StepProgram
from tests.conftest import fp32_reduced
from tests.test_torch_faults import run_both
from tests.test_torch_serving import (  # noqa: F401  (a fixture)
    contexts, reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "pixtral-12b"
REL, GATED_REL = 1e-5, 5e-2
WHOLE = dict(max_slots=2, max_len=96, block_size=16)   # whole-prompt by default


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def close(got, ref, tol=REL):
    assert rel_l2(got, ref) <= tol


def build_models(arch, **over):
    """(port config, reference model, reference params, port model, port
    params) of ``arch`` reduced, fp32, with ``over`` applied to both."""
    cfg_j = dataclasses.replace(fp32_reduced(arch), **over)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32", **over)
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    model_j = JModel(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    params_j = jax.tree.map(jnp.asarray, tree)
    return cfg_t, model_j, params_j, Model(cfg_t), params_from_numpy(tree, cfg_t, "cpu")


def stub_arrays(cfg, batch, seed=0):
    """The model's extra inputs for ``batch`` requests as numpy fp32: normals
    scaled by ``d_model**-0.5``, the stubs' distribution."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=shape) * cfg.d_model**-0.5).astype(np.float32)
            for k, shape in frontends.frontend_shapes(cfg, batch).items()}


def whole_traffic(vocab):
    """(prompt, max_new_tokens): text prompts of 12, 20, 5 and 30 tokens
    (buckets 16 and 32), 4..7 new tokens."""
    return [(((np.arange(n, dtype=np.int32) * 11 + i) % vocab).astype(np.int32), 4 + i)
            for i, n in enumerate((12, 20, 5, 30))]


def both_prefill(models, tokens, extra, gated=False):
    """Both models' ``prefill`` of ``tokens`` (B, S) with ``extra`` into a
    fresh dense cache of the prompt's positions (a vision prefix's too);
    logits read at the last position."""
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j, ctx_t = contexts(gated)
    B, S = tokens.shape
    total = S + (cfg.n_patches if cfg.frontend == "vision" else 0)
    batch = {"tokens": tokens, **extra}
    out_j = model_j.prefill(ctx_j, params_j, {k: jnp.asarray(v) for k, v in batch.items()},
                            model_j.init_cache(B, total, jnp.float32))
    out_t = model_t.prefill(ctx_t, params_t, {k: torch.from_numpy(v) for k, v in batch.items()},
                            model_t.init_cache(B, total, torch.float32, "cpu"))
    return out_j, out_t


def leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(leaves(v) for v in tree)
    return int(np.prod(tree))


def _shapes(tree):
    """A parameter tree's leaf shapes, in ``param_shapes``' form."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def check_refusals(models, extra, monkeypatch):
    """The whole-prompt gate's refusals (the reference's errors), an
    engine on sequence-sharded pools (half the blocks, the cross K/V whole),
    and extra inputs that are missing or of the wrong shape. A TP group of 2 ranks is served: ``init_params(tp=(0, 2))``,
    ``shard_params`` and an engine on ``tp_size`` 2 give the rank's shapes
    (of the config with at least 2 kv heads; 1 kv head does not shard)."""
    cfg, _, _, model_t, params_t = models
    kw = dict(WHOLE, device="cpu")
    for opt, msg in ((dict(prefill_chunk=16), "requires a pure-attention"),
                     (dict(token_budget=18), "rides on chunked prefill"),
                     (dict(prefix_cache=True), "rides on chunked prefill")):
        with pytest.raises(ValueError, match=msg):
            Engine(model_t, params_t, TPContext(), **kw, **opt)
    eng = Engine(model_t, params_t, TPContext(), **kw)
    assert eng.prefill_chunk == eng.token_budget == 0
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="extra_inputs"):
        eng.run([Request(prompt=prompt, max_new_tokens=2)])
    (key, value), = extra.items()
    with pytest.raises(ValueError, match=key):
        eng.run([Request(prompt=prompt, max_new_tokens=2)], extra_inputs={key: value[:, :3]})
    with pytest.raises(ValueError, match="extra_inputs"):
        eng.measure_ttft(5, iters=1)
    if cfg.n_kv_heads % 2:
        with pytest.raises(ValueError, match="does not shard"):
            model_t.init_params(device="cpu", tp=(0, 2))
    tp_cfg = dataclasses.replace(cfg, n_kv_heads=max(cfg.n_kv_heads, 2))
    local = tp_cfg.tp_shard(2)
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.mm_proj_cols) == (
        tp_cfg.n_heads // 2, tp_cfg.n_kv_heads // 2, tp_cfg.d_ff // 2, tp_cfg.d_model // 2)
    tp_model = Model(tp_cfg)
    shard = tp_model.init_params(device="cpu", tp=(0, 2))
    assert _shapes(shard) == param_shapes(local)
    to_numpy = lambda tree: jax.tree.map(lambda t: t.numpy(), tree,
                                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    np_shard = shard_params(to_numpy(tp_model.init_params(device="cpu")), tp_cfg, 0, 2)
    assert _shapes(np_shard) == param_shapes(local)
    for a, b in zip(jax.tree.leaves(np_shard), jax.tree.leaves(to_numpy(shard))):
        np.testing.assert_array_equal(a, b)
    with monkeypatch.context() as m:
        m.setattr(TPContext, "tp_size", property(lambda self: 2))
        eng = Engine(tp_model, shard, TPContext(), **kw)
        assert eng.cfg.n_kv_heads == local.n_kv_heads and eng.tp_size == 2
        assert eng.kv_pool_bytes() == 2 * eng.kv_pool_bytes(per_device=True)
        for t in eng._state["pools_k"] + eng._state.get("cross_k", []):
            assert t.shape[-1] == local.kv_dim
    # sequence-sharded pools are served: each rank holds half the pool
    # blocks and the cross K/V whole
    monkeypatch.setattr(TPContext, "kv_shards", property(lambda self: 2))
    eng = Engine(model_t, params_t, TPContext(), **kw)
    assert eng.kv_shards == 2 and eng.n_blocks % 2 == 0
    assert all(t.shape[0] == eng.n_blocks // 2 for t in eng._state["pools_k"])
    assert all(t.shape[0] == eng.n_slots for t in eng._state.get("cross_k", []))


@pytest.fixture(scope="module")
def models():
    return build_models(ARCH, n_kv_heads=1)


def test_reduced_pixtral(models):
    cfg, _, _, _, params_t = models
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_patches) == (4, 1, 32, 16)
    assert params_t["mm_proj"]["w"].shape == (cfg.d_model, cfg.d_model)


def test_stubs_match_reference_shapes_and_scale():
    """``frontend_shapes`` as the reference's; the stubs' shape, dtype and
    scale (normals x ``d_model**-0.5``), zeros without a generator, the same
    values for the same seed."""
    for arch in ("pixtral-12b", "whisper-medium", "llama2-7b"):
        cfg, ref = get_config(arch), j_get_config(arch)
        assert frontends.frontend_shapes(cfg, 3) == jfrontends.frontend_shapes(ref, 3)
    cfg = get_config(ARCH)
    x = frontends.patch_embed_stub(cfg, 2, torch.Generator().manual_seed(1))
    assert x.shape == (2, 256, 5120) and x.dtype == torch.bfloat16
    assert abs(float(x.float().std()) * cfg.d_model**0.5 - 1.0) < 0.01
    assert not frontends.patch_embed_stub(cfg, 1).any()
    a, b = (frontends.frontend_stubs(get_config("whisper-medium"), 2, seed=4) for _ in range(2))
    assert set(a) == {"encoder_frames"} and torch.equal(a["encoder_frames"], b["encoder_frames"])
    assert frontends.frontend_stubs(get_config("llama2-7b"), 2, seed=4) == {}


def test_embed_inputs_match_reference(models):
    """The patches through ``mm_proj`` (not scaled by ``sqrt(d_model)``),
    then the scaled token embeddings."""
    cfg, model_j, params_j, model_t, params_t = models
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    extra = stub_arrays(cfg, 2, seed=3)
    batch = {"tokens": tokens, **extra}
    ref = model_j._embed_inputs(JTPContext(mesh=None), params_j,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    got = model_t._embed_inputs(TPContext(), params_t,
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, cfg.n_patches + 9, cfg.d_model)
    close(got.numpy(), ref)
    mm = extra["patch_embeds"] @ params_t["mm_proj"]["w"].numpy()
    close(got[:, :cfg.n_patches].numpy(), mm)


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "simulate_tp2"])
def test_prefill_matches_reference(models, gated):
    """Two 20-token prompts after their 16 patches: logits, and every
    layer's cache of 36 positions; ``pos`` counts the prefix."""
    cfg = models[0]
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    (logits_j, cache_j), (logits_t, cache_t) = both_prefill(models, tokens,
                                                            stub_arrays(cfg, 2, 6), gated)
    close(logits_t.numpy(), logits_j, GATED_REL if gated else REL)
    assert cache_t["pos"] == int(cache_j["pos"]) == cfg.n_patches + 20
    if not gated:
        for got, ref in zip(cache_t["layers"], cache_j["layers"]):
            close(got.k.numpy(), ref.k)
            close(got.v.numpy(), ref.v)


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "gated-simulate_tp2"])
@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_greedy_tokens_identical_to_reference_engine(models, cache, gated,
                                                    reference_copies_host_arrays):
    """Whole-prompt (the only scheduler for a vision prefix), patches sliced
    per request: tokens, steps, dispatches; one program per text bucket."""
    cfg = models[0]
    traffic = whole_traffic(cfg.vocab_size)
    eng_j, eng_t, _ = serve_both(models, traffic, gated=gated, cache_spec=cache,
                                 extra_inputs=stub_arrays(cfg, len(traffic), 7), **WHOLE)
    assert eng_t.prefill_chunk == eng_j.prefill_chunk == 0
    assert eng_t.token_budget == eng_j.token_budget == 0
    assert eng_t.prefill_cache_size() == eng_j.prefill_cache_size() == 2
    assert eng_t.decode_cache_size() == 1


def test_preemption_identical_to_reference_engine(models, reference_copies_host_arrays):
    """Two 12-token prompts after 16 patches on 4 usable blocks: both cross
    32 positions, the later one is preempted and re-prefilled (its patches
    again) with the tokens it generated."""
    cfg = models[0]
    traffic = [(((np.arange(12, dtype=np.int32) * 5 + i) % cfg.vocab_size), 8)
               for i in range(2)]
    _, eng_t, _ = serve_both(models, traffic, gated=True, cache_spec="fp4_e2m1", n_blocks=5,
                             extra_inputs=stub_arrays(cfg, 2, 8), **WHOLE)
    assert eng_t.stats.summary()["n_preemptions"] >= 1


def test_hard_recovery_like_reference(models, reference_copies_host_arrays):
    """``die@3`` under the supervisor: hard recovery, the replay (patches
    re-sliced for the unfinished requests) gives the fault-free tokens."""
    cfg = models[0]
    traffic = whole_traffic(cfg.vocab_size)
    extra = stub_arrays(cfg, len(traffic), 9)
    kw = dict(WHOLE, cache_spec="fp4_e2m1")
    eng = Engine(models[3], models[4], TPContext(), cache_dtype=torch.float32, device="cpu", **kw)
    free = [r.output.tolist() for r in eng.run(
        [Request(prompt=p.copy(), max_new_tokens=n) for p, n in traffic], extra_inputs=extra)]
    _, reqs_t, _, _, _, sup_t = run_both(models, traffic, plan="die@3", supervised=True,
                                         extra_inputs=extra, **kw)
    assert [(e.error, e.mode) for e in sup_t.events] == [("EngineDead", "hard")]
    assert [r.output.tolist() for r in reqs_t] == free


def test_refusals(models, monkeypatch):
    check_refusals(models, stub_arrays(models[0], 1), monkeypatch)


def test_bf16_patches_reach_the_model_as_the_reference_casts_them(monkeypatch):
    """A step program's floating input: fp32 numpy values cast on the host
    into its bf16 slice, bit for bit the reference's ``astype(bfloat16)``
    (round to nearest even), a bf16 tensor copied as is, every input
    16-byte aligned in the one buffer; and in a bf16 engine the patches
    ``Model.prefill`` receives are those bf16 values."""
    x = (np.random.default_rng(1).normal(size=(1, 5, 7)) * 3).astype(np.float32)
    x[0, 0, :3] = [1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8)]   # ties to even
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    prog = StepProgram("p", lambda tokens, pe: pe.clone(),
                       dict(tokens=((1, 3), torch.int32), pe=((1, 5, 7), torch.bfloat16)),
                       torch.device("cpu"), graphed=False)
    base = prog.inputs["tokens"].data_ptr()
    assert (prog.inputs["pe"].data_ptr() - base) % 16 == 0
    got = prog(tokens=np.zeros((1, 3), np.int32), pe=x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    same = prog(tokens=np.zeros((1, 3), np.int32), pe=torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(same.view(torch.int16).numpy().view(np.uint16), want)
    with pytest.raises(ValueError, match="shape"):
        prog(tokens=np.zeros((1, 3), np.int32), pe=x[:, :4])

    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="bfloat16")
    model = Model(cfg)
    params = model.init_params(device="cpu", seed=0)
    seen = []
    prefill = Model.prefill

    def spy(self, ctx, params, batch, cache, **kw):
        seen.append(batch["patch_embeds"].clone())
        return prefill(self, ctx, params, batch, cache, **kw)

    monkeypatch.setattr(Model, "prefill", spy)
    extra = stub_arrays(cfg, 2, 11)
    Engine(model, params, TPContext(), device="cpu", **WHOLE).run(
        [Request(prompt=np.arange(6, dtype=np.int32), max_new_tokens=2) for _ in range(2)],
        extra_inputs=extra)
    ref = jnp.asarray(extra["patch_embeds"]).astype(jnp.bfloat16)
    assert len(seen) == 2
    for i, got in enumerate(seen):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(ref[i:i + 1]).view(np.uint16))


def test_measure_ttft_runs_the_prefix(models):
    """``measure_ttft`` prefills the prefix with the text through the
    bucket's program, as the reference's (and counts it the same way)."""
    cfg, model_j, params_j, model_t, params_t = models
    extra = stub_arrays(cfg, 1, 12)
    eng = Engine(model_t, params_t, TPContext(), device="cpu", prefill_chunk=0, **WHOLE)
    r = eng.measure_ttft(20, iters=2, extra_inputs=extra)
    assert r["iters"] == 1 and r["median_s"] > 0
    assert eng.prefill_cache_size() == 1


def test_param_count_at_full_size():
    """12.27 B parameters: the tree's leaves but the final norm (which
    neither package counts); the reference's count plus ``mm_proj``
    (5120 x 5120), which it leaves out."""
    cfg, ref = get_config(ARCH), j_get_config(ARCH)
    tree = param_shapes(cfg)
    assert cfg.param_count() == leaves(tree) - leaves(tree["final_norm"])
    assert cfg.param_count() - ref.param_count() == cfg.d_model**2 == leaves(tree["mm_proj"])
    assert round(cfg.param_count() / 1e9, 2) == 12.27
    assert cfg.active_param_count() == cfg.param_count()
