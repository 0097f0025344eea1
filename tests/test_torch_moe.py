"""The port's MoE families (mixtral-8x22b, llama4-maverick-400b-a17b) against
the reference, on the CPU, fp32, identical weights and inputs.

``reduced_config`` caps heads at 4; each reduced config here is rebuilt with
``dataclasses.replace`` so that it keeps its GQA group, the same way for both
packages: mixtral 6 query heads over 1 kv head, llama4 5 over 1, both at hd
32. Reduced mixtral has two MoE layers of 4 experts, top-2, with a 32-token
window; reduced llama4 a dense layer then a MoE layer of 4 experts, top-1,
with one shared expert. Weights are the reference's ``init_params`` through
``params_from_numpy``.

Held: ``moe()`` on the tiny-token dense path (64 tokens) and the sort-based
dispatch path (120 tokens), at capacity factors 1.25 and 0.5 (the latter
drops tokens), and its aux losses, max |delta| <= 1e-4 max |ref|;
``apply_layer``, whole-prompt prefill (96 tokens: the dispatch path) and the
chunk (dense pools), decode and mixed (fp4 pools; an 80-token budget, so
the dispatch path with budget pads routed last) steps; greedy tokens, steps,
dispatches and gate counts of the engine identical to the reference
Engine's under the gated ``simulate_tp=2`` context on bf16 and fp4 pools
with an 80-token budget (every mixed step dispatches), and on the split
scheduler, over prompts longer than mixtral's window; ``param_count`` /
``active_param_count`` at full size; the MoE parameter tree and its TP
shards. TF32 is off for torch matmuls in this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core.formats import KVCacheSpec as JKVCacheSpec
from repro.core.tp import TPContext as JTPContext
from repro.models.model import Model as JModel
from repro.models.moe import moe as j_moe
from repro.models.transformer import apply_layer as j_apply_layer
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.formats import KVCacheSpec
from repro_torch.core.tp import TPContext
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.model import Model, param_shapes, shard_axis
from repro_torch.models.moe import DENSE_MAX_TOKENS, capacity, moe, route
from repro_torch.models.transformer import apply_layer
from repro_torch.serving.kv_cache import build_mixed_batch
from tests.test_torch_families import family_traffic
from tests.test_torch_model import _pools as _model_pools
from tests.test_torch_prefill import _check_chunk, _check_decode, _check_pools, _state
from tests.test_torch_serving import (  # noqa: F401  (a fixture)
    ENGINE_KW, reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MOE = {
    "mixtral": ("mixtral-8x22b", dict(n_heads=6, n_kv_heads=1, head_dim=32)),
    "llama4": ("llama4-maverick-400b-a17b", dict(n_heads=5, n_kv_heads=1, head_dim=32)),
}
BUDGET = 80   # above DENSE_MAX_TOKENS: every mixed step takes the dispatch path
MOE_ENGINE = dict(ENGINE_KW, token_budget=BUDGET)


def moe_config(arch, over, reference=False, **extra):
    """The family's reduced config in fp32 with its group kept."""
    cfg = (j_reduced_config(j_get_config(arch)) if reference
           else reduced_config(get_config(arch)))
    return dataclasses.replace(cfg, dtype="float32", **over, **extra)


def build(name, **extra):
    arch, over = MOE[name]
    cfg_j = moe_config(arch, over, reference=True, **extra)
    cfg_t = moe_config(arch, over, **extra)
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    model_j = JModel(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    params_j = jax.tree.map(jnp.asarray, tree)
    return cfg_t, model_j, params_j, Model(cfg_t), params_from_numpy(tree, cfg_t, "cpu")


@pytest.fixture(scope="module", params=sorted(MOE))
def models(request):
    return build(request.param)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def _moe_layer(cfg):
    return next(i for i, s in enumerate(cfg.layers) if s.moe)


def test_reduced_moe_keeps_its_geometry(models):
    cfg, _, _, _, params_t = models
    if cfg.name == "mixtral-8x22b":
        assert cfg.n_heads // cfg.n_kv_heads == 6
        assert [(s.moe, s.window) for s in cfg.layers] == [(True, 32), (True, 32)]
        assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (4, 2, 0)
    else:
        assert cfg.n_heads // cfg.n_kv_heads == 5
        assert [(s.moe, s.window) for s in cfg.layers] == [(False, None), (True, None)]
        assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (4, 1, 1)
        assert "mlp" in params_t["layers"][0] and "shared0" in params_t["layers"][1]["moe"]
    for spec, layer in zip(cfg.layers, params_t["layers"]):
        assert ("moe" in layer) == spec.moe and ("mlp" in layer) != spec.moe


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("tokens", [(2, 32), (2, 60)], ids=["dense-path", "dispatch"])
@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_matches_reference(name, tokens, cf):
    """``moe()`` and its aux losses on x (B, S, d); at 120 tokens and a
    capacity factor of 0.5 tokens are dropped (asserted from the routing)."""
    cfg, _, params_j, _, params_t = build(name, capacity_factor=cf)
    cfg_j = moe_config(*MOE[name], reference=True, capacity_factor=cf)
    i = _moe_layer(cfg)
    x = np.random.default_rng(sum(tokens)).normal(size=(*tokens, cfg.d_model)).astype(np.float32)
    ref, aux_j = j_moe(JTPContext(mesh=None), params_j["layers"][i]["moe"], jnp.asarray(x), cfg_j)
    got, aux_t = moe(TPContext(), params_t["layers"][i]["moe"], torch.from_numpy(x), cfg,
                     aux=True)
    _close(got.numpy(), ref)
    assert set(aux_t) == set(aux_j) == {"load_balance", "router_z"}
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-5)
    assert moe(TPContext(), params_t["layers"][i]["moe"], torch.from_numpy(x), cfg)[1] == {}
    T = tokens[0] * tokens[1]
    _, _, _, idx = route(params_t["layers"][i]["moe"], torch.from_numpy(x).reshape(T, -1), cfg)
    loads = np.bincount(idx.numpy().ravel(), minlength=cfg.n_experts)
    dropped = int(np.maximum(loads - capacity(cfg, T), 0).sum())
    if T > DENSE_MAX_TOKENS and cf == 0.5:
        assert dropped > 0
    if T <= DENSE_MAX_TOKENS:
        assert T == DENSE_MAX_TOKENS     # the dense path's largest call


def test_topk_order_and_ties_follow_jax():
    """Equal router probabilities go to the lower expert first, in
    descending order, as ``jax.lax.top_k`` orders them."""
    cfg = dataclasses.replace(reduced_config(get_config("mixtral-8x22b")), dtype="float32")
    w = torch.zeros(cfg.d_model, cfg.n_experts)
    w[0] = torch.tensor([1.0, 3.0, 3.0, 2.0])
    x = torch.zeros(2, cfg.d_model)
    x[:, 0] = torch.tensor([1.0, 0.0])       # token 1: every expert tied
    _, probs, gates, idx = route({"router": {"w": w}}, x, cfg)
    j_gates, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [[1, 2], [0, 1]]
    np.testing.assert_allclose(gates.numpy(), np.asarray(j_gates) / np.asarray(
        j_gates).sum(-1, keepdims=True), rtol=1e-6)


def test_apply_layer_matches_reference(models):
    """Every layer (MoE or dense) on x (2, 40, d): 80 tokens, dispatched."""
    cfg, _, params_j, _, params_t = models
    x = np.random.default_rng(3).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    for i, spec in enumerate(cfg.layers):
        ref, _, _ = j_apply_layer(JTPContext(mesh=None), cfg, spec, params_j["layers"][i],
                                  jnp.asarray(x), pos=jnp.int32(0))
        got, _ = apply_layer(TPContext(), cfg, spec, params_t["layers"][i], torch.from_numpy(x),
                             pos=0)
        _close(got.numpy(), ref)


def test_prefill_matches_reference(models):
    """Whole-prompt prefill of two 45-token prompts right-padded to 48 (96
    tokens: the dispatch path), logits at the last real token, and every
    layer's dense cache."""
    cfg, model_j, params_j, model_t, params_t = models
    tokens = np.zeros((2, 48), np.int32)
    tokens[:, :45] = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 45))
    logits_j, cache_j = model_j.prefill(JTPContext(mesh=None), params_j,
                                        {"tokens": jnp.asarray(tokens)},
                                        model_j.init_cache(2, 48, jnp.float32),
                                        last_index=jnp.int32(44))
    logits_t, cache_t = model_t.prefill(TPContext(), params_t, {"tokens": torch.from_numpy(tokens)},
                                        model_t.init_cache(2, 48, torch.float32, "cpu"),
                                        last_index=44)
    _close(logits_t.numpy(), logits_j)
    for layer in range(cfg.n_layers):
        for a in ("k", "v"):
            _close(getattr(cache_t["layers"][layer], a).numpy(),
                   getattr(cache_j["layers"][layer], a))


def _check_mixed_dispatch(models, fmt):
    """One mixed step over an 80-token budget: slot 0's 20-token chunk at
    37, slot 1's decode token at 52, 59 budget pads (routed after the real
    tokens); logits and the pools after the step."""
    cfg, model_j, params_j, model_t, params_t = models
    pools_j, pools_t = _model_pools(cfg, fmt)
    L = cfg.n_layers
    chunk = np.random.default_rng(11).integers(0, cfg.vocab_size, 20).astype(np.int32)
    b = build_mixed_batch([(0, chunk, 37)], [(1, 5, 52)], token_budget=BUDGET, n_slots=2)
    assert b.tokens.shape[1] > DENSE_MAX_TOKENS
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    starts = np.array([37, 52], np.int32)
    spec = None if fmt == "dense" else fmt
    j = jnp.asarray
    logits_j, state_j = model_j.mixed_step(
        JTPContext(mesh=None), params_j, j(b.tokens), _state(pools_j, L, True), j(b.slot_ids),
        j(b.positions), j(b.valid), j(b.is_decode), j(starts), j(tables), j(b.sample_idx),
        cache_spec=JKVCacheSpec.parse(spec))
    t = torch.from_numpy
    logits_t, state_t = model_t.mixed_step(
        TPContext(), params_t, t(b.tokens), _state(pools_t, L, False), t(b.slot_ids),
        t(b.positions), t(b.valid), t(b.is_decode), t(starts), t(tables), t(b.sample_idx),
        cache_spec=KVCacheSpec.parse(spec))
    _close(logits_t.numpy(), logits_j)
    # block 0 takes the pads' colliding writes in an order neither defines
    for name in ("pools_k", "pools_v"):
        for layer in range(L):
            state_t[name][layer] = _drop_null_block(state_t[name][layer])
            state_j[name][layer] = _drop_null_block(state_j[name][layer])
    _check_pools(state_t, state_j, fmt, range(L))


def _drop_null_block(pool):
    if hasattr(pool, "payload"):
        return type(pool)(pool.payload[1:], pool.scales[1:])
    return pool[1:]


@pytest.mark.parametrize("step, fmt", [("chunk", "dense"), ("decode", "fp4_e2m1"),
                                       ("mixed", "fp4_e2m1"), ("mixed", "dense")])
def test_paged_steps_match_reference(models, step, fmt):
    """The chunk (16 tokens) and decode (3 slots) steps of
    ``tests/test_torch_prefill.py`` (the dense path), and a mixed step over
    an 80-token budget (the dispatch path), dense context."""
    if step == "chunk":
        _check_chunk(models, fmt, "dense-ctx")
    elif step == "decode":
        _check_decode(models, fmt, "dense-ctx")
    else:
        _check_mixed_dispatch(models, fmt)


@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_greedy_tokens_identical_to_reference_engine(models, cache,
                                                    reference_copies_host_arrays):
    """The mixed scheduler over an 80-token budget, gated ``simulate_tp=2``."""
    _, eng_t, _ = serve_both(models, family_traffic(models[0].vocab_size), gated=True,
                             cache_spec=cache, **MOE_ENGINE)
    assert eng_t.token_budget > DENSE_MAX_TOKENS
    assert eng_t.gate_counts["compressed"] > 0 and eng_t.gate_counts["dense"] > 0


def test_split_scheduler_tokens_identical_to_reference_engine(models,
                                                              reference_copies_host_arrays):
    serve_both(models, family_traffic(models[0].vocab_size), gated=True, cache_spec="fp4_e2m1",
               **dict(MOE_ENGINE, token_budget=0))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-maverick-400b-a17b"])
def test_param_count_at_full_size(arch):
    """Against the reference's counts, and one layer's size as the port's
    weights hold it (mixtral: 2.50 B parameters a layer, 88 M of them
    attention; llama4: 16.3 B a MoE layer, 0.19 B a dense one)."""
    cfg, ref = get_config(arch), j_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    one = lambda layers: dataclasses.replace(cfg, n_layers=len(layers), layers=layers)
    base = one(()).param_count()
    per_layer = [one((spec,)).param_count() - base for spec in cfg.layers[:2]]
    leaves = lambda tree: (sum(leaves(v) for v in tree.values()) if isinstance(tree, dict)
                           else int(np.prod(tree)))
    assert per_layer == [leaves(param_shapes(one((spec,)))["layers"][0])
                         for spec in cfg.layers[:2]]
    if arch == "mixtral-8x22b":
        attn = 6144 * (6144 + 2 * 1024) + 6144 * 6144
        assert per_layer[0] == attn + 6144 * 8 + 8 * 3 * 6144 * 16384 + 2 * 6144
        assert round(per_layer[0] / 1e9, 2) == 2.50
    else:
        assert round(per_layer[1] / 1e9, 1) == 16.3 and round(per_layer[0] / 1e9, 2) == 0.19
    assert cfg.tp_shard(2).d_ff == cfg.d_ff // 2 and cfg.tp_shard(2).n_experts == cfg.n_experts
    with pytest.raises(ValueError, match="expert d_ff"):
        dataclasses.replace(cfg, d_ff=96).tp_shard(2)


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_tree_shards_by_d_ff(name):
    """``init_params(tp=(r, 2))`` draws the single-rank tree one expert at a
    time and keeps rank r's slice: ``up`` / ``gate`` split their last axis,
    ``down`` its ``d_ff`` axis (-2), router replicated; the shards put
    together are the tree, and ``shard_params`` cuts a numpy tree the same
    way."""
    arch, over = MOE[name]
    cfg = moe_config(arch, dict(over, n_heads=4, n_kv_heads=2))
    model = Model(cfg)
    full = model.init_params(device="cpu", seed=3)
    shards = [model.init_params(device="cpu", seed=3, tp=(r, 2)) for r in range(2)]
    np_full = jax.tree.map(lambda t: t.numpy(), full, is_leaf=lambda t: isinstance(t, torch.Tensor))
    i = _moe_layer(cfg)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert (shard_axis("up", "w"), shard_axis("down", "w"), shard_axis("router", "w")) == \
        (-1, -2, None)
    for key, axis in (("up", -1), ("gate", -1), ("down", -2), ("router", None)):
        parts = [s["layers"][i]["moe"][key]["w"] for s in shards]
        whole = full["layers"][i]["moe"][key]["w"]
        np_parts = [shard_params(np_full, cfg, r, 2)["layers"][i]["moe"][key]["w"]
                    for r in range(2)]
        if axis is None:
            assert all(torch.equal(p, whole) for p in parts)
            continue
        assert parts[0].shape[0] == E and parts[0].shape[axis] == f // 2
        assert torch.equal(torch.cat(parts, dim=axis), whole)
        np.testing.assert_array_equal(np.concatenate(np_parts, axis=axis), whole.numpy())
    assert full["layers"][i]["moe"]["down"]["w"].shape == (E, f, d)
    if cfg.n_shared_experts:
        down = [s["layers"][i]["moe"]["shared0"]["down"]["w"] for s in shards]
        assert torch.equal(torch.cat(down), full["layers"][i]["moe"]["shared0"]["down"]["w"])
