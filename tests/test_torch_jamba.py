"""The port's jamba-v0.1-52b (Mamba + MoE hybrid) against the reference, on
the CPU, fp32, identical weights and inputs.

Reduced jamba is built with ``n_layers=3``: ``[mamba, mamba + MoE, attn]``
(with the default 2 layers it has no attention layer), d_model 256, d_inner
512, d_state 8, dt_rank 8, 4 experts top-2, 4 query heads over 4 kv heads
at hd 32. Weights are the reference's ``init_params`` through
``params_from_numpy``.

Held, rel-L2 <= 1e-5 in fp32 unless stated (the port's doubling scan adds
the same terms as the reference's ``lax.associative_scan`` in another
order; measured about 1e-6): ``causal_conv`` and the chunked scan against
the reference's ``_causal_conv`` and ``_scan_chunks`` at 64, 100 and 7
tokens (7 is prime: the reference runs 1-token chunks, the port one chunk
of 7; 100: the reference runs 4-token chunks, the port 64 and a padded
36); ``mamba()`` prefill, a prefill split in two that carries the cache,
and token-by-token decode; ``apply_layer`` on every layer (the MoE Mamba
one too); ``Model.prefill`` logits and every layer's cache; one
``decode_step_paged`` on fp4 pools with recurrent state, logits and the
new ``rec``; greedy tokens, steps and dispatches of the whole-prompt
engine identical to the reference Engine's under the gated
``simulate_tp=2`` context on bf16 and fp4 pools, and through a preemption;
the refusals (``prefill_chunk``, ``token_budget``, ``prefix_cache``,
sequence-sharded pools, the chunk and mixed steps); ``param_count`` at
full size against the tree's leaves (51.57 B) and the reference's 49.46 B.
``tests/test_torch_families.py::test_param_count_matches_reference`` holds
the port's count to the reference's plus exactly what the reference leaves
out of a Mamba layer.
The 2-rank TP case rides in ``tests/test_torch_tp.py``'s one spawn. TF32
is off for torch matmuls in this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.formats import KVCacheSpec as JKVCacheSpec
from repro.core.tp import TPContext as JTPContext
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.models.transformer import apply_layer as j_apply_layer
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.formats import KVCacheSpec
from repro_torch.core.tp import TPContext
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.model import Model, param_shapes
from repro_torch.models.transformer import apply_layer
from repro_torch.serving import Engine
from repro_torch.serving.kv_cache import init_paged_state, recurrent_state_bytes
from tests.conftest import fp32_reduced
from tests.test_torch_model import _pools as _model_pools
from tests.test_torch_prefill import _check_pools
from tests.test_torch_serving import (  # noqa: F401  (a fixture)
    reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "jamba-v0.1-52b"
JAMBA_ENGINE = dict(max_slots=2, max_len=64, block_size=16)   # whole-prompt by default
REL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _close(got, ref, tol=REL):
    assert _rel(got, ref) <= tol


@pytest.fixture(scope="module")
def models():
    cfg_j = fp32_reduced(ARCH, n_layers=3)
    cfg_t = dataclasses.replace(reduced_config(get_config(ARCH), n_layers=3), dtype="float32")
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    model_j = JModel(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    params_j = jax.tree.map(jnp.asarray, tree)
    return cfg_t, model_j, params_j, Model(cfg_t), params_from_numpy(tree, cfg_t, "cpu")


def test_reduced_jamba_schedule(models):
    cfg, _, _, _, params_t = models
    assert [(s.kind, s.moe) for s in cfg.layers] == [("mamba", False), ("mamba", True),
                                                     ("attn", False)]
    assert (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank, cfg.n_experts, cfg.top_k) == \
        (512, 8, 8, 4, 2)
    assert "mlp" in params_t["layers"][0] and "moe" in params_t["layers"][1]
    assert params_t["layers"][0]["core"]["A_log"].shape == (512, 8)


def _scan_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    di, N = cfg.ssm_d_inner, cfg.ssm_d_state
    dt = np.log1p(np.exp(rng.normal(size=(2, S, di)) - 2.0)).astype(np.float32)
    x, Bm, Cm = (rng.normal(size=s).astype(np.float32)
                 for s in ((2, S, di), (2, S, N), (2, S, N)))
    A = -np.exp(np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (di, N))))
    h0 = rng.normal(size=(2, di, N)).astype(np.float32)
    return dt, x, Bm, Cm, A.astype(np.float32), h0


@pytest.mark.parametrize("S", [64, 100, 7])
def test_conv_and_scan_match_reference(models, S):
    """``causal_conv`` with and without history, and the chunked scan, at
    the reference's chunk choice (halved until it divides S)."""
    cfg, _, params_j, _, params_t = models
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.ssm_d_inner)).astype(np.float32)
    hist = rng.normal(size=(2, cfg.ssm_d_conv - 1, cfg.ssm_d_inner)).astype(np.float32)
    core_j, core_t = params_j["layers"][0]["core"], params_t["layers"][0]["core"]
    for h in (None, hist):
        ref = jssm._causal_conv(jnp.asarray(x), core_j["conv_w"], core_j["conv_b"],
                                None if h is None else jnp.asarray(h))
        got = ssm.causal_conv(torch.from_numpy(x), core_t["conv_w"], core_t["conv_b"],
                              None if h is None else torch.from_numpy(h))
        _close(got.numpy(), ref)
    dt, x, Bm, Cm, A, h0 = _scan_inputs(cfg, S, S + 1)
    chunk = jssm._CHUNK
    while S % chunk:
        chunk //= 2
    assert chunk == {64: 64, 100: 4, 7: 1}[S]
    y_j, h_j = jssm._scan_chunks(*(jnp.asarray(a) for a in (dt, x, Bm, Cm, A, h0)), chunk)
    y_t, h_t = ssm.selective_scan(*(torch.from_numpy(a) for a in (dt, x, Bm, Cm, A, h0)))
    _close(y_t.numpy(), y_j)
    _close(h_t.numpy(), h_j)


def _mamba_ref(params_j, cfg_j, u, cache=None, decode=False):
    return jssm.mamba(JTPContext(mesh=None), params_j, jnp.asarray(u), cfg_j, cache=cache,
                      decode=decode)


def _cache_close(got, ref):
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_mamba_block_prefill_split_and_decode(models):
    """One prompt of 37 tokens (B 2): whole; as 23 + 14 with the cache
    carried; as 33 then 4 single-token decode steps."""
    cfg, model_j, params_j, _, params_t = models
    cfg_j = model_j.cfg
    core_j, core_t = params_j["layers"][1]["core"], params_t["layers"][1]["core"]
    u = np.random.default_rng(7).normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    ctx = TPContext()
    c0_j = jssm.init_mamba_cache(cfg_j, 2)
    c0_t = ssm.init_mamba_cache(cfg, 2, device="cpu")
    assert c0_t.conv.dtype == c0_t.ssm.dtype == torch.float32
    ref, rc = _mamba_ref(core_j, cfg_j, u, c0_j)
    got, gc = ssm.mamba(ctx, core_t, torch.from_numpy(u), cfg, cache=c0_t)
    _close(got.numpy(), ref)
    _cache_close(gc, rc)
    # no cache at all: the same output
    _close(ssm.mamba(ctx, core_t, torch.from_numpy(u), cfg)[0].numpy(), ref)
    # split in two, the cache carried
    out1, c1 = ssm.mamba(ctx, core_t, torch.from_numpy(u[:, :23]), cfg, cache=c0_t)
    out2, c2 = ssm.mamba(ctx, core_t, torch.from_numpy(u[:, 23:]), cfg, cache=c1)
    _close(torch.cat([out1, out2], 1).numpy(), ref)
    _cache_close(c2, rc)
    # prefill 33, then decode 4 tokens one at a time
    out, c = ssm.mamba(ctx, core_t, torch.from_numpy(u[:, :33]), cfg, cache=c0_t)
    outs = [out]
    for t in range(33, 37):
        o, c = ssm.mamba(ctx, core_t, torch.from_numpy(u[:, t:t + 1]), cfg, cache=c, decode=True)
        outs.append(o)
    _close(torch.cat(outs, 1).numpy(), ref)
    _cache_close(c, rc)
    with pytest.raises(ValueError, match="one token and a cache"):
        ssm.mamba(ctx, core_t, torch.from_numpy(u[:, :2]), cfg, cache=c, decode=True)


@pytest.mark.parametrize("compressed", [False, True], ids=["dense-ctx", "simulate_tp2"])
def test_apply_layer_matches_reference(models, compressed):
    """Every layer on x (2, 40, d): 80 tokens, so the MoE dispatches;
    under ``simulate_tp=2`` the Mamba out-projection is split into two
    compressed partials (rel-L2 5e-2: an fp4 midpoint may round either way
    in one framework)."""
    from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
    from repro_torch.core.policy import PAPER_DEFAULT

    cfg, model_j, params_j, _, params_t = models
    ctx_j = (JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2) if compressed
             else JTPContext(mesh=None))
    ctx_t = TPContext(policy=PAPER_DEFAULT, simulate_tp=2) if compressed else TPContext()
    x = np.random.default_rng(3).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    for i, spec in enumerate(cfg.layers):
        ref, _, _ = j_apply_layer(ctx_j, model_j.cfg, spec, params_j["layers"][i],
                                  jnp.asarray(x), pos=jnp.int32(0))
        got, _ = apply_layer(ctx_t, cfg, spec, params_t["layers"][i], torch.from_numpy(x),
                             pos=0)
        _close(got.numpy(), ref, 5e-2 if compressed else REL)


def test_prefill_and_decode_step_match_reference(models):
    """``Model.prefill`` of two 21-token prompts (exact length): logits and
    every layer's cache; then one ``decode_step_paged`` of 3 slots over fp4
    pools (random wire bytes, the same in both) with random recurrent
    state: logits, the pools and the new ``rec``."""
    cfg, model_j, params_j, model_t, params_t = models
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    logits_j, cache_j = model_j.prefill(JTPContext(mesh=None), params_j,
                                        {"tokens": jnp.asarray(tokens)},
                                        model_j.init_cache(2, 21, jnp.float32))
    logits_t, cache_t = model_t.prefill(TPContext(), params_t, {"tokens": torch.from_numpy(tokens)},
                                        model_t.init_cache(2, 21, torch.float32, "cpu"))
    _close(logits_t.numpy(), logits_j)
    for got, ref in zip(cache_t["layers"], cache_j["layers"]):
        _cache_close(got, ref)

    fmt = "fp4_e2m1"
    attn_only = dataclasses.replace(cfg, n_layers=1, layers=cfg.layers[2:])
    pools_j, pools_t = _model_pools(attn_only, fmt, seed=1)
    rng = np.random.default_rng(9)
    rec_np = [(rng.normal(size=(3, cfg.ssm_d_conv - 1, cfg.ssm_d_inner)).astype(np.float32),
               rng.normal(size=(3, cfg.ssm_d_inner, cfg.ssm_d_state)).astype(np.float32))
              for _ in range(2)]
    state_j = {"pools_k": pools_j[:1], "pools_v": pools_j[1:],
               "rec": [jssm.MambaCache(jnp.asarray(c), jnp.asarray(s)) for c, s in rec_np]}
    state_t = {"pools_k": pools_t[:1], "pools_v": pools_t[1:],
               "rec": [ssm.MambaCache(torch.from_numpy(c.copy()), torch.from_numpy(s.copy()))
                       for c, s in rec_np]}
    held = [t for c in state_t["rec"] for t in c]
    toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    lengths = np.array([37, 52, 0], np.int32)
    logits_j, new_j = model_j.decode_step_paged(
        JTPContext(mesh=None), params_j, jnp.asarray(toks), state_j, jnp.asarray(tables),
        jnp.asarray(lengths), cache_spec=JKVCacheSpec.parse(fmt))
    logits_t, new_t = model_t.decode_step_paged(
        TPContext(), params_t, torch.from_numpy(toks), state_t, torch.from_numpy(tables),
        torch.from_numpy(lengths), cache_spec=KVCacheSpec.parse(fmt))
    _close(logits_t.numpy(), logits_j)
    _check_pools(new_t, new_j, fmt, [0])
    for got, ref in zip(new_t["rec"], new_j["rec"]):
        _cache_close(got, ref)
    # the recurrent caches updated in place (a captured step writes them)
    assert [t.data_ptr() for c in new_t["rec"] for t in c] == [t.data_ptr() for t in held]
    assert not np.array_equal(held[1].numpy(), rec_np[0][1])


def test_paged_state_holds_recurrent_caches(models):
    """``init_paged_state``: pools for the attention layer only, one fp32
    ``MambaCache`` of ``n_slots`` rows per Mamba layer (bf16 pools or not),
    sized as the reference's ``cache_bytes`` counts them; zeroed in place."""
    from repro.serving.kv_cache import cache_bytes as j_cache_bytes

    cfg = models[0]
    state = init_paged_state(cfg, 3, 9, 16, torch.bfloat16, cache_spec="fp4_e2m1",
                             device="cpu")
    assert len(state["pools_k"]) == len(state["pools_v"]) == 1 and len(state["rec"]) == 2
    for c in state["rec"]:
        assert c.conv.shape == (3, 3, 512) and c.ssm.shape == (3, 512, 8)
        assert c.conv.dtype == c.ssm.dtype == torch.float32
        c.ssm.fill_(1.0)
    rec_bytes = sum(t.numel() * t.element_size() for c in state["rec"] for t in c)
    assert recurrent_state_bytes(cfg, 3) == rec_bytes
    only_mamba = fp32_reduced(ARCH, n_layers=2)
    assert j_cache_bytes(only_mamba, 3, 64) == recurrent_state_bytes(only_mamba, 3)
    from repro_torch.serving.kv_cache import zero_paged_state

    ptrs = [t.data_ptr() for c in state["rec"] for t in c]
    zero_paged_state(state)
    assert all(int(t.count_nonzero()) == 0 for c in state["rec"] for t in c)
    assert ptrs == [t.data_ptr() for c in state["rec"] for t in c]


def _traffic(vocab):
    """(prompt, max_new_tokens): prompts of 12 and 20 tokens, two of each,
    4..7 new tokens (two exact-length prefill programs)."""
    return [(((np.arange(n, dtype=np.int32) * 11 + i) % vocab).astype(np.int32), 4 + i)
            for i, n in enumerate((12, 20, 12, 20))]


@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_greedy_tokens_identical_to_reference_engine(models, cache,
                                                    reference_copies_host_arrays):
    """The whole-prompt engine (the default for a recurrent stack), gated
    ``simulate_tp=2``: tokens, steps and dispatches as the reference's; one
    step program per exact prompt length."""
    eng_j, eng_t, _ = serve_both(models, _traffic(models[0].vocab_size), gated=True,
                                 cache_spec=cache, **JAMBA_ENGINE)
    assert eng_t.prefill_chunk == eng_j.prefill_chunk == 0
    assert eng_t.token_budget == eng_j.token_budget == 0
    assert eng_t.prefill_cache_size() == eng_j.prefill_cache_size() == 2
    assert eng_t.decode_cache_size() == 1


def test_preemption_identical_to_reference_engine(models, reference_copies_host_arrays):
    """Two 12-token prompts on 3 usable blocks: the later request is
    preempted when both cross 16 tokens, and re-prefills its prompt plus
    the tokens it generated (a new exact length)."""
    vocab = models[0].vocab_size
    traffic = [(((np.arange(12, dtype=np.int32) * 5 + i) % vocab).astype(np.int32), 8)
               for i in range(2)]
    _, eng_t, _ = serve_both(models, traffic, gated=True, cache_spec="bf16", n_blocks=4,
                             **JAMBA_ENGINE)
    assert eng_t.stats.summary()["n_preemptions"] >= 1


def test_refusals(models, monkeypatch):
    """The reference's errors for the chunked path on a recurrent stack, and
    an engine on sequence-sharded pools (half the blocks, the recurrent state
    whole)."""
    cfg, model_j, params_j, model_t, params_t = models
    kw = dict(JAMBA_ENGINE, device="cpu")
    for extra, msg in ((dict(prefill_chunk=16), "requires a pure-attention"),
                       (dict(token_budget=18), "rides on chunked prefill"),
                       (dict(prefix_cache=True), "rides on chunked prefill")):
        with pytest.raises(ValueError, match=msg):
            Engine(model_t, params_t, TPContext(), **kw, **extra)
    with pytest.raises(ValueError, match="layer 0 is 'mamba'"):
        model_t.prefill_chunk(TPContext(), params_t, torch.zeros(1, 4, dtype=torch.int32),
                              None, None, 0, 4)
    with pytest.raises(ValueError, match="mixed_step requires a pure-attention"):
        model_t.mixed_step(TPContext(), params_t, *([None] * 9))
    # sequence-sharded pools are served: half the pool blocks on a rank, the
    # recurrent state of every slot whole
    monkeypatch.setattr(TPContext, "kv_shards", property(lambda self: 2))
    eng = Engine(model_t, params_t, TPContext(), **kw)
    assert eng.kv_shards == 2 and eng.n_blocks % 2 == 0
    assert all(t.shape[0] == eng.n_blocks // 2 for t in eng._state["pools_k"])
    assert eng.rec_state_bytes() == sum(t.numel() * t.element_size()
                                        for c in eng._state["rec"] for t in c)


def test_param_count_at_full_size():
    """51.57 B parameters: the leaves of the tree the port builds but the
    final norm, which neither package counts for any family (the reference
    counts 49.46 B, missing the 12 non-MoE Mamba layers' MLPs, 2.114 B, and
    two d_inner vectors a Mamba layer); the active count takes 14 of 16
    experts out of every MoE layer, as the tree holds them."""
    cfg, ref = get_config(ARCH), j_get_config(ARCH)
    leaves = lambda tree: (sum(leaves(v) for v in tree.values()) if isinstance(tree, dict)
                           else sum(leaves(v) for v in tree) if isinstance(tree, list)
                           else int(np.prod(tree)))
    tree = param_shapes(cfg)
    assert cfg.param_count() == leaves(tree) - leaves(tree["final_norm"])
    assert round(cfg.param_count() / 1e9, 2) == 51.57
    assert round(ref.param_count() / 1e9, 2) == 49.46
    dense_mamba = sum(1 for s in cfg.layers if s.kind == "mamba" and not s.moe)
    assert dense_mamba == 12
    mlps = dense_mamba * 3 * cfg.d_model * cfg.d_ff
    assert round(mlps / 1e9, 3) == 2.114
    mamba = sum(1 for s in cfg.layers if s.kind == "mamba")
    assert cfg.param_count() - ref.param_count() == mlps + mamba * 2 * cfg.ssm_d_inner
    experts = sum(leaves(lp["moe"][k]) for lp in tree["layers"] if "moe" in lp
                  for k in ("up", "gate", "down"))
    E, k = cfg.n_experts, cfg.top_k
    assert cfg.active_param_count() == cfg.param_count() - experts * (E - k) // E
    assert cfg.active_param_count() - ref.active_param_count() == \
        cfg.param_count() - ref.param_count()
    local = cfg.tp_shard(4)
    assert (local.ssm_d_inner, local.dt_rank, local.d_model) == (2048, 256, 4096)
    with pytest.raises(ValueError, match="ssm_d_inner"):
        dataclasses.replace(cfg, ssm_expand=1, d_model=4097).tp_shard(2)


def test_mamba_tree_shards_by_d_inner(models):
    """``init_params(tp=(r, 2))`` and ``shard_params``: every Mamba leaf
    split by ``d_inner`` as the reference's ``mamba_specs`` shards it (rows
    of ``x_proj``, ``out_proj`` and ``A_log``; the last axis of the rest);
    the shards put together are the tree, and each shard's shapes are the
    rank-local config's."""
    cfg = models[0]
    model = Model(cfg)
    full = model.init_params(device="cpu", seed=3)
    shards = [model.init_params(device="cpu", seed=3, tp=(r, 2)) for r in range(2)]
    np_full = jax.tree.map(lambda t: t.numpy(), full, is_leaf=lambda t: isinstance(t, torch.Tensor))
    core = full["layers"][0]["core"]
    np.testing.assert_allclose(core["A_log"].float().numpy(),
                               np.log(np.broadcast_to(np.arange(1, 9), (512, 8))), rtol=1e-6)
    np.testing.assert_allclose(core["dt_proj"]["b"].float().numpy(),
                               np.log(np.expm1(0.01)), rtol=1e-6)
    assert torch.equal(core["D"], torch.ones(512)) and torch.equal(core["conv_b"],
                                                                 torch.zeros(512))
    axes = {("in_x", "w"): -1, ("in_z", "w"): -1, ("conv_w",): -1, ("conv_b",): -1,
            ("x_proj", "w"): -2, ("dt_proj", "w"): -1, ("dt_proj", "b"): -1, ("A_log",): -2,
            ("D",): -1, ("out_proj", "w"): -2}
    get = lambda tree, path: tree[path[0]] if len(path) == 1 else tree[path[0]][path[1]]
    local = param_shapes(cfg.tp_shard(2))["layers"][0]["core"]
    for path, axis in axes.items():
        parts = [get(s["layers"][0]["core"], path) for s in shards]
        np_parts = [get(shard_params(np_full, cfg, r, 2)["layers"][0]["core"], path)
                    for r in range(2)]
        whole = get(core, path)
        assert tuple(parts[0].shape) == tuple(get(local, path))
        assert parts[0].shape[axis] * 2 == whole.shape[axis]
        assert torch.equal(torch.cat(parts, dim=axis), whole)
        np.testing.assert_array_equal(np.concatenate(np_parts, axis=axis), whole.numpy())
