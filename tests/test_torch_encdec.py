"""The port's encoder-decoder, whisper-medium, against the reference on the
CPU: fp32, TF32 off, identical weights (the reference's ``init_params``
through ``params_from_numpy``) and identical numpy encoder frames given to
both packages.

Reduced whisper: 2 encoder and 2 decoder layers at d_model 256, 4 heads
over 4 kv heads at hd 32, a gelu MLP, 64 encoder frames. Held, rel-L2 <=
1e-5 in fp32: ``attention()`` without a causal mask and with ``cross_kv``;
``_encode`` (RoPE at frame positions 0..63, as the reference's) and
``_cross_kv``; ``Model.prefill`` logits, every layer's cache and the cross
K/V; one ``decode_step_paged`` over fp4 pools with per-slot cross state
(logits, the pools it appends to; the cross state read, not written); under
gated ``simulate_tp=2`` the prefill's logits within 5e-2 (the bound
``tests/test_torch_prefill.py`` states). ``init_paged_state`` holds the
cross K/V dense beside fp4 pools, sized as the reference's ``cache_bytes``
counts it and zeroed in place. The whole-prompt engine's greedy tokens,
steps and dispatches equal the reference Engine's on bf16 and fp4 pools,
dense and gated, frames sliced per request; the insert writes each slot's
cross K/V rows in place (a captured decode step keeps reading those
addresses); through a preemption and a hard recovery (``die@3`` under the
supervisor). The refusals: ``prefill_chunk``, ``token_budget``,
``prefix_cache``, sequence-sharded pools, the chunk and mixed steps; on a
TP group of 2 ranks the rank's shapes, the cross K/V at the rank's kv
heads. ``param_count`` counts the tree (the reference's count plus
``enc_norm`` and each cross-attention's norm).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.formats import KVCacheSpec as JKVCacheSpec
from repro.core.tp import TPContext as JTPContext
from repro.models import attention as jattn
from repro.models.attention import KVCache as JKVCache
from repro.serving.kv_cache import cache_bytes as j_cache_bytes
from repro_torch.configs import get_config
from repro_torch.core.formats import KVCacheSpec
from repro_torch.core.tp import TPContext
from repro_torch.models import attention as tattn
from repro_torch.models.model import param_shapes
from repro_torch.serving import Engine, Request
from repro_torch.serving.kv_cache import (
    cross_state_bytes, init_paged_state, paged_cache_bytes, zero_paged_state,
)
from tests.test_torch_faults import run_both
from tests.test_torch_frontends import (
    GATED_REL, WHOLE, both_prefill, build_models, check_refusals, close, leaves, stub_arrays,
    whole_traffic,
)
from tests.test_torch_model import _pools as model_pools
from tests.test_torch_prefill import _check_pools
from tests.test_torch_serving import (  # noqa: F401  (a fixture)
    contexts, reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def models():
    return build_models(ARCH)


def _frames(cfg, batch, seed):
    return stub_arrays(cfg, batch, seed)["encoder_frames"]


def test_reduced_whisper(models):
    cfg, _, _, _, params_t = models
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.encoder_seq, cfg.activation) == \
        (2, 2, 64, "gelu")
    assert len(params_t["enc_layers"]) == len(params_t["xattn"]) == 2
    assert "gate" not in params_t["enc_layers"][0]["mlp"]


@pytest.mark.parametrize("mode", ["non-causal", "cross"])
def test_attention_matches_reference(models, mode):
    """The encoder's attention (every frame sees every frame, RoPE at
    positions 0..S-1) and the decoder's cross-attention over flat (B, F,
    kv_dim) encoder K/V (q through ``wq``, no RoPE)."""
    cfg, model_j, params_j, _, params_t = models
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    kw_j, kw_t = dict(causal=False), dict(causal=False)
    core_j, core_t = params_j["enc_layers"][0]["core"], params_t["enc_layers"][0]["core"]
    if mode == "cross":
        k, v = (rng.normal(size=(2, 40, cfg.kv_dim)).astype(np.float32) for _ in range(2))
        kw_j = dict(cross_kv=JKVCache(jnp.asarray(k), jnp.asarray(v)))
        kw_t = dict(cross_kv=tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v)))
        core_j, core_t = params_j["xattn"][1]["core"], params_t["xattn"][1]["core"]
    ref, _ = jattn.attention(JTPContext(mesh=None), core_j, jnp.asarray(x), model_j.cfg,
                             pos=jnp.int32(0), **kw_j)
    got, _ = tattn.attention(TPContext(), core_t, torch.from_numpy(x), cfg, pos=0, **kw_t)
    close(got.numpy(), ref)
    if mode == "non-causal":   # the first query sees the last key: not the causal result
        causal, _ = tattn.attention(TPContext(), core_t, torch.from_numpy(x), cfg, pos=0)
        assert not torch.allclose(causal[:, 0], got[:, 0])


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "simulate_tp2"])
def test_encoder_and_cross_kv_match_reference(models, gated):
    """``_encode`` over 64 frames and each decoder layer's ``_cross_kv``;
    under ``simulate_tp=2`` the encoder's ``wo`` and ``down`` are compressed
    reductions."""
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j, ctx_t = contexts(gated)
    frames = _frames(cfg, 2, 2)
    enc_j = model_j._encode(ctx_j, params_j, jnp.asarray(frames))
    enc_t = model_t._encode(ctx_t, params_t, torch.from_numpy(frames))
    close(enc_t.numpy(), enc_j, GATED_REL if gated else 1e-5)
    kv_j = model_j._cross_kv(ctx_j, params_j, enc_j)
    kv_t = model_t._cross_kv(ctx_t, params_t, torch.from_numpy(np.array(enc_j)))
    assert len(kv_t) == cfg.n_layers
    for got, ref in zip(kv_t, kv_j):
        assert got.k.shape == (2, cfg.encoder_seq, cfg.kv_dim)
        close(got.k.numpy(), ref.k)
        close(got.v.numpy(), ref.v)


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "simulate_tp2"])
def test_prefill_matches_reference(models, gated):
    """Two 21-token decoder prompts over 64 frames: logits, every layer's
    self-attention cache and the cross K/V the prefill returns."""
    cfg = models[0]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    (logits_j, cache_j), (logits_t, cache_t) = both_prefill(
        models, tokens, {"encoder_frames": _frames(cfg, 2, 4)}, gated)
    close(logits_t.numpy(), logits_j, GATED_REL if gated else 1e-5)
    assert cache_t["pos"] == int(cache_j["pos"]) == 21
    if not gated:
        for got, ref in zip(cache_t["layers"] + cache_t["cross"],
                            cache_j["layers"] + cache_j["cross"]):
            close(got.k.numpy(), ref.k)
            close(got.v.numpy(), ref.v)


def test_decode_step_with_cross_state_matches_reference(models):
    """One ``decode_step_paged`` of 3 slots over fp4 pools (the same random
    wire bytes in both) with random per-slot cross K/V: logits, the pools it
    appends to; the cross state is read, not written."""
    cfg, model_j, params_j, model_t, params_t = models
    fmt = "fp4_e2m1"
    pools_j, pools_t = model_pools(cfg, fmt, seed=1)
    rng = np.random.default_rng(9)
    cross = [rng.normal(size=(3, cfg.encoder_seq, cfg.kv_dim)).astype(np.float32)
             for _ in range(2 * cfg.n_layers)]
    L = cfg.n_layers
    state_j = {"pools_k": pools_j[:L], "pools_v": pools_j[L:], "rec": [],
               "cross_k": [jnp.asarray(c) for c in cross[:L]],
               "cross_v": [jnp.asarray(c) for c in cross[L:]]}
    state_t = {"pools_k": pools_t[:L], "pools_v": pools_t[L:], "rec": [],
               "cross_k": [torch.from_numpy(c.copy()) for c in cross[:L]],
               "cross_v": [torch.from_numpy(c.copy()) for c in cross[L:]]}
    toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    lengths = np.array([37, 52, 0], np.int32)
    logits_j, new_j = model_j.decode_step_paged(
        JTPContext(mesh=None), params_j, jnp.asarray(toks), state_j, jnp.asarray(tables),
        jnp.asarray(lengths), cache_spec=JKVCacheSpec.parse(fmt))
    logits_t, new_t = model_t.decode_step_paged(
        TPContext(), params_t, torch.from_numpy(toks), state_t, torch.from_numpy(tables),
        torch.from_numpy(lengths), cache_spec=KVCacheSpec.parse(fmt))
    close(logits_t.numpy(), logits_j)
    _check_pools(new_t, new_j, fmt, range(L))
    for got, want in zip(new_t["cross_k"] + new_t["cross_v"], cross):
        np.testing.assert_array_equal(got.numpy(), want)
    # the cross-attention reads the state: other cross K/V, other logits
    state_t["cross_v"][0].mul_(2.0)
    again, _ = model_t.decode_step_paged(
        TPContext(), params_t, torch.from_numpy(toks), state_t, torch.from_numpy(tables),
        torch.from_numpy(lengths), cache_spec=KVCacheSpec.parse(fmt))
    assert not torch.allclose(again, logits_t)


def test_paged_state_holds_cross_kv(models):
    """``init_paged_state``: per decoder layer ``(n_slots, encoder_seq,
    kv_dim)`` cross K and V in the dense dtype beside fp4 pools; their bytes
    are the reference's ``cache_bytes`` term; zeroed in place."""
    cfg = models[0]
    state = init_paged_state(cfg, 3, 9, 16, torch.bfloat16, cache_spec="fp4_e2m1",
                             device="cpu")
    assert len(state["cross_k"]) == len(state["cross_v"]) == cfg.n_layers
    for t in state["cross_k"] + state["cross_v"]:
        assert t.shape == (3, cfg.encoder_seq, cfg.kv_dim) and t.dtype == torch.bfloat16
        t.fill_(1.0)
    held = sum(t.numel() * t.element_size() for t in state["cross_k"] + state["cross_v"])
    assert cross_state_bytes(cfg, 3) == held
    assert j_cache_bytes(models[1].cfg, 3, 0) == held   # no self-attention positions
    assert paged_cache_bytes(cfg, 9, 16, n_slots=3) == paged_cache_bytes(cfg, 9, 16) + held
    assert cross_state_bytes(get_config("llama2-7b"), 3) == 0
    ptrs = [t.data_ptr() for t in state["cross_k"] + state["cross_v"]]
    zero_paged_state(state)
    assert all(int(t.count_nonzero()) == 0 for t in state["cross_k"] + state["cross_v"])
    assert ptrs == [t.data_ptr() for t in state["cross_k"] + state["cross_v"]]


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "gated-simulate_tp2"])
@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_greedy_tokens_identical_to_reference_engine(models, cache, gated,
                                                    reference_copies_host_arrays):
    """Whole-prompt (the only scheduler for an encoder-decoder), frames
    sliced per request: tokens, steps, dispatches; one program per text
    bucket. The insert writes the slots' cross K/V rows in place: the last
    request's rows hold its encoder's K/V (the reference's ``_cross_kv`` of
    its ``_encode``), at the addresses the engine was built with."""
    cfg, model_j, params_j, _, _ = models
    traffic = whole_traffic(cfg.vocab_size)
    frames = _frames(cfg, len(traffic), 7)
    eng_j, eng_t, _ = serve_both(models, traffic, gated=gated, cache_spec=cache,
                                 extra_inputs={"encoder_frames": frames}, **WHOLE)
    assert eng_t.prefill_chunk == eng_j.prefill_chunk == 0
    assert eng_t.prefill_cache_size() == eng_j.prefill_cache_size() == 2
    state = eng_t._state
    ptrs = [t.data_ptr() for t in state["cross_k"] + state["cross_v"]]
    eng_t.run([Request(prompt=traffic[0][0].copy(), max_new_tokens=1)],
              extra_inputs={"encoder_frames": frames[3:]})
    assert [t.data_ptr() for t in state["cross_k"] + state["cross_v"]] == ptrs
    if not gated:
        ctx_j = contexts(False)[0]
        ref = model_j._cross_kv(ctx_j, params_j,
                                model_j._encode(ctx_j, params_j, jnp.asarray(frames[3:])))
        for layer, kv in enumerate(ref):
            close(state["cross_k"][layer][0].numpy(), kv.k[0])
            close(state["cross_v"][layer][0].numpy(), kv.v[0])


def test_preemption_identical_to_reference_engine(models, reference_copies_host_arrays):
    """Two 12-token prompts on 3 usable blocks: both cross 16 tokens, the
    later one is preempted and re-prefilled over its own frames."""
    cfg = models[0]
    traffic = [(((np.arange(12, dtype=np.int32) * 5 + i) % cfg.vocab_size), 8)
               for i in range(2)]
    _, eng_t, _ = serve_both(models, traffic, gated=True, cache_spec="fp4_e2m1", n_blocks=4,
                             extra_inputs={"encoder_frames": _frames(cfg, 2, 8)}, **WHOLE)
    assert eng_t.stats.summary()["n_preemptions"] >= 1


def test_hard_recovery_like_reference(models, reference_copies_host_arrays):
    """``die@3`` under the supervisor on bf16 pools: hard recovery (the
    cross state zeroed with the pools), the replay over the unfinished
    requests' own frames gives the fault-free tokens."""
    cfg = models[0]
    traffic = whole_traffic(cfg.vocab_size)
    extra = {"encoder_frames": _frames(cfg, len(traffic), 10)}
    eng = Engine(models[3], models[4], TPContext(), cache_dtype=torch.float32, device="cpu",
                 **WHOLE)
    free = [r.output.tolist() for r in eng.run(
        [Request(prompt=p.copy(), max_new_tokens=n) for p, n in traffic], extra_inputs=extra)]
    _, reqs_t, _, _, _, sup_t = run_both(models, traffic, plan="die@3", supervised=True,
                                         extra_inputs=extra, **WHOLE)
    assert [(e.error, e.mode) for e in sup_t.events] == [("EngineDead", "hard")]
    assert [r.output.tolist() for r in reqs_t] == free


def test_refusals(models, monkeypatch):
    """The engine's and ``check_refusals``' refusals, and the reference's
    errors from the chunk and mixed steps."""
    cfg, _, _, model_t, params_t = models
    with pytest.raises(ValueError, match="prefill_chunk does not thread encoder"):
        model_t.prefill_chunk(TPContext(), params_t, torch.zeros(1, 4, dtype=torch.int32),
                              None, None, 0, 4)
    with pytest.raises(ValueError, match="mixed_step does not thread encoder"):
        model_t.mixed_step(TPContext(), params_t, *([None] * 9))
    check_refusals(models, {"encoder_frames": _frames(cfg, 1, 0)}, monkeypatch)


def test_param_count_at_full_size():
    """0.81 B parameters: the tree's leaves but the final norm (which neither
    package counts); the reference's count plus ``enc_norm`` and the 24
    cross-attention norms, which it leaves out."""
    cfg, ref = get_config(ARCH), j_get_config(ARCH)
    tree = param_shapes(cfg)
    assert cfg.param_count() == leaves(tree) - leaves(tree["final_norm"])
    norms = leaves(tree["enc_norm"]) + sum(leaves(x["ln"]) for x in tree["xattn"])
    assert cfg.param_count() - ref.param_count() == norms == 25 * cfg.d_model
    assert round(cfg.param_count() / 1e9, 2) == 0.81
