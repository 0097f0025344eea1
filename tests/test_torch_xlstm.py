"""The port's xlstm-125m (mLSTM + sLSTM) against the reference, on the CPU,
fp32, identical weights and inputs.

Reduced xlstm is the reference's ``reduced_config``: ``[mlstm, slstm]``,
d_model 256, 4 heads (mLSTM d_inner 512, dh 128; sLSTM dh 64, FF 341),
vocab 512. Weights are the reference's ``init_params`` through
``params_from_numpy``.

Held, rel-L2 <= 1e-5 in fp32 unless stated (the port cuts a prompt into
128-token chunks and a shorter last one where the reference halves its
chunk until it divides the length: the same closed form, summed in
another order; the sLSTM's input projections run for every position in one
product): each block's prefill at 16, 13 (prime: the reference runs
1-token chunks) and 200 tokens (the reference 8-token chunks, the port 128
+ 72), output and cache, then one decode step from that cache, which also
equals the last position of a prefill one token longer;
``Model.prefill`` logits and caches and one ``decode_step_paged`` over the
slot-batched recurrent state, under ``TPContext()`` and under compressed
``simulate_tp=2`` (rel-L2 5e-2 there: an fp4 midpoint may round either way
in one framework, ROADMAP.md Queue 3 item 9); greedy tokens, steps,
dispatches and preemptions of the whole-prompt engine equal to the
reference Engine's (built with ``donate_cache=False``: with its default it
donates one sLSTM buffer three times, Queue 3 item 17), dense and gated,
and under block pressure that preempts; ``param_count`` at full size
against the tree (Queue 3 item 16); ``recurrent_state_bytes`` against the
reference's ``cache_bytes``; the four ``SLSTMCache`` tensors in storage of
their own; the shards of ``init_params(tp=...)`` and ``shard_params``
against the tree, the sLSTM leaves whole on every rank; the refusals; and
how far compression moves the first logits of reduced jamba and of xlstm
at 2 and 8 layers, equal in the reference and the port (ROADMAP.md Queue
3 item 18).
The 2-rank TP case rides in ``tests/test_torch_tp.py``'s one spawn. TF32 is
off for torch matmuls in this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.tp import TPContext as JTPContext
from repro.models import xlstm as jxl
from repro.models.model import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving.kv_cache import cache_bytes as j_cache_bytes
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.core.tp import TPContext
from repro_torch.models import xlstm
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.model import Model, param_shapes, shard_axis
from repro_torch.serving import Engine
from repro_torch.serving.kv_cache import (
    init_paged_state, recurrent_state_bytes, zero_paged_state,
)
from tests.conftest import fp32_reduced
from tests.test_torch_serving import (  # noqa: F401  (a fixture)
    reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "xlstm-125m"
XLSTM_ENGINE = dict(max_slots=2, max_len=64, block_size=16)   # whole-prompt by default
REF_ENGINE = dict(donate_cache=False)   # ROADMAP.md Queue 3 item 17
REL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _close(got, ref, tol=REL):
    assert _rel(got, ref) <= tol


def _cache_close(got, ref, tol=REL):
    assert type(got).__name__ == type(ref).__name__
    for g, r in zip(got, ref):
        _close(g.numpy(), r, tol)


def _contexts(compressed):
    if compressed:
        return (JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2),
                TPContext(policy=PAPER_DEFAULT, simulate_tp=2))
    return JTPContext(mesh=None), TPContext()


@pytest.fixture(scope="module")
def models():
    cfg_j = fp32_reduced(ARCH)
    cfg_t = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="float32")
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    model_j = JModel(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    params_j = jax.tree.map(jnp.asarray, tree)
    return cfg_t, model_j, params_j, Model(cfg_t), params_from_numpy(tree, cfg_t, "cpu")


def test_reduced_xlstm_schedule(models):
    cfg, _, _, _, params_t = models
    assert [s.kind for s in cfg.layers] == ["mlstm", "slstm"]
    assert (cfg.d_model, cfg.n_heads, cfg.mlstm_d_inner, cfg.mlstm_heads, cfg.slstm_ff,
            cfg.d_ff) == (256, 4, 512, 4, 341, 0)
    assert set(params_t["layers"][0]) == set(params_t["layers"][1]) == {"ln1", "core"}
    assert params_t["layers"][1]["core"]["rz"].shape == (4, 64, 64)


_BLOCKS = {"mlstm": (0, jxl.mlstm, jxl.init_mlstm_cache, xlstm.mlstm, xlstm.init_mlstm_cache),
           "slstm": (1, jxl.slstm, jxl.init_slstm_cache, xlstm.slstm, xlstm.init_slstm_cache)}


@pytest.mark.parametrize("S", [16, 13, 200])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_reference(models, kind, S):
    """A prefill of S tokens (B 2) from a fresh cache: output and cache;
    one decode step from that cache: output and cache; and that step
    against the last position of a prefill of S + 1 tokens."""
    cfg, model_j, params_j, _, params_t = models
    i, j_fn, j_init, t_fn, t_init = _BLOCKS[kind]
    core_j, core_t = params_j["layers"][i]["core"], params_t["layers"][i]["core"]
    u = np.random.default_rng(S).normal(size=(2, S + 1, cfg.d_model)).astype(np.float32)
    jctx, ctx = JTPContext(mesh=None), TPContext()
    c0 = t_init(cfg, 2, device="cpu")
    ref, rc = j_fn(jctx, core_j, jnp.asarray(u[:, :S]), model_j.cfg, cache=j_init(model_j.cfg, 2))
    got, gc = t_fn(ctx, core_t, torch.from_numpy(u[:, :S]), cfg, cache=c0)
    _close(got.numpy(), ref)
    _cache_close(gc, rc)
    # without a cache: the same output
    _close(t_fn(ctx, core_t, torch.from_numpy(u[:, :S]), cfg)[0].numpy(), ref)
    ref_d, rc_d = j_fn(jctx, core_j, jnp.asarray(u[:, S:]), model_j.cfg, cache=rc, decode=True)
    got_d, gc_d = t_fn(ctx, core_t, torch.from_numpy(u[:, S:]), cfg, cache=gc, decode=True)
    _close(got_d.numpy(), ref_d)
    _cache_close(gc_d, rc_d)
    whole, wc = t_fn(ctx, core_t, torch.from_numpy(u), cfg, cache=c0)
    _close(got_d.numpy(), whole[:, -1:].numpy())
    _cache_close(gc_d, wc)
    with pytest.raises(ValueError, match="one token and a cache"):
        t_fn(ctx, core_t, torch.from_numpy(u[:, :2]), cfg, cache=gc, decode=True)


@pytest.mark.parametrize("compressed", [False, True], ids=["dense-ctx", "simulate_tp2"])
def test_prefill_and_decode_step_match_reference(models, compressed):
    """``Model.prefill`` of two 21-token prompts (exact length): logits and
    every layer's cache; then one ``decode_step_paged`` of both slots over
    the recurrent state the prefill left (no pools): logits and the new
    ``rec``, written in place."""
    cfg, model_j, params_j, model_t, params_t = models
    tol = 5e-2 if compressed else REL
    ctx_j, ctx_t = _contexts(compressed)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    logits_j, cache_j = model_j.prefill(ctx_j, params_j, {"tokens": jnp.asarray(tokens)},
                                        model_j.init_cache(2, 21, jnp.float32))
    logits_t, cache_t = model_t.prefill(ctx_t, params_t, {"tokens": torch.from_numpy(tokens)},
                                        model_t.init_cache(2, 21, torch.float32, "cpu"))
    _close(logits_t.numpy(), logits_j, tol)
    for got, ref in zip(cache_t["layers"], cache_j["layers"]):
        _cache_close(got, ref, tol)
    state_j = {"pools_k": [], "pools_v": [], "rec": list(cache_j["layers"])}
    state_t = {"pools_k": [], "pools_v": [], "rec": list(cache_t["layers"])}
    held = [t for c in state_t["rec"] for t in c]
    before = [t.clone() for t in held]
    toks = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    lengths = np.array([21, 21], np.int32)
    logits_j, new_j = model_j.decode_step_paged(ctx_j, params_j, jnp.asarray(toks), state_j,
                                                jnp.asarray(tables), jnp.asarray(lengths))
    logits_t, new_t = model_t.decode_step_paged(ctx_t, params_t, torch.from_numpy(toks),
                                                state_t, torch.from_numpy(tables),
                                                torch.from_numpy(lengths))
    _close(logits_t.numpy(), logits_j, tol)
    for got, ref in zip(new_t["rec"], new_j["rec"]):
        _cache_close(got, ref, tol)
    assert [t.data_ptr() for c in new_t["rec"] for t in c] == [t.data_ptr() for t in held]
    assert not any(torch.equal(a, b) for a, b in zip(held, before) if a.ndim > 2)


def _traffic(vocab):
    """(prompt, max_new_tokens): prompts of 12 and 20 tokens, two of each,
    4..7 new tokens (two exact-length prefill programs)."""
    return [(((np.arange(n, dtype=np.int32) * 11 + i) % vocab).astype(np.int32), 4 + i)
            for i, n in enumerate((12, 20, 12, 20))]


@pytest.mark.parametrize("gated", [False, True], ids=["dense-ctx", "gated-simulate_tp2"])
def test_greedy_tokens_identical_to_reference_engine(models, gated,
                                                    reference_copies_host_arrays):
    """The whole-prompt engine (the default for a recurrent stack) on fp4
    pools (none are made: the stack has no attention layer): tokens, steps
    and dispatches as the reference's; one step program per exact prompt
    length."""
    eng_j, eng_t, _ = serve_both(models, _traffic(models[0].vocab_size), gated=gated,
                                 cache_spec="fp4_e2m1", ref_kw=REF_ENGINE, **XLSTM_ENGINE)
    assert eng_t.prefill_chunk == eng_j.prefill_chunk == 0
    assert eng_t.token_budget == eng_j.token_budget == 0
    assert eng_t.prefill_cache_size() == eng_j.prefill_cache_size() == 2
    assert eng_t.decode_cache_size() == 1
    assert eng_t._state["pools_k"] == eng_t._state["pools_v"] == []
    assert eng_t.kv_pool_bytes() == 0
    assert eng_t.rec_state_bytes() == j_cache_bytes(eng_j.cfg, eng_t.n_slots, 64)


# the recurrent stacks of ROADMAP.md Queue 3 item 18: arch -> reduced_config options
COMPRESSION_STACKS = {"jamba-3": ("jamba-v0.1-52b", dict(n_layers=3)),
                      "xlstm-2": (ARCH, {}), "xlstm-8": (ARCH, dict(n_layers=8))}


@pytest.mark.parametrize("stack", sorted(COMPRESSION_STACKS))
def test_compression_moves_first_logits_as_in_reference(stack):
    """ROADMAP.md Queue 3 item 18: on a recurrent stack, compression
    (PAPER_DEFAULT over ``simulate_tp=2``) moves the first logits of a
    64-token prefill far more than on an attention stack of the same depth.
    The reference's rel-L2 (compressed against uncompressed) and the
    port's agree within 2% of it, and the two compressed logits within
    rel-L2 5e-2: what compression does to a recurrent state, not a fault
    of the port (reduced jamba 0.107, xlstm at 2 layers 0.075 and at 8
    layers 0.297 in fp32 on the CPU, against reduced mixtral's 0.048)."""
    arch, kw = COMPRESSION_STACKS[stack]
    cfg_j = fp32_reduced(arch, **kw)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch), **kw), dtype="float32")
    model_j = JModel(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    params_j, model_t = jax.tree.map(jnp.asarray, tree), Model(cfg_t)
    params_t = params_from_numpy(tree, cfg_t, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (1, 64)).astype(np.int32)
    logits = {}
    for compressed in (False, True):
        ctx_j, ctx_t = _contexts(compressed)
        lj, _ = model_j.prefill(ctx_j, params_j, {"tokens": jnp.asarray(tokens)},
                                model_j.init_cache(1, 64, jnp.float32))
        lt, _ = model_t.prefill(ctx_t, params_t, {"tokens": torch.from_numpy(tokens)},
                                model_t.init_cache(1, 64, torch.float32, "cpu"))
        logits[compressed] = (np.asarray(lj), lt.numpy())
    ref_moved = _rel(logits[True][0], logits[False][0])
    port_moved = _rel(logits[True][1], logits[False][1])
    assert abs(port_moved - ref_moved) <= 0.02 * ref_moved, (ref_moved, port_moved)
    assert ref_moved > 0.06
    _close(logits[True][1], logits[True][0], 5e-2)
    _close(logits[False][1], logits[False][0])


def test_preemption_identical_to_reference_engine(models, reference_copies_host_arrays):
    """Two 12-token prompts on 3 usable blocks: the reference allocates
    blocks for a stack with no pools, and the later request is preempted
    when both cross 16 tokens, then re-prefills its prompt plus the tokens
    it generated (a new exact length)."""
    vocab = models[0].vocab_size
    traffic = [(((np.arange(12, dtype=np.int32) * 5 + i) % vocab).astype(np.int32), 8)
               for i in range(2)]
    _, eng_t, _ = serve_both(models, traffic, gated=True, cache_spec="bf16", n_blocks=4,
                             ref_kw=REF_ENGINE, **XLSTM_ENGINE)
    assert eng_t.stats.summary()["n_preemptions"] >= 1


def test_reference_engine_donates_one_slstm_buffer_three_times(models):
    """ROADMAP.md Queue 3 item 17: the reference's ``init_slstm_cache``
    builds c, n and h from one zeros array, so its Engine, which donates
    its cache state by default, raises on an sLSTM stack; the port's four
    tensors hold storage of their own, in ``init_slstm_cache``, in the
    paged state, and after ``zero_paged_state``, with ``m`` back at -1e30."""
    cfg, model_j, params_j, _, _ = models
    ref = jxl.init_slstm_cache(model_j.cfg, 2)
    assert ref.c is ref.n is ref.h
    with pytest.raises(Exception, match="donate the same buffer twice"):
        JEngine(model_j, params_j, JTPContext(mesh=None), **XLSTM_ENGINE)
    cache = xlstm.init_slstm_cache(cfg, 3, device="cpu")
    state = init_paged_state(cfg, 3, 9, 16, device="cpu")
    for c in (cache, state["rec"][1]):
        assert isinstance(c, xlstm.SLSTMCache)
        ptrs = {t.untyped_storage().data_ptr() for t in c}
        assert len(ptrs) == 4
        assert torch.all(c.m == xlstm.M_INIT)
    for c in state["rec"]:
        for t in c:
            t.fill_(7.0)
    ptrs = [t.data_ptr() for c in state["rec"] for t in c]
    zero_paged_state(state)
    assert ptrs == [t.data_ptr() for c in state["rec"] for t in c]
    for c in state["rec"]:
        for name, t in zip(c._fields, c):
            assert torch.all(t == (xlstm.M_INIT if name == "m" else 0.0)), name


def test_recurrent_state_bytes_match_reference_cache_bytes():
    """Per slot and layer: an mLSTM layer's ``H (dh^2 + dh + 1)`` fp32 of
    (C, n, m) and ``(conv - 1) d_inner`` of history, an sLSTM layer's
    ``4 d_model``, as the reference's ``cache_bytes`` (which counts no
    attention here); on 2 ranks a rank holds half of every mLSTM term and
    the whole sLSTM state."""
    for cfg, ref in ((get_config(ARCH), j_get_config(ARCH)),
                     (reduced_config(get_config(ARCH)), fp32_reduced(ARCH))):
        for slots in (1, 4):
            assert recurrent_state_bytes(cfg, slots) == j_cache_bytes(ref, slots, 512)
        mlstm = sum(s.kind == "mlstm" for s in cfg.layers)
        slstm = sum(s.kind == "slstm" for s in cfg.layers)
        di, H = cfg.mlstm_d_inner, cfg.n_heads
        dh = di // H
        per_m = (H * (dh * dh + dh + 1) + 3 * di) * 4
        assert recurrent_state_bytes(cfg, 1) == mlstm * per_m + slstm * 4 * cfg.d_model * 4
    full = get_config(ARCH)
    per_m = (4 * (384 * 384 + 385) + 3 * 1536) * 4
    assert recurrent_state_bytes(full, 4) == 4 * (10 * per_m + 2 * 4 * 768 * 4)
    assert recurrent_state_bytes(full.tp_shard(2), 4) == 4 * (10 * per_m // 2 + 2 * 4 * 768 * 4)


def test_param_count_at_full_size():
    """194,280,232 leaves in the tree, 194,279,464 counted: all but the final
    norm, which neither package counts for any family. The reference counts
    192,528,384 (ROADMAP.md Queue 3 item 16): per sLSTM layer it counts two
    FF matrices of three and no forget bias or norm vector, per mLSTM layer
    no conv, ``wi``, ``wf`` or forget bias, and two norms a layer where an
    xLSTM layer has one."""
    cfg, ref = get_config(ARCH), j_get_config(ARCH)
    leaves = lambda tree: (sum(leaves(v) for v in tree.values()) if isinstance(tree, dict)
                           else sum(leaves(v) for v in tree) if isinstance(tree, list)
                           else int(np.prod(tree)))
    tree = param_shapes(cfg)
    assert leaves(tree) == 194_280_232
    assert cfg.param_count() == leaves(tree) - leaves(tree["final_norm"]) == 194_279_464
    assert ref.param_count() == 192_528_384
    d, di, H, ff = cfg.d_model, cfg.mlstm_d_inner, cfg.n_heads, cfg.slstm_ff
    per_mlstm = cfg.xlstm_conv * di + di + 2 * di * H + H + di - 2 * di - d
    per_slstm = d * ff + d + d - d
    assert cfg.param_count() - ref.param_count() == 10 * per_mlstm + 2 * per_slstm
    assert 2 * d * ff == 1_572_864
    assert cfg.active_param_count() == cfg.param_count()


def _leaves(tree, key="", parent="", block=None, cfg=None):
    """(parent, key, block, leaf) of a tree, ``block`` an xLSTM layer's kind."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k, key, block, cfg)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, key, parent, cfg.layers[i].kind if key == "layers" else block,
                               cfg)
    else:
        yield parent, key, block, tree


def _to_numpy(tree):
    """A torch parameter tree as numpy, in the tree's own key order."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_xlstm_tree_shards_by_block_kind(n):
    """``init_params(tp=(r, n))`` and ``shard_params`` on reduced xlstm at
    d_model 384 (mLSTM d_inner 768, sLSTM FF 512): the mLSTM ``up``, ``z``,
    conv and ``norm`` by d_inner, ``wq``, ``wk``, ``wv``, ``wi``, ``wf.w``
    and ``down`` by rows (the reference's ``mlstm_specs``), every sLSTM leaf
    whole on every rank but its FF (``slstm_specs``): the shards put
    together are the tree, each with the rank-local config's shapes. The
    xLSTM names collide with attention's (``wq`` by columns, ``wo`` by rows
    there), which ``shard_axis`` tells apart by the block's kind."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH), d_model=384), dtype="float32")
    model = Model(cfg)
    full = list(_leaves(model.init_params(device="cpu", seed=3), cfg=cfg))
    shards = [list(_leaves(model.init_params(device="cpu", seed=3, tp=(r, n)), cfg=cfg))
              for r in range(n)]
    np_tree = _to_numpy(model.init_params(device="cpu", seed=3))
    np_shards = [list(_leaves(shard_params(np_tree, cfg, r, n), cfg=cfg)) for r in range(n)]
    local = list(_leaves(param_shapes(cfg.tp_shard(n)), cfg=cfg))
    axes = {}
    for i, (parent, key, block, t) in enumerate(full):
        axis = shard_axis(parent, key, block)
        axes.setdefault(block, []).append(((parent, key), axis))
        parts = [s[i][3] for s in shards]
        assert all(tuple(p.shape) == local[i][3] for p in parts), (parent, key)
        if axis is None:
            assert all(torch.equal(p, t) for p in parts), (parent, key)
        else:
            assert torch.equal(torch.cat(parts, dim=axis), t), (parent, key)
        np_parts = [s[i][3] for s in np_shards]
        np.testing.assert_array_equal(
            np_parts[0] if axis is None else np.concatenate(np_parts, axis=axis), t.numpy())
    assert dict(axes["mlstm"]) == {
        ("ln1", "w"): None, ("up", "w"): -1, ("z", "w"): -1, ("core", "conv_w"): -1,
        ("core", "conv_b"): -1, ("wq", "w"): -2, ("wk", "w"): -2, ("wv", "w"): -2,
        ("wi", "w"): -2, ("wf", "w"): -2, ("wf", "b"): None, ("norm", "w"): -1,
        ("down", "w"): -2}
    slstm = dict(axes["slstm"])
    assert {k for k, a in slstm.items() if a is not None} == {("ff_up", "w"), ("ff_gate", "w"),
                                                              ("ff_down", "w")}
    assert slstm[("wo", "w")] is None and shard_axis("wo", "w") == -2
    core = full[[i for i, (p, k, b, _) in enumerate(full) if b == "mlstm" and p == "wf"][-1]]
    assert torch.equal(core[3], torch.full((cfg.n_heads,), 3.0))
    rank = cfg.tp_shard(n)
    assert (rank.n_heads, rank.mlstm_heads, rank.mlstm_d_inner, rank.slstm_ff) == (
        4, 4 // n, 768 // n, 512 // n)


def test_refusals(models):
    """The reference's errors for the chunked path on a recurrent stack;
    an xLSTM layer beside another kind, or with a d_ff, is refused; a TP
    group whose mLSTM d_inner or sLSTM FF does not split into MX blocks is
    refused (reduced xlstm's FF of 341 splits over no group)."""
    cfg, _, _, model_t, params_t = models
    kw = dict(XLSTM_ENGINE, device="cpu")
    for extra, msg in ((dict(prefill_chunk=16), "requires a pure-attention"),
                       (dict(token_budget=18), "rides on chunked prefill"),
                       (dict(prefix_cache=True), "rides on chunked prefill")):
        with pytest.raises(ValueError, match=msg):
            Engine(model_t, params_t, TPContext(), **kw, **extra)
    with pytest.raises(ValueError, match="layer 0 is 'mlstm'"):
        model_t.prefill_chunk(TPContext(), params_t, torch.zeros(1, 4, dtype=torch.int32),
                              None, None, 0, 4)
    with pytest.raises(ValueError, match="mixed_step requires a pure-attention"):
        model_t.mixed_step(TPContext(), params_t, *([None] * 9))
    attn = get_config("llama2-7b").layers[0]
    for bad in (dataclasses.replace(cfg, layers=(cfg.layers[0], attn)),
                dataclasses.replace(cfg, d_ff=512)):
        with pytest.raises(NotImplementedError, match="xLSTM layers"):
            Model(bad)
    with pytest.raises(ValueError, match="sLSTM FF 341/2"):
        cfg.tp_shard(2)
    with pytest.raises(ValueError, match="mLSTM d_inner"):
        dataclasses.replace(cfg, d_model=240, layers=cfg.layers[:1], n_layers=1).tp_shard(2)
