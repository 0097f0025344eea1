"""The port's whole-prompt prefill, chunked prefill and paged decode against
the reference's on identical weights (``params_from_numpy`` of the
reference's ``init_params``) and identical inputs made from a seed with
numpy: ``Model.prefill`` (logits and dense cache), ``Model.prefill_chunk`` and
``Model.decode_step_paged`` (logits and the pools after the append), and
``attention()`` / ``_attend`` (with and without a window, with and without a
cache), for reduced llama2 and a GQA variant of reduced internlm2
(n_kv_heads = 2), under the dense context and the compressed
``simulate_tp=2`` context.

The reference's paged reads run its jnp gather path, and with a ``+pallas``
cache spec its Pallas kernel in interpret mode (as its own tests run it);
the port's run its kernels' plain versions.

Tolerances (fp32): under the dense context max |Δ| <= 1e-4 * max|ref| on
logits and dense caches (summation order only) and 1e-5 on dense pools.
Under compression a partial sum within rounding of an fp4 midpoint may take
the neighbouring code in one framework; such a flip propagates through the
later layers. Reduced llama2's chunk shows one: a single element of the
first ``wo`` reduction's 16 x 256 differs by one code step (0.0625), which
moves the logits by rel-L2 2.1e-2, while compression itself moves them
8.7e-2 from the dense reference. So under compression logits are held
within rel-L2 5e-2, and only the first layer's cache or pools, which
precede every reduction, are compared. fp4 pool bytes are equal wherever
they are compared. The reference codec scales with ``jnp.exp2`` (ROADMAP Queue 3
item 2); its exp2 is exact at the exponents these inputs reach, which the
byte-equal pools show. TF32 is off for torch matmuls in this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core.formats import KVCacheSpec as JKVCacheSpec
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.tp import TPContext as JTPContext
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.formats import KVCacheSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.core.tp import TPContext
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model, shard_leaf
from tests.conftest import fp32_reduced

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VARIANTS = {"llama2": ("llama2-7b", {}), "internlm2-gqa": ("internlm2-1.8b", {"n_kv_heads": 2})}
N_BLOCKS, BS = 9, 16
CTXS = ["dense-ctx", "simulate_tp2"]


def _ctxs(name):
    if name == "dense-ctx":
        return JTPContext(mesh=None), TPContext()
    return (JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2),
            TPContext(policy=PAPER_DEFAULT, simulate_tp=2))


def _models(arch, over):
    cfg_j = dataclasses.replace(fp32_reduced(arch), **over)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32", **over)
    model_j = JModel(cfg_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t, "cpu")
    return cfg_t, model_j, params_j, Model(cfg_t), params_t


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    return _models(*VARIANTS[request.param])


@pytest.fixture(scope="module")
def llama():
    return _models(*VARIANTS["llama2"])


def _close(got, ref, compressed):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if compressed:
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 5e-2
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def _pools(cfg, fmt, seed=0):
    """The same random pools for both frameworks: dense fp32, or fp4 wire
    pools quantized by the reference codec."""
    rng = np.random.default_rng(seed)
    shape = (N_BLOCKS, BS, cfg.kv_dim)
    dense = [rng.normal(size=shape).astype(np.float32) for _ in range(2 * cfg.n_layers)]
    if fmt == "dense":
        return [jnp.asarray(p) for p in dense], [torch.from_numpy(p.copy()) for p in dense]
    jspec = JKVCacheSpec.parse(fmt).mx
    wire = [jmx.quantize(jnp.asarray(p), jspec) for p in dense]
    return wire, [MXCompressed(torch.from_numpy(np.array(w.payload)),
                               torch.from_numpy(np.array(w.scales))) for w in wire]


def _state(pools, L, reference):
    st = {"pools_k": pools[:L], "pools_v": pools[L:]}
    return {**st, "rec": []} if reference else st


def _check_pools(state_t, state_j, fmt, layers):
    for layer in layers:
        for name in ("pools_k", "pools_v"):
            pt, pj = state_t[name][layer], state_j[name][layer]
            pairs = ([(pt.payload, pj.payload), (pt.scales, pj.scales)]
                     if isinstance(pt, MXCompressed) else [(pt, pj)])
            for g, r in pairs:
                g, r = g.numpy(), np.asarray(r)
                if fmt == "dense":
                    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("ctx", CTXS)
def test_prefill_matches_reference(models, ctx):
    """A 27-token prompt right-padded to its 32-token bucket, logits read at
    the last real token; the dense cache holds every position's K/V."""
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j, ctx_t = _ctxs(ctx)
    rng = np.random.default_rng(5)
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :27] = rng.integers(0, cfg.vocab_size, 27)
    logits_j, cache_j = model_j.prefill(ctx_j, params_j, {"tokens": jnp.asarray(tokens)},
                                        model_j.init_cache(1, 32, jnp.float32),
                                        last_index=jnp.int32(26))
    logits_t, cache_t = model_t.prefill(ctx_t, params_t, {"tokens": torch.from_numpy(tokens)},
                                        model_t.init_cache(1, 32, torch.float32, "cpu"),
                                        last_index=26)
    compressed = ctx != "dense-ctx"
    _close(logits_t.numpy(), logits_j, compressed)
    assert cache_t["pos"] == int(cache_j["pos"]) == 32
    for layer in range(1 if compressed else cfg.n_layers):
        for a in ("k", "v"):
            _close(getattr(cache_t["layers"][layer], a).numpy(),
                   getattr(cache_j["layers"][layer], a), False)


@pytest.mark.parametrize("ctx", CTXS)
@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
def test_prefill_chunk_matches_reference(models, fmt, ctx):
    """One slot, history 0..20 in its blocks, a 16-token chunk at positions
    21..36 with 13 real tokens (pads cross into the next block): logits at
    the last real token, and the pools after the append (the null block is
    not written)."""
    _check_chunk(models, fmt, ctx)


def _check_chunk(models, fmt, ctx):
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j, ctx_t = _ctxs(ctx)
    pools_j, pools_t = _pools(cfg, fmt.split("+")[0])
    L = cfg.n_layers
    rng = np.random.default_rng(9)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :13] = rng.integers(0, cfg.vocab_size, 13)
    row = np.array([3, 5, 2, 7], np.int32)
    logits_j, state_j = model_j.prefill_chunk(
        ctx_j, params_j, jnp.asarray(tokens), _state(pools_j, L, True), jnp.asarray(row),
        jnp.int32(21), jnp.int32(13), cache_spec=JKVCacheSpec.parse(
            None if fmt == "dense" else fmt))
    logits_t, state_t = model_t.prefill_chunk(
        ctx_t, params_t, torch.from_numpy(tokens), _state(pools_t, L, False),
        torch.from_numpy(row), 21, 13,
        cache_spec=KVCacheSpec.parse(None if fmt == "dense" else fmt))
    compressed = ctx != "dense-ctx"
    _close(logits_t.numpy(), logits_j, compressed)
    _check_pools(state_t, state_j, fmt.split("+")[0], range(1 if compressed else L))


@pytest.mark.parametrize("ctx", CTXS)
@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
def test_decode_step_paged_matches_reference(models, fmt, ctx):
    """Three slots: two at history 37 and 52 (the new token goes in first
    and is read back at pool precision), one empty slot on the null block."""
    _check_decode(models, fmt, ctx)


def _check_decode(models, fmt, ctx):
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j, ctx_t = _ctxs(ctx)
    pools_j, pools_t = _pools(cfg, fmt.split("+")[0], seed=1)
    L = cfg.n_layers
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    lengths = np.array([37, 52, 0], np.int32)
    logits_j, state_j = model_j.decode_step_paged(
        ctx_j, params_j, jnp.asarray(tokens), _state(pools_j, L, True), jnp.asarray(tables),
        jnp.asarray(lengths), cache_spec=JKVCacheSpec.parse(None if fmt == "dense" else fmt))
    logits_t, state_t = model_t.decode_step_paged(
        ctx_t, params_t, torch.from_numpy(tokens), _state(pools_t, L, False),
        torch.from_numpy(tables), torch.from_numpy(lengths),
        cache_spec=KVCacheSpec.parse(None if fmt == "dense" else fmt))
    compressed = ctx != "dense-ctx"
    _close(logits_t.numpy(), logits_j, compressed)
    _check_pools(state_t, state_j, fmt.split("+")[0], range(1 if compressed else L))


@pytest.mark.parametrize("check", [_check_chunk, _check_decode], ids=["chunk", "decode"])
def test_paged_steps_match_reference_pallas_kernel(llama, check):
    """The chunk and decode steps against the reference with its Pallas
    paged kernel (``fp4_e2m1+pallas``, interpret mode): the port's kernel
    geometry (history, then extras; write first, then ``lengths + 1``) is
    the kernel's, not only the jnp gather's."""
    check(llama, "fp4_e2m1+pallas", "dense-ctx")


@pytest.mark.parametrize("window", [None, 8], ids=["global", "window8"])
@pytest.mark.parametrize("cache", [False, True], ids=["no-cache", "cache-at-pos8"])
def test_attention_matches_reference(llama, cache, window):
    """``attention()`` on layer 0's weights over x (2, 16, d): without a
    cache (training path), or writing at position 8 of a 32-long cache
    that already holds random history, then attending the whole cache."""
    cfg, _, params_j, _, params_t = llama
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    hist = [rng.normal(size=(2, 32, cfg.kv_dim)).astype(np.float32) for _ in range(2)]
    pj, pt = params_j["layers"][0]["core"], params_t["layers"][0]["core"]
    cj = jattn.KVCache(*map(jnp.asarray, hist)) if cache else None
    ct = tattn.KVCache(*(torch.from_numpy(h.copy()) for h in hist)) if cache else None
    pos = 8 if cache else 0
    yj, cj = jattn.attention(JTPContext(mesh=None), pj, jnp.asarray(x), cfg, pos=jnp.int32(pos),
                             cache=cj, window=window)
    yt, ct = tattn.attention(TPContext(), pt, torch.from_numpy(x), cfg, pos=pos, cache=ct,
                             window=window)
    _close(yt.numpy(), yj, False)
    if cache:
        _close(ct.k.numpy(), cj.k, False)
        _close(ct.v.numpy(), cj.v, False)


@pytest.mark.parametrize("window", [None, 8], ids=["global", "window8"])
def test_q_chunked_attend_matches_reference(window):
    """``_attend`` over 40 queries in chunks of 16 (the reference halves the
    chunk to 8, a divisor of 40; the port runs 16, 16 and 8) against 40
    keys, GQA 4:2."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 32)).astype(np.float32) for _ in range(2))
    pos = np.arange(40, dtype=np.int32)
    kw = dict(window=window, scale=0.25, kv_heads=2, chunk=16)
    ref = jattn._attend(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True, **kw)
    got = tattn._attend(*map(torch.from_numpy, (q, k, v, pos, pos)), **kw)
    _close(got.numpy(), ref, False)


def test_cross_attention_raises(llama, monkeypatch):
    """Cross-attention on a TP group no longer raises: each rank attends
    with its heads (q from its columns of ``wq``, its kv heads of the
    encoder K/V, the rank-local config) and the ranks' ``wo`` partials sum
    to the single-rank output (the single-device path is held in
    ``tests/test_torch_encdec.py``, the ranks in ``tests/test_torch_tp.py``)."""
    cfg, _, _, _, params_t = llama
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 6, cfg.kv_dim)).astype(np.float32))
            for _ in range(2))
    core = params_t["layers"][0]["core"]
    full, _ = tattn.attention(TPContext(), core, x, cfg, pos=0, cross_kv=tattn.KVCache(k, v))
    monkeypatch.setattr(TPContext, "tp_size", property(lambda self: 2))
    local = cfg.tp_shard(2)
    w = local.kv_dim
    total = 0
    for r in range(2):
        shard = {name: {key: shard_leaf(t, name, key, r, 2) for key, t in p.items()}
                 for name, p in core.items()}
        part, _ = tattn.attention(TPContext(), shard, x, local, pos=0, cross_kv=tattn.KVCache(
            k[..., r * w:(r + 1) * w], v[..., r * w:(r + 1) * w]))
        total = total + part
    _close(total.numpy(), full.numpy(), False)