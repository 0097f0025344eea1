"""The port's ``Model.mixed_step`` against the reference's on identical
weights (``params_from_numpy`` of the reference's ``init_params``), identical
pools and one identical mixed batch (a 6-token prefill chunk over 37 tokens of
history, a decode token at position 52, budget pads), for reduced llama2,
reduced internlm2 and a GQA variant (n_kv_heads = 2), on dense fp32 and
fp4_e2m1 pools, under the dense context and the compressed
``simulate_tp=2`` context.

Tolerances (fp32): logits within 1e-4 of the reference's scale under the
dense context (summation order only); rel-L2 <= 1e-4 under compression,
where a partial sum within rounding of a quantization midpoint may take the
neighbouring code in one framework. Pools after the step: fp4 wire bytes
equal and dense pools within 1e-5 — except the null block 0, which takes the
pad rows' colliding writes in an order neither framework defines, and, under
compression, layers after the first, whose K/V inherit those code flips.
TF32 is off for torch matmuls in this file.
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
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.formats import KVCacheSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.core.tp import TPContext
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serving.kv_cache import build_mixed_batch
from tests.conftest import fp32_reduced

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VARIANTS = {"llama2": ("llama2-7b", {}), "internlm2": ("internlm2-1.8b", {}),
            "internlm2-gqa": ("internlm2-1.8b", {"n_kv_heads": 2})}
N_BLOCKS, BS = 9, 16


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    arch, over = VARIANTS[request.param]
    cfg_j = dataclasses.replace(fp32_reduced(arch), **over)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32", **over)
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    model_j = JModel(cfg_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t, "cpu")
    return cfg_t, model_j, params_j, Model(cfg_t), params_t


def _pools(cfg, fmt, seed=0):
    rng = np.random.default_rng(seed)
    shape = (N_BLOCKS, BS, cfg.kv_dim)
    dense = [rng.normal(size=shape).astype(np.float32) for _ in range(2 * cfg.n_layers)]
    if fmt == "dense":
        return [jnp.asarray(p) for p in dense], [torch.from_numpy(p.copy()) for p in dense]
    jspec = JKVCacheSpec.parse(fmt).mx
    wire = [jmx.quantize(jnp.asarray(p), jspec) for p in dense]
    return wire, [MXCompressed(torch.from_numpy(np.array(w.payload)),
                               torch.from_numpy(np.array(w.scales))) for w in wire]


def _batch(cfg):
    rng = np.random.default_rng(11)
    chunk = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    return build_mixed_batch([(0, chunk, 37)], [(1, 5, 52)], token_budget=10, n_slots=2)


def _leaves(pools):
    out = []
    for p in pools:
        out.extend([np.asarray(p.payload), np.asarray(p.scales)] if hasattr(p, "payload")
                   else [np.asarray(p)])
    return out


@pytest.mark.parametrize("compressed", [False, True], ids=["dense-ctx", "simulate_tp2"])
@pytest.mark.parametrize("fmt", ["dense", "fp4_e2m1"])
def test_mixed_step_matches_reference(models, fmt, compressed):
    cfg, model_j, params_j, model_t, params_t = models
    ctx_j = (JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2) if compressed
             else JTPContext(mesh=None))
    ctx_t = TPContext(policy=PAPER_DEFAULT, simulate_tp=2) if compressed else TPContext()
    pools_j, pools_t = _pools(cfg, fmt)
    L = cfg.n_layers
    b = _batch(cfg)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    starts = np.array([37, 52], np.int32)
    spec = None if fmt == "dense" else fmt

    logits_j, state_j = model_j.mixed_step(
        ctx_j, params_j, jnp.asarray(b.tokens), {"pools_k": pools_j[:L], "pools_v": pools_j[L:],
                                                 "rec": []},
        jnp.asarray(b.slot_ids), jnp.asarray(b.positions), jnp.asarray(b.valid),
        jnp.asarray(b.is_decode), jnp.asarray(starts), jnp.asarray(tables),
        jnp.asarray(b.sample_idx), cache_spec=JKVCacheSpec.parse(spec))
    t = torch.from_numpy
    logits_t, state_t = model_t.mixed_step(
        ctx_t, params_t, t(b.tokens), {"pools_k": pools_t[:L], "pools_v": pools_t[L:]},
        t(b.slot_ids), t(b.positions), t(b.valid), t(b.is_decode), t(starts), t(tables),
        t(b.sample_idx), cache_spec=KVCacheSpec.parse(spec))

    lj, lt = np.asarray(logits_j), logits_t.numpy()
    assert lt.shape == lj.shape == (2, cfg.vocab_size) and np.isfinite(lt).all()
    if compressed:
        assert np.linalg.norm(lt - lj) / np.linalg.norm(lj) <= 1e-4
    else:
        np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4 * np.abs(lj).max())

    for layer in range(L if not compressed else 1):
        for name in ("pools_k", "pools_v"):
            got = _leaves([state_t[name][layer]])
            ref = _leaves([state_j[name][layer]])
            for g, r in zip(got, ref):
                if fmt == "dense":
                    np.testing.assert_allclose(g[1:], r[1:], rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(g[1:], r[1:])


def test_init_params_tree_matches_reference(models):
    cfg, model_j, params_j, model_t, _ = models
    fresh = model_t.init_params(torch.Generator().manual_seed(3), device="cpu")
    ref = jax.tree.map(lambda a: tuple(a.shape), params_j)
    got = jax.tree.map(lambda a: tuple(a.shape), fresh,
                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert got == ref
    again = model_t.init_params(torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(fresh["layers"][0]["core"]["wq"]["w"], again["layers"][0]["core"]["wq"]["w"])


def test_unported_families_raise():
    cfg = dataclasses.replace(reduced_config(get_config("llama2-7b")),
                              layers=(dataclasses.replace(get_config("llama2-7b").layers[0],
                                                          kind="mlstm"),) * 2)
    with pytest.raises(NotImplementedError):
        Model(cfg)
