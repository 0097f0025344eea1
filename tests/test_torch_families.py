"""The port's new dense families (qwen2-7b, qwen3-32b, gemma3-4b) against the
reference, on the CPU, fp32, identical weights and inputs.

``reduced_config`` caps heads at 4 and head_dim at 32, which would turn every
family into GQA group 1. Each reduced config here is rebuilt with
``dataclasses.replace`` so that it keeps its group and head_dim, the same way
for both packages: qwen2 7 query heads over 1 kv head (hd 32, QKV biases),
qwen3 8 over 1 (hd 32, q/k norms), gemma3 2 over 1 (hd 256, q/k norms, a
non-gated tanh-gelu MLP, tied embeddings, one layer with a 32-token window
and one global layer). Weights are the reference's ``init_params`` through
``params_from_numpy``, with random biases and q/k norm weights (the
reference initialises them to zero and one, which would hold nothing).

Held: the MLP, ``attention()`` with and without a cache, whole-prompt
prefill, and the paged chunk (dense pools), decode and mixed (fp4 pools)
steps (dense context: max |delta| <= 1e-4 max |ref|, summation order only; fp4
pool bytes equal); greedy tokens, steps, dispatches and gate counts of the
engine identical to the reference Engine's under the gated
``simulate_tp=2`` context on bf16 and fp4 pools, on traffic whose longest
prompt (48 tokens) is longer than gemma3's window; ``param_count`` and
``active_param_count`` for every ported config; the parameter tree each
config has. TF32 is off for torch matmuls in this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core.tp import TPContext as JTPContext
from repro.models import attention as jattn
from repro.models.mlp import mlp as j_mlp
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core.tp import TPContext
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mlp import mlp
from repro_torch.models.model import Model, param_shapes
from tests.test_torch_model import test_mixed_step_matches_reference as _check_mixed
from tests.test_torch_prefill import _check_chunk, _check_decode
from tests.test_torch_serving import (  # noqa: F401  (a fixture)
    ENGINE_KW, reference_copies_host_arrays, serve_both,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FAMILIES = {
    "qwen2": ("qwen2-7b", dict(n_heads=7, n_kv_heads=1, head_dim=32)),
    "qwen3": ("qwen3-32b", dict(n_heads=8, n_kv_heads=1, head_dim=32)),
    "gemma3": ("gemma3-4b", dict(n_heads=2, n_kv_heads=1, head_dim=256)),
}


def family_config(arch, over, reference=False):
    """The family's reduced config in fp32 with its group and head_dim kept."""
    cfg = (j_reduced_config(j_get_config(arch)) if reference
           else reduced_config(get_config(arch)))
    return dataclasses.replace(cfg, dtype="float32", **over)


def _randomize(tree, rng):
    """The reference's numpy tree with random biases and q/k norm weights."""
    for layer in tree["layers"]:
        core = layer["core"]
        for name in ("wq", "wk", "wv"):
            if "b" in core[name]:
                core[name]["b"] = rng.normal(size=core[name]["b"].shape).astype(np.float32) * 0.5
        for name in ("q_norm", "k_norm"):
            if name in core:
                w = core[name]["w"]
                core[name]["w"] = (1.0 + rng.normal(size=w.shape) * 0.5).astype(np.float32)
    return tree


def build(name):
    arch, over = FAMILIES[name]
    cfg_j = family_config(arch, over, reference=True)
    cfg_t = family_config(arch, over)
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    model_j = JModel(cfg_j)
    tree = jax.tree.map(np.asarray, model_j.init_params(jax.random.PRNGKey(0)))
    tree = _randomize(jax.tree.map(np.array, tree), np.random.default_rng(1))
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = params_from_numpy(tree, cfg_t, "cpu")
    return cfg_t, model_j, params_j, Model(cfg_t), params_t


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def models(request):
    return build(request.param)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_reduced_family_keeps_its_geometry(models):
    cfg = models[0]
    group = {"qwen2-7b": 7, "qwen3-32b": 8, "gemma3-4b": 2}[cfg.name]
    assert cfg.n_heads // cfg.n_kv_heads == group
    assert cfg.head_dim == (256 if cfg.name == "gemma3-4b" else 32)
    if cfg.name == "gemma3-4b":
        assert [s.window for s in cfg.layers] == [32, None]
        assert cfg.tie_embeddings and cfg.activation == "gelu" and cfg.qk_norm
        assert "lm_head" not in models[4] and "gate" not in models[4]["layers"][0]["mlp"]
    core = models[4]["layers"][0]["core"]
    assert ("b" in core["wq"]) == cfg.qkv_bias and ("q_norm" in core) == cfg.qk_norm


def test_mlp_matches_reference(models):
    """SwiGLU (qwen) or the non-gated tanh-gelu MLP (gemma3)."""
    cfg, _, params_j, _, params_t = models
    x = np.random.default_rng(2).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    ref = j_mlp(JTPContext(mesh=None), params_j["layers"][0]["mlp"], jnp.asarray(x), cfg)
    got = mlp(TPContext(), params_t["layers"][0]["mlp"], torch.from_numpy(x), cfg)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("cache", [False, True], ids=["no-cache", "cache-at-pos8"])
def test_attention_matches_reference(models, cache):
    """``attention()`` on each layer's weights and window over x (2, 40, d):
    without a cache, or writing at position 8 of a 48-long cache that holds
    random history (gemma3's windowed layer: 40 queries over a 32 window)."""
    cfg, _, params_j, _, params_t = models
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    hist = [rng.normal(size=(2, 48, cfg.kv_dim)).astype(np.float32) for _ in range(2)]
    pos = 8 if cache else 0
    for i, spec in enumerate(cfg.layers):
        pj, pt = params_j["layers"][i]["core"], params_t["layers"][i]["core"]
        cj = jattn.KVCache(*map(jnp.asarray, hist)) if cache else None
        ct = tattn.KVCache(*(torch.from_numpy(h.copy()) for h in hist)) if cache else None
        yj, cj = jattn.attention(JTPContext(mesh=None), pj, jnp.asarray(x), cfg,
                                 pos=jnp.int32(pos), cache=cj, window=spec.window)
        yt, ct = tattn.attention(TPContext(), pt, torch.from_numpy(x), cfg, pos=pos, cache=ct,
                                 window=spec.window)
        _close(yt.numpy(), yj)
        if cache:
            _close(ct.k.numpy(), cj.k)
            _close(ct.v.numpy(), cj.v)


def test_prefill_matches_reference(models):
    """Whole-prompt prefill of a 45-token prompt right-padded to 48, logits
    at the last real token, and every layer's dense cache."""
    cfg, model_j, params_j, model_t, params_t = models
    tokens = np.zeros((1, 48), np.int32)
    tokens[0, :45] = np.random.default_rng(4).integers(0, cfg.vocab_size, 45)
    logits_j, cache_j = model_j.prefill(JTPContext(mesh=None), params_j,
                                        {"tokens": jnp.asarray(tokens)},
                                        model_j.init_cache(1, 48, jnp.float32),
                                        last_index=jnp.int32(44))
    logits_t, cache_t = model_t.prefill(TPContext(), params_t, {"tokens": torch.from_numpy(tokens)},
                                        model_t.init_cache(1, 48, torch.float32, "cpu"),
                                        last_index=44)
    _close(logits_t.numpy(), logits_j)
    for layer in range(cfg.n_layers):
        for a in ("k", "v"):
            _close(getattr(cache_t["layers"][layer], a).numpy(),
                   getattr(cache_j["layers"][layer], a))


@pytest.mark.parametrize("step, fmt", [("chunk", "dense"), ("decode", "fp4_e2m1"),
                                       ("mixed", "fp4_e2m1")])
def test_paged_steps_match_reference(models, step, fmt):
    """The chunk, decode and mixed steps of ``tests/test_torch_prefill.py``
    and ``tests/test_torch_model.py`` (histories 21-52 in 64-position tables,
    so gemma3's windowed layer cuts them) on this family, dense context, one
    pool format each (the engine test below runs both on every step)."""
    if step == "chunk":
        _check_chunk(models, fmt, "dense-ctx")
    elif step == "decode":
        _check_decode(models, fmt, "dense-ctx")
    else:
        _check_mixed(models, "dense" if fmt == "dense" else fmt, False)


def family_traffic(vocab):
    """(prompt, max_new_tokens): prompts of 5, 14, 40 and 48 tokens (the
    last two longer than gemma3's 32-token window), 4..7 new tokens."""
    return [(((np.arange(n, dtype=np.int32) * 11 + i) % vocab).astype(np.int32), 4 + i)
            for i, n in enumerate((5, 14, 40, 48))]


@pytest.mark.parametrize("cache", ["bf16", "fp4_e2m1"])
def test_greedy_tokens_identical_to_reference_engine(models, cache,
                                                    reference_copies_host_arrays):
    eng_j, eng_t, _ = serve_both(models, family_traffic(models[0].vocab_size), gated=True,
                                 cache_spec=cache, **ENGINE_KW)
    assert eng_t.gate_counts["compressed"] > 0 and eng_t.gate_counts["dense"] > 0


def mamba_undercount(cfg) -> int:
    """What the reference's ``param_count`` leaves out of the tree its
    ``init_params`` builds (ROADMAP Queue 3): per Mamba layer, the dense MLP
    of a layer without MoE and two of its three ``d_inner`` vectors. 0 for
    the attention families."""
    return sum((0 if sp.moe else 3 * cfg.d_model * cfg.d_ff) + 2 * cfg.ssm_d_inner
               for sp in cfg.layers if sp.kind == "mamba")


def frontend_undercount(cfg) -> int:
    """What the reference's ``param_count`` leaves out of the tree its
    ``init_params`` builds for a vision prefix or an encoder (ROADMAP Queue
    3): ``mm_proj`` (d_model x d_model), ``enc_norm`` and each decoder
    layer's cross-attention norm. 0 for a text decoder."""
    d = cfg.d_model
    return ((d * d if cfg.frontend == "vision" else 0)
            + ((1 + cfg.n_layers) * d if cfg.encoder_decoder else 0))


def xlstm_undercount(cfg) -> int:
    """What the reference's ``param_count`` leaves out of the tree its
    ``init_params`` builds for xLSTM layers (ROADMAP Queue 3 item 16), less
    the second norm it counts for a layer that has one: per mLSTM layer the
    conv (``conv_w``, ``conv_b``), ``wi``, ``wf`` and its bias, and ``norm``
    beyond the ``2 d_inner`` it counts; per sLSTM layer the third FF matrix
    and the forget bias. 0 for the other families."""
    d, di, H = cfg.d_model, cfg.mlstm_d_inner, cfg.n_heads
    per = {"mlstm": cfg.xlstm_conv * di + di + 2 * di * H + H + di - 2 * di - d,
           "slstm": cfg.slstm_ff * d + d + d - d}
    return sum(per.get(sp.kind, 0) for sp in cfg.layers)


def undercount(cfg) -> int:
    """Every term the port counts and the reference's ``param_count`` does
    not (ROADMAP Queue 3 items 13, 14 and 16)."""
    return mamba_undercount(cfg) + frontend_undercount(cfg) + xlstm_undercount(cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_matches_reference(arch):
    """Equal to the reference's count, plus the terms it leaves out of a
    Mamba layer (jamba), a vision prefix (pixtral), an encoder-decoder
    (whisper) and xLSTM layers (xlstm-125m), which the port counts."""
    cfg, ref = get_config(arch), j_get_config(arch)
    gap = undercount(cfg)
    assert cfg.param_count() == ref.param_count() + gap
    assert cfg.active_param_count() == ref.active_param_count() + gap
    red, red_j = reduced_config(cfg), j_reduced_config(ref)
    assert red.param_count() == red_j.param_count() + undercount(red)
    assert (xlstm_undercount(cfg) > 0) == (arch == "xlstm-125m")


def test_init_params_tree_matches_reference(models):
    cfg, model_j, params_j, model_t, _ = models
    fresh = model_t.init_params(torch.Generator().manual_seed(3), device="cpu")
    shape = lambda t: jax.tree.map(lambda a: tuple(a.shape), t,
                                   is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert shape(fresh) == shape(params_j) == jax.tree.map(
        tuple, param_shapes(cfg), is_leaf=lambda a: isinstance(a, tuple))


@pytest.mark.parametrize("fault", ["bias", "q_norm", "gate", "lm_head"])
def test_params_from_numpy_checks_the_family_tree(fault):
    """A tree that lacks a config's bias, has a q/k norm of the wrong
    width, carries a gate the gelu MLP does not have, or an ``lm_head`` a
    tied config does not have, is refused."""
    arch, over = FAMILIES["qwen2" if fault == "bias" else "gemma3"]
    cfg = family_config(arch, over)
    tree = jax.tree.map(np.asarray, JModel(family_config(arch, over, reference=True))
                        .init_params(jax.random.PRNGKey(0)))
    params_from_numpy(tree, cfg, "cpu")
    core, mlp_p = tree["layers"][1]["core"], tree["layers"][1]["mlp"]
    if fault == "bias":
        del core["wk"]["b"]
    elif fault == "q_norm":
        core["q_norm"]["w"] = np.ones(32, np.float32)
    elif fault == "gate":
        mlp_p["gate"] = mlp_p["up"]
    else:
        tree["lm_head"] = tree["embed"]
    with pytest.raises(ValueError, match={"bias": "wk", "q_norm": "q_norm", "gate": "mlp",
                                          "lm_head": "keys"}[fault]):
        params_from_numpy(tree, cfg, "cpu")
