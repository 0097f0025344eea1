"""The port's training path on one device against the reference, on the same
numpy inputs, in fp32 on reduced configs (TF32 off):

* ``data``: ``corpus_tokens(200_000)`` equals the reference's token stream,
  and ``Batches(seed=0)`` draws the reference's windows; two data ranks'
  rows put together are the global batch.
* ``training/optimizer``: ``cosine_lr`` within rel 1e-6 at every step of
  two schedules; three ``adamw_update`` steps on a tree of fp32 or bf16
  leaves, with clipping that binds and clipping that does not: fp32 weights
  and the moments within rel 1e-6 (the global norm's summation order may
  differ), bf16 weights within 1 ulp.
* ``training/checkpoint``: a port checkpoint restores in the reference's
  ``restore_checkpoint`` and the reverse, bit for bit (bf16 weights, fp32
  moments, the step).
* ``Model.loss``: the loss and every leaf's gradient within rel-L2 1e-5 for
  reduced internlm2, mixtral (its aux losses, 80 tokens: the sort-based
  dispatch), jamba (Mamba, Mamba + MoE, attention), xlstm-125m, whisper
  (24 encoder frames) and pixtral (8 patches), with and without ``remat``.
* ``make_train_step``: three steps of reduced internlm2 from the
  reference's converted state: losses within 1e-5, weights within rel-L2
  1e-5.
* The simulated compressed reduction's gradient is the reference's, zero:
  under ``simulate_tp=2`` no layer leaf gets any gradient in either
  package (each layer reaches the loss only through its quantized ``wo``
  and ``down``), and the embedding, final norm and head get the
  reference's within rel-L2 1e-4.
* ``launch/train.py`` on the CPU, and its refusals.

The reference's gradients are computed once per module (``jax.jit``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.tp import TPContext as JTPContext
from repro.data import Batches as JBatches
from repro.data import corpus_tokens as j_corpus_tokens
from repro.models.model import Model as JModel
from repro.training import optimizer as jopt
from repro.training import make_train_step as j_make_train_step
from repro.training import restore_checkpoint as j_restore
from repro.training import save_checkpoint as j_save
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.core.tp import TPContext
from repro_torch.data import Batches, corpus_tokens
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.model import Model
from repro_torch.training import (
    AdamWConfig, OptState, adamw_update, check_trainable, cosine_lr, init_opt_state,
    make_train_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.training.optimizer import leaves
from tests.test_torch_train_tp import FAMILIES, configs, make_batch, reference_grads, rel_l2
from tests.torch_tp_worker import loss_and_grads, to_numpy, torch_batch

torch.backends.cuda.matmul.allow_tf32 = False


# --------------------------------------------------------------------- data


def test_corpus_tokens_equal_reference():
    got, want = corpus_tokens(200_000), j_corpus_tokens(200_000)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_batches_draw_reference_windows():
    toks = corpus_tokens(200_000)
    got, want = Batches(toks, 4, 32, seed=0, device="cpu"), JBatches(toks, 4, 32, seed=0)
    halves = [Batches(toks, 4, 32, seed=0, device="cpu", rows=(r, 2)) for r in range(2)]
    for _ in range(3):
        b, w = got.next(), want.next()
        parts = [h.next() for h in halves]
        for k in ("tokens", "targets"):
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(w[k]))
            np.testing.assert_array_equal(torch.cat([p[k] for p in parts]).numpy(),
                                          b[k].numpy())


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("cfg", [AdamWConfig(), AdamWConfig(warmup_steps=3, total_steps=12,
                                                            lr=1e-3, min_lr_frac=0.2)])
def test_cosine_lr_matches_reference(cfg):
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    for step in list(range(0, 15)) + [99, 100, 101, 5000, 10_000, 12_000]:
        want = float(jopt.cosine_lr(jcfg, jnp.int32(step)))
        assert abs(cosine_lr(cfg, step) - want) <= 1e-6 * abs(want), step


def _tree(rng, dtype):
    """A small parameter tree (dict of dicts and a list) as numpy fp32 values
    already rounded to ``dtype``."""
    shapes = {"a": {"w": (8, 16), "b": (16,)}, "layers": [{"w": (4, 4, 3)}, {"w": (32,)}]}
    make = lambda s: np.asarray(jnp.asarray(rng.normal(size=s), dtype).astype(jnp.float32))
    return jax.tree.map(make, shapes, is_leaf=lambda x: isinstance(x, tuple))


def _bits16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16).astype(np.int64)


@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clip-binds", "clip-free"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, clip):
    rng = np.random.default_rng(7)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    jdt, tdt = jnp.dtype(dtype), {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    p_np = _tree(rng, jdt)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = jax.tree.map(lambda a: torch.tensor(a).to(tdt), p_np)
    jstate, tstate = jopt.init_opt_state(jp), init_opt_state(tp)
    for step in range(3):
        g_np = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), p_np)
        jp, jstate, jm = jopt.adamw_update(jcfg, jp, jax.tree.map(
            lambda a: jnp.asarray(a, jdt), g_np), jstate)
        tp, tstate, tm = adamw_update(cfg, tp, jax.tree.map(
            lambda a: torch.tensor(a).to(tdt), g_np), tstate)
        assert (float(jm["grad_norm"]) > clip) == (clip == 0.5)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(
            jm["grad_norm"])
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert tstate.step == int(jstate.step) == step + 1
        for got, want in zip(leaves(tp), jax.tree.leaves(jp)):
            want = np.asarray(want.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())
            else:
                assert np.abs(_bits16(got.float().numpy()) - _bits16(want)).max() <= 1
        for tm_, jm_ in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            for got, want in zip(leaves(tm_), jax.tree.leaves(jm_)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                           atol=1e-6 * np.abs(np.asarray(want)).max())


# -------------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def ckpt_state():
    """The reference's reduced internlm2 state in bf16 with random moments
    at step 3, and the port's copy of it."""
    cfg_j, cfg_t = configs("internlm2")
    cfg_j, cfg_t = (dataclasses.replace(c, dtype="bfloat16") for c in (cfg_j, cfg_t))
    params = JModel(cfg_j).init_params(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    mu = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), params)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.random(size=a.shape), jnp.float32), params)
    jstate = {"params": params, "opt": jopt.OptState(mu=mu, nu=nu, step=jnp.int32(3))}
    to_np = lambda t: jax.tree.map(np.asarray, t)
    tstate = {"params": params_from_numpy(to_np(params), cfg_t, "cpu"),
              "opt": opt_state_from_numpy(jopt.OptState(mu=to_np(mu), nu=to_np(nu), step=3),
                                          cfg_t, "cpu")}
    return jstate, tstate


def _bits(x):
    a = np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                   jnp.asarray(x).astype(jnp.float32))
    return a.view(np.uint32)


def _same_state(jstate, tstate):
    for j, t in ((jstate["params"], tstate["params"]), (jstate["opt"].mu, tstate["opt"].mu),
                 (jstate["opt"].nu, tstate["opt"].nu)):
        jl, tl = jax.tree.leaves(j), leaves(t)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(jstate["opt"].step) == tstate["opt"].step


def test_port_checkpoint_restores_in_reference(ckpt_state, tmp_path):
    jstate, tstate = ckpt_state
    save_checkpoint(str(tmp_path / "port"), tstate, step=3)
    meta = json.loads((tmp_path / "port.json").read_text())
    assert meta["step"] == 3 and meta["keys"]["opt::step"]["dtype"] == "int32"
    assert meta["keys"]["params::layers::0::core::wq::w"]["dtype"] == "bfloat16"
    _same_state(j_restore(str(tmp_path / "port"), jstate), tstate)


def test_reference_checkpoint_restores_in_port(ckpt_state, tmp_path):
    jstate, tstate = ckpt_state
    j_save(str(tmp_path / "ref"), jstate, step=3)
    like = jax.tree.map(torch.zeros_like, {"params": tstate["params"]})
    like["opt"] = OptState(mu=jax.tree.map(torch.zeros_like, tstate["opt"].mu),
                           nu=jax.tree.map(torch.zeros_like, tstate["opt"].nu), step=0)
    _same_state(jstate, restore_checkpoint(str(tmp_path / "ref"), like))


# ------------------------------------------------------------- Model.loss


_REFERENCE = {}


def _reference(key):
    """(reference params as numpy, batch, loss, metrics, gradient), cached."""
    if key not in _REFERENCE:
        cfg_j, cfg_t = configs(key)
        model_j = JModel(cfg_j)
        params_j = model_j.init_params(jax.random.PRNGKey(0))
        batch = make_batch(cfg_t)
        fn = jax.jit(jax.value_and_grad(lambda p, b: model_j.loss(JTPContext(mesh=None), p, b),
                                        has_aux=True))
        (loss, metrics), g = fn(params_j, {k: jnp.asarray(v) for k, v in batch.items()})
        _REFERENCE[key] = (jax.tree.map(np.asarray, params_j), batch, float(loss),
                           {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, g))
    return _REFERENCE[key]


@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
@pytest.mark.parametrize("key", list(FAMILIES))
def test_loss_and_gradients_match_reference(key, remat):
    params_np, batch, loss_j, metrics_j, grads_j = _reference(key)
    _, cfg = configs(key)
    loss, metrics, grads = loss_and_grads(Model(cfg), params_from_numpy(params_np, cfg, "cpu"),
                                          TPContext(remat=remat), torch_batch(batch))
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
    assert set(metrics) == set(metrics_j)
    if cfg.n_experts:
        assert {"load_balance", "router_z"} <= set(metrics)
    for k, v in metrics.items():
        assert abs(v - metrics_j[k]) <= 1e-5 * max(1.0, abs(metrics_j[k])), k
    for i, (g, w) in enumerate(zip(leaves(to_numpy(grads)), jax.tree.leaves(grads_j))):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= 1e-5 or np.abs(g - w).max() <= 1e-7, (key, i, rel_l2(g, w))


def test_simulated_compressed_gradient_is_zero():
    params_np, batch, _, _, _ = _reference("internlm2")
    cfg_j, cfg = configs("internlm2")
    ctx_j = JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2)
    loss_j, g_j = reference_grads(JModel(cfg_j), jax.tree.map(jnp.asarray, params_np), batch,
                                  ctx_j)
    loss, _, g = loss_and_grads(Model(cfg), params_from_numpy(params_np, cfg, "cpu"),
                                TPContext(policy=PAPER_DEFAULT, simulate_tp=2),
                                torch_batch(batch))
    assert abs(loss - loss_j) <= 1e-4 * abs(loss_j)
    # every layer's output reaches the loss only through wo's and down's
    # quantized reductions: no gradient reaches any layer leaf
    for got, want in zip(leaves(g["layers"]), jax.tree.leaves(g_j["layers"])):
        assert not np.asarray(want).any() and not got.any()
    # the embedding, final norm and head still learn, as the reference's do
    for name in ("embed", "final_norm", "lm_head"):
        got, want = g[name]["w"].numpy(), np.asarray(g_j[name]["w"])
        assert np.abs(want).max() > 0 and rel_l2(got, want) <= 1e-4, name


# --------------------------------------------------------------- train step


def test_train_steps_match_reference():
    params_np, _, _, _, _ = _reference("internlm2")
    cfg_j, cfg = configs("internlm2")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batches = [make_batch(cfg, rows=2, seq=24, seed=s) for s in (1, 2, 3)]
    jstep = jax.jit(j_make_train_step(JModel(cfg_j), JTPContext(mesh=None),
                                      jopt.AdamWConfig(**dataclasses.asdict(opt))))
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = {"params": jparams, "opt": jopt.init_opt_state(jparams)}
    model = Model(cfg)
    params = params_from_numpy(params_np, cfg, "cpu")
    state = {"params": params, "opt": init_opt_state(params)}
    step = make_train_step(model, TPContext(), opt)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, torch_batch(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    for g, w in zip(leaves(to_numpy(state["params"])), jax.tree.leaves(jstate["params"])):
        assert rel_l2(g, np.asarray(w)) <= 1e-5
    for g, w in zip(leaves(to_numpy(state["opt"].nu)), jax.tree.leaves(jstate["opt"].nu)):
        assert rel_l2(g, np.asarray(w)) <= 1e-5


# -------------------------------------------------------------------- launch


def test_launch_train_on_cpu(tmp_path, capsys):
    logged = train_cli.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "12",
                             "--batch", "4", "--seq", "32", "--log-every", "4", "--device",
                             "cpu", "--checkpoint", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "policy=uncompressed" in out and "saved" in out
    losses = [m["loss"] for m in logged]
    assert [m["step"] for m in logged] == [0, 4, 8, 11]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    meta = json.loads((tmp_path / "ck.json").read_text())
    assert meta["step"] == 12 and meta["keys"]["opt::step"]["shape"] == []


@pytest.mark.parametrize("argv, err", [
    (["--arch", "internlm2-1.8b", "--tp", "2"], "Queue 3 item 11"),
    (["--arch", "mixtral-8x22b", "--dp", "2"], "Queue 1 item 1"),
])
def test_launch_train_refusals(argv, err):
    """The CLI refuses before any rank starts, through the library's
    ``check_trainable`` (which ``make_train_step`` applies on its groups):
    a MoE on data ranks from the flags alone, ``keep_local_fp`` on TP ranks
    (no flag asks for it) from the policy the caller builds."""
    args = train_cli._parser().parse_args(argv + ["--reduced", "--device", "cpu"])
    policy = train_cli.build_policy(args)
    if err == "Queue 3 item 11":
        policy = dataclasses.replace(policy, keep_local_fp=True)
    with pytest.raises((ValueError, NotImplementedError), match=err):
        check_trainable(train_cli.train_config(args), policy, args.tp, args.dp)
    if err == "Queue 1 item 1":
        with pytest.raises(NotImplementedError, match=err):
            train_cli.main(argv + ["--reduced", "--device", "cpu"])
