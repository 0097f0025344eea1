"""Training across ``torch.distributed`` ranks against the reference.

One spawn of 2 gloo ranks (``tests/torch_tp_worker.py::run_train_rank``;
the ranks import torch and the port only) and, in this process, the
reference's ``Model.loss`` gradients (``jax.jit``) on the same numpy
weights and batches, in fp32 on reduced configs:

* each rank collective's backward on a (6, 64) partial: the compressed
  reduction (gather, ``overlap_chunks=2``, ``two_phase``, a bf16
  accumulator, a bf16 partial) hands the cotangent back unchanged in the
  partial's dtype with no collective (the STE); ``rank_psum`` likewise;
  ``rank_all_gather`` keeps the rank's slice; ``copy_to_group`` sums the
  ranks' gradients with one backward all-reduce;
* dense, six families (internlm2; mixtral with its aux losses, 80 tokens:
  the sort-based dispatch; jamba's Mamba, Mamba + MoE and attention layers;
  xlstm at d_model 384; whisper with 24 encoder frames; pixtral with 8
  patches): the loss within 1e-5 and each leaf of the gathered gradient
  (``convert.gather_params``) within rel-L2 1e-5 of the single-device
  reference's, and the gradient bit-equal on both ranks (a missing
  ``copy_to_group`` leaves a replicated leaf a share of its gradient on
  each rank; a doubled one doubles it);
* compressed (PAPER_DEFAULT), internlm2 and xlstm: the loss within rel
  1e-4, and moved from the port's dense loss by more than that, and each
  leaf of the gathered gradient within rel-L2 ``max(1e-4, 3 s)`` of the
  reference's single-device straight-through emulation: ``Model.loss``
  under ``simulate_tp=2`` with ``repro.core.mx.fake_quantize`` replaced,
  here only, by ``x + stop_gradient(fake_quantize(x) - x)``. ``s`` is that
  leaf's own spread in the emulation: its rel-L2 between the emulation and
  the emulation on weights moved by a relative 1e-7 (fp32 rounding-sized
  noise). A GEMM that rounds otherwise flips a few fp4 codes, and the STE
  carries each flip into the gradient: internlm2's leaves spread about
  1e-6 (the bound is 1e-4), xlstm's up to about 1e-2, since its recurrences
  amplify the flips (the port's rank path against the port's own
  single-device emulation moves as much);
* ``make_train_step`` refuses reduced mixtral on the data group and
  ``keep_local_fp`` on the TP group;
* two train steps of reduced internlm2 on the TP group and on a data group
  of the same two ranks (each rank its half of the global batch): the
  losses and the whole weights after them equal the single-rank port's on
  the global batch (within 1e-5 / rel-L2 1e-5), the optimizer's one
  all-reduce a step (the TP norm, the data group's gradient average) and
  the TP forward's and backward's all-reduces counted apart;
* a checkpoint saved on the TP group (the first rank writes the gathered
  state) holds the one-rank checkpoint's arrays, bit for bit, and a
  one-rank checkpoint restored on the ranks gives each its shard.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mx as reference_mx
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.tp import TPContext as JTPContext
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tp import TPContext
from repro_torch.launch import mesh
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.models.model import Model
from repro_torch.training import AdamWConfig, init_train_state, make_train_step, save_checkpoint
from repro_torch.training.optimizer import leaves
from tests.conftest import fp32_reduced
from tests.torch_tp_worker import STE_CASES, run_train_rank, to_numpy, torch_batch

torch.backends.cuda.matmul.allow_tf32 = False

# job key -> (arch, overrides of the reduced config: kv heads and widths that
# divide over 2 ranks, a few patches, 24 encoder frames; layers)
FAMILIES = {
    "internlm2": ("internlm2-1.8b", {}, 2),
    "mixtral": ("mixtral-8x22b", {}, 2),
    "jamba": ("jamba-v0.1-52b", {}, 3),
    "xlstm": ("xlstm-125m", dict(d_model=384), 2),
    "whisper": ("whisper-medium", dict(encoder_seq=24), 2),
    "pixtral": ("pixtral-12b", dict(n_kv_heads=2, n_patches=8), 2),
}
COMPRESSED = ("internlm2", "xlstm")
LOSS_REL, GRAD_REL = 1e-4, 1e-4   # the compressed comparison's limits
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def configs(key):
    """(reference config, port config) of a family, reduced, fp32."""
    arch, over, layers = FAMILIES[key]
    width = {k: over[k] for k in ("d_model",) if k in over}
    rest = {k: v for k, v in over.items() if k not in width}
    cfg_j = dataclasses.replace(fp32_reduced(arch, n_layers=layers, **width), **rest)
    cfg_t = dataclasses.replace(reduced_config(get_config(arch), n_layers=layers, **width),
                                dtype="float32", **rest)
    return cfg_j, cfg_t


def make_batch(cfg, rows=2, seq=40, seed=0):
    """Tokens and targets (rows, seq) and a model's extra inputs, from numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.normal(size=(rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        b["encoder_frames"] = rng.normal(size=(rows, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return b


def reference_grads(model_j, params_j, batch, ctx):
    """(loss, gradient as numpy) of the reference's ``Model.loss``."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: model_j.loss(ctx, p, b)[0]))
    loss, g = fn(params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, g)


def ste_fake_quantize(fake_quantize):
    """The straight-through form of the reference's ``fake_quantize``."""
    def ste(x, spec):
        return x + jax.lax.stop_gradient(fake_quantize(x, spec) - x)
    return ste


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    job = {"grads": {}}
    reference = {}
    for key in FAMILIES:
        cfg_j, cfg_t = configs(key)
        model_j = JModel(cfg_j)
        params_j = model_j.init_params(jax.random.PRNGKey(0))
        batch = make_batch(cfg_t)
        reference[key] = {"dense": reference_grads(model_j, params_j, batch,
                                                   JTPContext(mesh=None))}
        if key in COMPRESSED:
            ctx = JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=2)
            rng = np.random.default_rng(3)
            nudged = jax.tree.map(
                lambda a: (a * (1 + 1e-7 * rng.normal(size=a.shape))).astype(a.dtype), params_j)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(reference_mx, "fake_quantize",
                           ste_fake_quantize(reference_mx.fake_quantize))
                reference[key]["compressed"] = reference_grads(model_j, params_j, batch, ctx)
                reference[key]["nudged"] = reference_grads(model_j, nudged, batch, ctx)
        job["grads"][key] = dict(cfg=cfg_t, params=jax.tree.map(np.asarray, params_j),
                                 batch=batch, compressed=key in COMPRESSED)
    _, cfg = configs("internlm2")
    params_np = job["grads"]["internlm2"]["params"]
    batches = [make_batch(cfg, rows=4, seq=24, seed=s) for s in (1, 2)]
    job["steps"] = dict(cfg=cfg, params=params_np, batches=batches, opt_cfg=OPT)

    # the checkpoint: the reference's weights, random moments, step 3
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params_np)
    nu = jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32), params_np)
    tmp = tmp_path_factory.mktemp("ckpt")
    single = _one_rank_state(cfg, params_np, mu, nu, 3)
    save_checkpoint(str(tmp / "single"), single, step=3)
    job["checkpoint"] = dict(cfg=cfg, params=params_np, mu=mu, nu=nu, step=3,
                             path=str(tmp / "ranks"), restore=str(tmp / "single"))

    ranks = mesh.spawn_ranks(run_train_rank, 2, job, device="cpu", threads=2, timeout_s=600)
    single_steps = _single_steps(cfg, params_np, batches)
    return dict(job=job, reference=reference, ranks=ranks, single_steps=single_steps, tmp=tmp)


def _one_rank_state(cfg, params_np, mu, nu, step):
    from repro_torch.models.convert import opt_state_from_numpy
    from repro_torch.training.optimizer import OptState

    return {"params": params_from_numpy(params_np, cfg, "cpu"),
            "opt": opt_state_from_numpy(OptState(mu=mu, nu=nu, step=step), cfg, "cpu")}


def _single_steps(cfg, params_np, batches):
    """The one-rank port's train steps on the global batches."""
    model = Model(cfg)
    state = init_train_state(model, params_from_numpy(params_np, cfg, "cpu"))
    step = make_train_step(model, TPContext(), OPT)
    losses = []
    for b in batches:
        state, metrics = step(state, torch_batch(b))
        losses.append(float(metrics["loss"]))
    return dict(losses=losses, params=to_numpy(state["params"]))


@pytest.mark.parametrize("name", list(STE_CASES) + ["rank_psum", "rank_all_gather",
                                                    "copy_to_group"])
def test_rank_collective_backward(name, trained):
    cot = torch.randn(6, 64, generator=torch.Generator().manual_seed(12)).numpy()
    for rank, r in enumerate(trained["ranks"]):
        got = r["backward"][name]
        f, b = got["forward"], got["backward"]
        if name == "copy_to_group":
            want = cot * 3   # (1 + 2) x the cotangent: both ranks' shares
            assert b["backward_all_reduce"] == 1 and b["backward_bytes"] == cot.nbytes
        elif name == "rank_all_gather":   # the rank gathered its first 32 columns
            want = np.zeros_like(cot)
            want[:, :32] = cot[:, rank * 32:(rank + 1) * 32]
        else:
            want = cot
        if name == "bf16":
            want = torch.from_numpy(want).bfloat16().float().numpy()
            assert got["dtype"] == got["out_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(got["grad"], want)
        if name != "copy_to_group":   # no collective in the backward
            assert b == f and f["all_gather"] + f["all_reduce"] + f["all_to_all"] \
                + f["dense_all_gather"] > 0
        assert f["backward_all_reduce"] == 0


@pytest.mark.parametrize("key", list(FAMILIES))
def test_dense_rank_gradients_match_reference(key, trained):
    loss_j, grads_j = trained["reference"][key]["dense"]
    got = [r["grads"][key]["dense"] for r in trained["ranks"]]
    assert abs(got[0]["loss"] - loss_j) <= 1e-5 * max(1.0, abs(loss_j))
    want = jax.tree.leaves(grads_j)
    for i, (g, w) in enumerate(zip(leaves(got[0]["grads"]), want)):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= 1e-5 or np.abs(g - w).max() <= 1e-7, (key, i, rel_l2(g, w))
    for other in got[1:]:
        assert other["loss"] == got[0]["loss"]
        for g0, g1 in zip(leaves(got[0]["grads"]), leaves(other["grads"])):
            np.testing.assert_array_equal(g0, g1)


@pytest.mark.parametrize("key", COMPRESSED)
def test_compressed_rank_gradients_match_ste_emulation(key, trained):
    loss_j, grads_j = trained["reference"][key]["compressed"]
    got = [r["grads"][key]["compressed"] for r in trained["ranks"]]
    dense = trained["ranks"][0]["grads"][key]["dense"]["loss"]
    # the codec moved the port's forward by more than the loss limit
    assert abs(got[0]["loss"] - dense) > LOSS_REL * abs(dense), (got[0]["loss"], dense)
    assert abs(got[0]["loss"] - loss_j) <= LOSS_REL * abs(loss_j)
    want = jax.tree.leaves(grads_j)
    spreads = [rel_l2(a, b) for a, b in zip(jax.tree.leaves(trained["reference"][key]
                                                             ["nudged"][1]), want)]
    print(f"{key}: per-leaf spread of the emulation {min(spreads):.3e} .. {max(spreads):.3e}")
    for i, (g, w, spread) in enumerate(zip(leaves(got[0]["grads"]), want, spreads)):
        bound = max(GRAD_REL, 3 * spread)
        assert rel_l2(g, w) <= bound or np.abs(g - w).max() <= 1e-7, (key, i, rel_l2(g, w),
                                                                       bound)
    for g0, g1 in zip(leaves(got[0]["grads"]), leaves(got[1]["grads"])):
        np.testing.assert_array_equal(g0, g1)


@pytest.mark.parametrize("case, err", [
    ("moe/dp", ("NotImplementedError", "Queue 1 item 1")), ("moe/tp", None),
    ("keep_local_fp/tp", ("ValueError", "Queue 3 item 11")), ("keep_local_fp/dp", None),
])
def test_make_train_step_refusals(case, err, trained):
    """``make_train_step`` refuses reduced mixtral on a 2-rank data group
    (the island has no backward: its gradients would be zeros) and
    ``keep_local_fp`` on a TP group, and builds both on the other group."""
    for r in trained["ranks"]:
        got = r["refusals"][case]
        if err is None:
            assert got is None
        else:
            assert got is not None and got[0] == err[0] and err[1] in got[1], got


@pytest.mark.parametrize("group", ["tp_steps", "dp_steps"])
def test_rank_train_steps_equal_one_rank_on_global_batch(group, trained):
    want = trained["single_steps"]
    for r in trained["ranks"]:
        got = r[group]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for g, w in zip(leaves(got["params"]), leaves(want["params"])):
            assert rel_l2(g, w) <= 1e-5
        c = got["counts"]
        assert c["grad_all_reduce"] == 1   # the TP norm, or the data group's average
        layers = trained["job"]["steps"]["cfg"].n_layers
        if group == "tp_steps":
            # forward: wo and down reduced densely; backward: one copy_to_group
            # for q/k/v and one for gate/up per layer
            assert c["all_reduce"] == 2 * layers and c["backward_all_reduce"] == 2 * layers
        else:
            assert c["all_reduce"] == 0 and c["backward_all_reduce"] == 0
            n_params = sum(a.size for a in leaves(want["params"]))
            assert c["grad_bytes"] == 4 * (n_params + 2)   # fp32 gradients, loss and ce


def test_rank_checkpoint_equals_one_rank_checkpoint(trained):
    tmp = trained["tmp"]
    single, ranks = np.load(tmp / "single.npz"), np.load(tmp / "ranks.npz")
    assert sorted(single.files) == sorted(ranks.files)
    for k in single.files:
        assert single[k].dtype == ranks[k].dtype
        np.testing.assert_array_equal(single[k], ranks[k], err_msg=k)
    assert (json.loads((tmp / "single.json").read_text())
            == json.loads((tmp / "ranks.json").read_text()))


def test_rank_restore_gives_each_rank_its_shard(trained):
    ck = trained["job"]["checkpoint"]
    for rank, r in enumerate(trained["ranks"]):
        got = r["checkpoint"]
        assert got["step"] == ck["step"]
        for name in ("params", "mu"):
            want = shard_params(ck[name], ck["cfg"], rank, 2)
            for g, w in zip(leaves(got[name]), leaves(want)):
                np.testing.assert_array_equal(g, w)
