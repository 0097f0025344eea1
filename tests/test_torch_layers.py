"""The port's TP layers and compressed reduction against the JAX reference.

``row_linear`` under ``simulate_tp`` = 2 and 4 with ``PAPER_DEFAULT``
(fp4_e2m1, block 32, e8m0) against the reference's
``row_linear(TPContext(mesh=None, policy=PAPER_DEFAULT, simulate_tp=N))``.
The two frameworks' fp32 matmuls sum in different orders, so a partial sum
that lands within rounding of a quantization midpoint can take the
neighbouring code in one of them. Tolerance: every output within one code
step (the format's largest gap between neighbouring codes) times its block's
scale per shard, rel-L2 <= 1e-4, and at most 0.1% of codes flipped; the test
prints the flip count. A dense policy equals a plain matmul. The reduction
options ``two_phase``, ``keep_local_fp``, ``overlap_chunks`` and a bf16
``accum_dtype`` are served on the simulated path as the reference serves them
(the same tolerance), and the stacked reduction (``psum_maybe_compressed``
without a group) still refuses them (the rank collectives that give them
their meaning are held in ``tests/test_torch_tp.py``). TF32 is off for
torch matmuls in this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.tp import TPContext as JTPContext
from repro.core.tp import row_linear as j_row_linear
from repro_torch.core import mx as tmx
from repro_torch.core.collectives import compressed_psum, psum, psum_maybe_compressed
from repro_torch.core.policy import NO_COMPRESSION, PAPER_DEFAULT, CompressionPolicy
from repro_torch.core.tp import TPContext, column_linear, row_linear
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _inputs(seed, tokens=24, fin=256, fout=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, tokens, fin)).astype(np.float32)
    w = (rng.normal(size=(fin, fout)) * fin**-0.5).astype(np.float32)
    return x, w


def _partials_np(x, w, n):
    fin = x.shape[-1]
    xs = x.reshape(-1, n, fin // n).transpose(1, 0, 2)
    return np.matmul(xs, w.reshape(n, fin // n, -1))          # (n, M, fout)


@pytest.mark.parametrize("n", [2, 4])
def test_row_linear_simulated_tp_matches_reference(n, capsys):
    x, w = _inputs(n)
    ref = np.asarray(j_row_linear(JTPContext(mesh=None, policy=J_PAPER_DEFAULT, simulate_tp=n),
                                  jnp.asarray(x), jnp.asarray(w)))
    got = row_linear(TPContext(policy=PAPER_DEFAULT, simulate_tp=n),
                     torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape == (1, 24, 128)

    spec = PAPER_DEFAULT.spec
    parts_t = torch.matmul(torch.from_numpy(x).reshape(-1, n, 256 // n).transpose(0, 1),
                           torch.from_numpy(w).reshape(n, 256 // n, -1))
    codes_t, e_t = tmx.quantize_codes(parts_t, spec)
    codes_j, _ = jmx.quantize_codes(jnp.asarray(_partials_np(x, w, n)), J_PAPER_DEFAULT.spec)
    flips = int((codes_t.numpy() != np.asarray(codes_j)).sum())
    with capsys.disabled():
        print(f"\nrow_linear simulate_tp={n}: {flips} of {codes_t.numel()} codes flipped")
    assert flips <= 1e-3 * codes_t.numel()

    gap = float(np.diff(spec.elem.code_values).max())
    step = gap * torch.pow(2.0, e_t.float()).amax(dim=0)      # (M, n_blocks)
    bound = step.repeat_interleave(spec.block_size, dim=-1).reshape(got.shape).numpy()
    assert (np.abs(got - ref) <= bound + 1e-5 * np.abs(ref)).all()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-4


@pytest.mark.parametrize("ctx", [TPContext(), TPContext(simulate_tp=4),
                                 TPContext(policy=PAPER_DEFAULT)])
def test_dense_row_linear_is_a_plain_matmul(ctx):
    """No active compression (no policy, or no simulated shards): a plain
    matmul, and the reference computes the same."""
    x, w = _inputs(5)
    got = row_linear(ctx, torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), (torch.from_numpy(x) @ torch.from_numpy(w)).numpy())
    ref = j_row_linear(JTPContext(mesh=None), jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_linear_bias_added_once():
    x, w = _inputs(6)
    b = torch.arange(128, dtype=torch.float32)
    ctx = TPContext(policy=PAPER_DEFAULT, simulate_tp=2)
    y0 = row_linear(ctx, torch.from_numpy(x), torch.from_numpy(w))
    y1 = row_linear(ctx, torch.from_numpy(x), torch.from_numpy(w), b)
    np.testing.assert_array_equal((y1 - y0).numpy(), np.broadcast_to(b.numpy(), y0.shape))
    yc = column_linear(ctx, torch.from_numpy(x), torch.from_numpy(w), b)
    np.testing.assert_allclose(yc.numpy(), x @ w + b.numpy(), rtol=1e-5, atol=1e-5)


def test_compressed_psum_is_quantize_then_ordered_fp32_sum():
    parts = torch.from_numpy(_partials_np(*_inputs(7), 4))
    spec = PAPER_DEFAULT.spec
    got = compressed_psum(parts, spec)
    want = sum(tmx.dequantize(tmx.quantize(parts[i], spec), spec) for i in range(4))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_psum_maybe_compressed_gate():
    parts = torch.from_numpy(_partials_np(*_inputs(8, tokens=4), 2))   # 4 tokens
    spec = PAPER_DEFAULT.spec
    np.testing.assert_array_equal(psum_maybe_compressed(parts, None).numpy(), psum(parts).numpy())
    # below min_tokens (8): the plain ordered sum
    np.testing.assert_array_equal(psum_maybe_compressed(parts, PAPER_DEFAULT).numpy(),
                                  (parts[0] + parts[1]).numpy())
    low = CompressionPolicy(spec=spec, min_tokens=2)
    np.testing.assert_array_equal(psum_maybe_compressed(parts, low).numpy(),
                                  compressed_psum(parts, spec).numpy())
    assert not NO_COMPRESSION.active_for(1024)


def _reference_row_linear(x, w, n, **option):
    policy = dataclasses.replace(J_PAPER_DEFAULT, **option)
    return np.asarray(j_row_linear(JTPContext(mesh=None, policy=policy, simulate_tp=n),
                                   jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("option, match", [
    (dict(variant="two_phase"), "two_phase"), (dict(keep_local_fp=True), "keep_local_fp"),
    (dict(overlap_chunks=2), "overlap_chunks"), (dict(accum_dtype="bfloat16"), "accum_dtype")])
def test_two_phase_raises_instead_of_downgrading(option, match):
    """On the simulated path each option is served as the reference serves
    it: ``two_phase`` re-quantizes the reduced result once more (exactly the
    codec's quantize + dequantize of the gather variant's result), the other
    three change nothing; against the reference's ``row_linear`` under
    ``simulate_tp=2`` within the tolerance of the gather variant's test. The
    stacked reduction has no ranks to give the options their meaning (the
    rank collective, ``group=``, does): it raises, and none is silently
    served by the gather variant."""
    x, w = _inputs(9)
    policy = CompressionPolicy(spec=PAPER_DEFAULT.spec, **option)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = row_linear(TPContext(policy=policy, simulate_tp=2), xt, wt)
    gather = row_linear(TPContext(policy=PAPER_DEFAULT, simulate_tp=2), xt, wt)
    if option.get("variant") == "two_phase":
        spec = PAPER_DEFAULT.spec
        want = ops.mx_dequantize(ops.mx_quantize(gather, spec), spec, out_dtype=gather.dtype)
        assert not torch.equal(want, gather)
    else:
        want = gather
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = _reference_row_linear(x, w, 2, **option)
    assert got.shape == ref.shape
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= 1e-4

    parts = torch.from_numpy(_partials_np(x, w, 2))
    with pytest.raises(NotImplementedError, match=match):
        psum_maybe_compressed(parts, policy)
    if "variant" in option:
        with pytest.raises(NotImplementedError, match=match):
            compressed_psum(parts, PAPER_DEFAULT.spec, variant="two_phase")


def test_two_phase_second_quantize_is_byte_exact_on_reference_y():
    """The port's second quantize of the reference's own reduced result
    (its gather variant's ``y``) gives the reference's codes and scales on
    every block where the reference's ``jnp.exp2`` of the scale is exact
    (ROADMAP Queue 3 item 2), and decodes there to the reference's
    two_phase output."""
    x, w = _inputs(10)
    spec = PAPER_DEFAULT.spec
    y = _reference_row_linear(x, w, 2).copy()                   # gather: the reduced y
    codes_t, e_t = tmx.quantize_codes(torch.from_numpy(y), spec)
    codes_j, e_j = jmx.quantize_codes(jnp.asarray(y), J_PAPER_DEFAULT.spec)
    e_j = np.asarray(e_j)
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    exact = np.asarray(jnp.exp2(jnp.asarray(e_j, jnp.float32))) == np.exp2(e_j.astype(np.float64))
    assert exact.mean() > 0.5
    blocks = lambda c: np.asarray(c).reshape(*e_j.shape, spec.block_size)
    np.testing.assert_array_equal(blocks(codes_t.numpy())[exact], blocks(codes_j)[exact])
    comp = ops.mx_quantize(torch.from_numpy(y), spec)
    jcomp = jmx.quantize(jnp.asarray(y), J_PAPER_DEFAULT.spec)
    np.testing.assert_array_equal(comp.scales.numpy(), np.asarray(jcomp.scales))
    two_phase = _reference_row_linear(x, w, 2, variant="two_phase")
    got = ops.mx_dequantize(comp, spec, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(blocks(got)[exact], blocks(two_phase)[exact])


def test_two_phase_logits_of_reduced_llama2_match_reference():
    """Whole-prompt prefill of reduced llama2 (fp32, the reference's weights)
    with ``variant="two_phase"`` under ``simulate_tp=2``: logits within the
    module tolerance of the compressed path, rel-L2 5e-2 (a code flip in one
    framework propagates through later layers, ``tests/test_torch_prefill.py``),
    and the second quantize moves them from the gather variant's."""
    from repro.models.model import Model as JModel
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import Model
    from tests.conftest import fp32_reduced

    cfg_j = fp32_reduced("llama2-7b")
    cfg_t = dataclasses.replace(reduced_config(get_config("llama2-7b")), dtype="float32")
    model_j, model_t = JModel(cfg_j), Model(cfg_t)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t, "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg_t.vocab_size, (1, 24)).astype(np.int32)
    logits = {}
    for variant in ("gather", "two_phase"):
        ctx_j = JTPContext(mesh=None, simulate_tp=2,
                           policy=dataclasses.replace(J_PAPER_DEFAULT, variant=variant))
        ctx_t = TPContext(policy=CompressionPolicy(spec=PAPER_DEFAULT.spec, variant=variant),
                          simulate_tp=2)
        lj, _ = model_j.prefill(ctx_j, params_j, {"tokens": jnp.asarray(tokens)},
                                model_j.init_cache(1, 24, jnp.float32))
        lt, _ = model_t.prefill(ctx_t, params_t, {"tokens": torch.from_numpy(tokens)},
                                model_t.init_cache(1, 24, torch.float32, "cpu"))
        lj, lt = np.asarray(lj), lt.numpy()
        assert np.isfinite(lt).all() and lt.shape == lj.shape
        assert np.linalg.norm(lt - lj) / np.linalg.norm(lj) <= 5e-2, variant
        logits[variant] = lt
    assert not np.array_equal(logits["gather"], logits["two_phase"])


def test_gate_policy_matches_reference():
    for n_pre, n_dec in [(0, 4), (4, 4), (16, 2), (2, 16), (256, 4), (3, 3)]:
        assert PAPER_DEFAULT.active_for_step(n_pre, n_dec) == \
            J_PAPER_DEFAULT.active_for_step(n_pre, n_dec)
    assert TPContext(policy=PAPER_DEFAULT).without_compression().policy == NO_COMPRESSION
