"""The port's MX codec against the JAX reference.

* formats: code tables, midpoints, emax, wire bytes and effective bits equal
  the reference for every element x scale format; cache-spec strings parse
  the same (``+pallas`` included);
* packing: byte-identical to ``repro.core.packing`` for every width 1-8;
* quantize: payload and scale bytes equal ``repro.core.mx.quantize`` for
  all 13 element formats x blocks 8/16/32 x fp32/bf16 inputs on blocks whose
  amax is a positive normal float32 and whose shared exponent lies in
  [-12, 12]. Outside that range the reference scales by ``jnp.exp2``, which
  XLA on the CPU computes up to 3.6e-6 off the exact power of two, so its
  codes drift from exact rounding wherever a value sits that close to a
  midpoint (common for the 255-code formats); the port rounds exactly, which
  ``test_port_rounds_exactly_where_reference_exp2_drifts`` pins;
* edge blocks (zero, subnormal amax, NaN, +-inf): scale bytes equal, and the
  decoded values equal the reference's ``dequantize(quantize(x))``. The port
  stores a block whose exponent clamps below -126 as zero codes; the
  reference stores 0/0 or x/0 codes there (XLA flushes 2**-127 to zero) that
  its own dequantize also decodes as 0.0 — the port's bytes are pinned below;
* the plain versions of the three codec kernels against the reference's
  Pallas kernels run in interpret mode (``repro.kernels.ops``);
* the quantize kernel's code selection (a binary search over the midpoints
  padded with +inf, ``csrc/mx_common.cuh:search_code``), mirrored step for
  step, against ``torch.bucketize`` on every bf16 bit pattern at the extreme
  and central shared exponents and on every midpoint and its neighbours
  (the kernels' sources themselves run on the CPU in
  ``test_torch_codec_source.py``).

Everything runs on the CPU (the port's plain versions). TF32 is switched off
for every torch matmul in this file (it would only matter on a GPU).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core import packing as jpacking
from repro.core.formats import ELEMENT_FORMATS as J_ELEM
from repro.core.formats import KVCacheSpec as JKVCacheSpec
from repro.core.formats import MXSpec as JMXSpec
from repro.core.formats import SCALE_FORMATS as J_SCALE
from repro.kernels import ops as jops
from repro_torch.core import mx as tmx
from repro_torch.core import packing as tpacking
from repro_torch.core.formats import ELEMENT_FORMATS, SCALE_FORMATS, KVCacheSpec, MXSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.kernels import mx_dequant, mx_quant, ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FORMATS = sorted(ELEMENT_FORMATS)
# jnp.exp2 of an integer exponent on XLA-CPU is off an exact power of two by
# up to 3.6e-6 relative (222 of the 255 e8m0 exponents; measured), so values
# the reference scales with it carry that error; bytes are compared exactly
XLA_EXP2_RTOL = 4e-6


def _normal_blocks(rng, shape, block, lo=-1.0, hi=2.5):
    """Random values with per-block magnitudes 10**U(lo, hi): by default every
    block's amax is a positive normal fp32 whose shared exponent lies in
    [-12, 12] for every element format, where XLA's exp2 is exact."""
    x = rng.normal(size=shape)
    mag = 10.0 ** rng.uniform(lo, hi, size=shape[:-1] + (shape[-1] // block, 1))
    return (x.reshape(*shape[:-1], -1, block) * mag).reshape(shape).astype(np.float32)


def _both(x_np, dtype):
    """The same values as a torch tensor and a jax array, in fp32 or bf16."""
    if dtype == "bf16":
        xb = x_np.astype(ml_dtypes.bfloat16)
        return torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16), jnp.asarray(xb)
    return torch.from_numpy(x_np), jnp.asarray(x_np)


# ------------------------------------------------------------------ formats


@pytest.mark.parametrize("elem", FORMATS)
def test_element_formats_match_reference(elem):
    a, b = ELEMENT_FORMATS[elem], J_ELEM[elem]
    np.testing.assert_array_equal(a.code_values, b.code_values)
    np.testing.assert_array_equal(a.midpoints, b.midpoints)
    assert (a.emax, a.max_value, a.num_codes, a.bits) == (b.emax, b.max_value,
                                                         b.num_codes, b.bits)
    assert a.code_values[a.zero_code] == 0.0
    for scale in SCALE_FORMATS:
        for block in (8, 16, 32):
            s, r = MXSpec.make(elem, block, scale), JMXSpec.make(elem, block, scale)
            assert s.name == r.name
            assert s.effective_bits == r.effective_bits
            assert s.wire_bytes(256) == r.wire_bytes(256)
            assert tmx.wire_arrays_shape((3, 256), s) == jmx.wire_arrays_shape((3, 256), r)


def test_scale_formats_match_reference():
    assert sorted(SCALE_FORMATS) == sorted(J_SCALE)
    for name, s in SCALE_FORMATS.items():
        r = J_SCALE[name]
        assert (s.bias, s.min_exp, s.max_exp, s.bits) == (r.bias, r.min_exp, r.max_exp, r.bits)


@pytest.mark.parametrize("text", [
    "bf16", "none", "dense", "fp32", "bf16+pallas", "fp4_e2m1", "fp4_e2m1+pallas",
    "int8", "fp5_e2m2_b16_e8m0", "fp3_e1m1_b8_e5m0+pallas"])
def test_cache_spec_parse_matches_reference(text):
    a, b = KVCacheSpec.parse(text), JKVCacheSpec.parse(text)
    assert a.use_pallas == b.use_pallas and a.quantized == b.quantized
    assert (a.mx.name if a.mx else None) == (b.mx.name if b.mx else None)
    assert a.describe() == b.describe()


def test_cache_spec_parse_rejects_unknown():
    with pytest.raises(ValueError):
        KVCacheSpec.parse("fp4_e9m9")


# ------------------------------------------------------------------ packing


@pytest.mark.parametrize("bits", range(1, 9))
def test_packing_matches_reference(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, size=(3, 64)).astype(np.uint8)
    ref = np.asarray(jpacking.pack_codes(jnp.asarray(codes), bits))
    got = tpacking.pack_codes(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tpacking.unpack_codes(got, bits, 64)
    np.testing.assert_array_equal(back.numpy(), codes)


# ----------------------------------------------------------------- quantize


@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("elem", FORMATS)
def test_quantize_bytes_match_reference(elem, block):
    spec, jspec = MXSpec.make(elem, block), JMXSpec.make(elem, block)
    rng = np.random.default_rng(block)
    x_np = _normal_blocks(rng, (4, 128), block)
    for dtype in ("fp32", "bf16"):
        xt, xj = _both(x_np, dtype)
        got, ref = tmx.quantize(xt, spec), jmx.quantize(xj, jspec)
        np.testing.assert_array_equal(got.payload.numpy(), np.asarray(ref.payload))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
        # values: the reference scales by jnp.exp2, which XLA on the CPU
        # computes up to ~3.6e-6 off an exact power of two for most integer
        # exponents; the port's powers of two are exact (see XLA_EXP2_RTOL)
        np.testing.assert_allclose(
            tmx.dequantize(got, spec).numpy(), np.asarray(jmx.dequantize(ref, jspec)),
            rtol=XLA_EXP2_RTOL, atol=0)
        np.testing.assert_allclose(
            tmx.fake_quantize(xt.float(), spec).numpy(),
            np.asarray(jmx.fake_quantize(xj.astype(jnp.float32), jspec)),
            rtol=XLA_EXP2_RTOL, atol=0)


def _exact_codes(x: np.ndarray, spec) -> np.ndarray:
    """Round-to-nearest code indices computed exactly in float64."""
    blocks = x.astype(np.float64).reshape(*x.shape[:-1], -1, spec.block_size)
    amax = np.abs(blocks).max(axis=-1)
    e = np.clip(np.floor(np.log2(amax)) - spec.elem.emax, spec.scale.min_exp,
                spec.scale.max_exp)
    norm = blocks / np.exp2(e)[..., None]
    return np.searchsorted(spec.elem.midpoints, norm, side="left").reshape(x.shape)


@pytest.mark.parametrize("elem", ["int8", "fp8_e4m3"])
def test_port_rounds_exactly_where_reference_exp2_drifts(elem):
    """bf16 blocks with shared exponents far from 0 (magnitudes 1e-4 ..
    1e-3): bf16's 8-bit significands put many values exactly on a midpoint
    of the 255-code grids, where round-to-nearest takes the lower code. The
    port's codes are the exact ones; the reference's differ on some values,
    because it divides by XLA's inexact exp2 and so moves them off the tie."""
    spec, jspec = MXSpec.make(elem, 8), JMXSpec.make(elem, 8)
    x = _normal_blocks(np.random.default_rng(7), (8, 256), 8, lo=-4.0, hi=-3.0)
    xt, xj = _both(x, "bf16")
    got, _ = tmx.quantize_codes(xt, spec)
    exact = _exact_codes(xt.float().numpy(), spec)
    np.testing.assert_array_equal(got.numpy(), exact)
    ref, _ = jmx.quantize_codes(xj, jspec)
    assert (np.asarray(ref) != exact).sum() > 0


def _edge_rows():
    rows = np.ones((6, 32), np.float32)
    rows[0] = 0.0                           # zero block
    rows[1] = 1e-40                         # subnormal amax
    rows[2, 3] = np.nan                     # NaN block
    rows[3, 5] = np.inf                     # +inf block
    rows[4, 7] = -np.inf                    # -inf block
    rows[5] = 1e-39                         # larger subnormal amax
    return rows


@pytest.mark.parametrize("elem", ["fp4_e2m1", "int4", "fp8_e4m3", "fp5_e3m1"])
def test_edge_blocks_decode_like_reference(elem):
    spec, jspec = MXSpec.make(elem, 32), JMXSpec.make(elem, 32)
    x = _edge_rows()
    got = tmx.quantize(torch.from_numpy(x), spec)
    ref = jmx.quantize(jnp.asarray(x), jspec)
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    np.testing.assert_array_equal(tmx.dequantize(got, spec).numpy(),
                                  np.asarray(jmx.dequantize(ref, jspec)))
    # the port's bytes on blocks whose exponent clamps to e8m0's -127: zero codes
    codes, e = tmx.quantize_codes(torch.from_numpy(x), spec)
    low = (e < -126).numpy()[:, 0]
    assert low[[0, 1, 2, 5]].all() and not low[[3, 4]].any()
    assert (codes.numpy()[low] == spec.elem.zero_code).all()
    # inf blocks: +inf -> top code, -inf -> code 0, both decode to +-inf
    assert codes[3, 5] == spec.elem.num_codes - 1 and codes[4, 7] == 0


def test_nan_takes_top_code_where_the_scale_is_normal():
    """Under a scale format whose min_exp is a normal exponent (e4m0: -7), a
    NaN block keeps real codes and the NaN element takes the top code, as
    searchsorted sorts NaN last in the reference."""
    spec, jspec = MXSpec.make("fp4_e2m1", 8, "e4m0"), JMXSpec.make("fp4_e2m1", 8, "e4m0")
    x = np.linspace(-0.05, 0.05, 16, dtype=np.float32).reshape(2, 8)
    x[0, 2] = np.nan
    got, ref = tmx.quantize(torch.from_numpy(x), spec), jmx.quantize(jnp.asarray(x), jspec)
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(ref.payload))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))


def test_pow2_is_exact():
    k = torch.arange(-149, 128, dtype=torch.int32)
    np.testing.assert_array_equal(tmx.pow2(k).numpy(),
                                  np.ldexp(np.float32(1), k.numpy()).astype(np.float32))


# ------------------------------------------- plain kernels vs Pallas (interpret)


@pytest.mark.parametrize("elem", ["fp4_e2m1", "fp3_e1m1", "fp5_e2m2", "int8", "fp8_e4m3"])
def test_plain_quant_matches_pallas(elem):
    spec, jspec = MXSpec.make(elem, 32), JMXSpec.make(elem, 32)
    x_np = _normal_blocks(np.random.default_rng(1), (16, 256), 32)
    for dtype in ("fp32", "bf16"):
        xt, xj = _both(x_np, dtype)
        got = mx_quant.mx_quantize_2d(xt, spec)
        ref = jops.mx_quantize(xj, jspec)
        np.testing.assert_array_equal(got.payload.numpy(), np.asarray(ref.payload))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))


@pytest.mark.parametrize("elem", ["fp4_e2m1", "fp6_e3m2", "int5"])
def test_plain_dequant_matches_pallas(elem):
    spec, jspec = MXSpec.make(elem, 32), JMXSpec.make(elem, 32)
    x_np = _normal_blocks(np.random.default_rng(2), (16, 256), 32)
    ref_c = jmx.quantize(jnp.asarray(x_np), jspec)
    comp = MXCompressed(torch.from_numpy(np.array(ref_c.payload)),
                        torch.from_numpy(np.array(ref_c.scales)))
    got = mx_dequant.mx_dequantize_2d(comp.payload, comp.scales, spec, torch.float32)
    ref = jops.mx_dequantize(ref_c, jspec, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=XLA_EXP2_RTOL, atol=0)
    nd = ops.mx_dequantize(MXCompressed(comp.payload.reshape(4, 4, -1),
                                        comp.scales.reshape(4, 4, -1)), spec)
    np.testing.assert_array_equal(nd.reshape(16, -1).numpy(), got.numpy())


@pytest.mark.parametrize("shards", [2, 4])
def test_plain_dequant_reduce_matches_pallas(shards):
    spec, jspec = MXSpec.make("fp4_e2m1", 32), JMXSpec.make("fp4_e2m1", 32)
    x_np = _normal_blocks(np.random.default_rng(shards), (shards, 8, 256), 32)
    ref_c = jmx.quantize(jnp.asarray(x_np), jspec)
    payload = torch.from_numpy(np.array(ref_c.payload))
    scales = torch.from_numpy(np.array(ref_c.scales))
    got = mx_dequant.dequant_reduce(payload, scales, spec, torch.float32)
    ref = jops.mx_dequant_reduce(ref_c, jspec, out_dtype=jnp.float32)
    # both sum the S dequantized shards in fp32 in order 0..S-1; the values
    # differ only by the reference's inexact exp2 scales
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=XLA_EXP2_RTOL,
                               atol=XLA_EXP2_RTOL * float(np.abs(np.asarray(ref)).max()))
    nd = ops.mx_dequant_reduce(MXCompressed(payload, scales), spec)
    np.testing.assert_array_equal(nd.numpy(), got.numpy())
    seq = sum(tmx.dequantize(MXCompressed(payload[s], scales[s]), spec) for s in range(shards))
    np.testing.assert_array_equal(got.numpy(), seq.numpy())


def test_ops_quantize_flattens_leading_dims():
    spec = MXSpec.make("fp4_e2m1", 32)
    x = torch.from_numpy(_normal_blocks(np.random.default_rng(3), (2, 3, 64), 32))
    comp = ops.mx_quantize(x, spec)
    flat = tmx.quantize(x.reshape(6, 64), spec)
    assert comp.payload.shape == (2, 3, 32) and comp.scales.shape == (2, 3, 2)
    np.testing.assert_array_equal(comp.payload.reshape(6, -1).numpy(), flat.payload.numpy())


def test_wrappers_refuse_non_cpu_non_cuda_devices():
    spec = MXSpec.make("fp4_e2m1", 32)
    x = torch.zeros(2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mx_quant.mx_quantize_2d(x, spec)


# ------------------------------------------- the kernel's code selection rule


def _kernel_search(v: torch.Tensor, mids: np.ndarray, bits: int) -> torch.Tensor:
    """``csrc/mx_common.cuh:search_code`` step for step: the fp32 midpoints
    padded with +inf to 2**bits - 1 entries, then ``bits`` steps of
    ``c += t[c + s - 1] < v ? s : 0`` for s = 2**(bits-1) .. 1; NaN takes
    the top code. (The kernel searches rather than computing a code in
    floats: for int4 ``ceil(v + 6.5)`` looks like the code, but the add
    rounds, so tiny values and values just above a midpoint would land on
    the wrong one.)"""
    table = torch.full(((1 << bits) - 1,), float("inf"), dtype=torch.float32)
    table[:len(mids)] = torch.from_numpy(mids.astype(np.float32))
    c = torch.zeros(v.shape, dtype=torch.int64)
    s = 1 << (bits - 1)
    while s:
        c = c + torch.where(table[c + s - 1] < v, s, 0)
        s >>= 1
    return torch.where(v.isnan(), len(mids), c)


def _selection_inputs(spec: MXSpec) -> torch.Tensor:
    """Every bf16 bit pattern as fp32, normalised as the kernel does it
    (times the exact 2**-e) at shared exponents min_exp, -126, -1, 0, 1 and
    max_exp; then every midpoint, its fp32 neighbours, +-0 and +-inf."""
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).float()
    exps = (spec.scale.min_exp, -126, -1, 0, 1, spec.scale.max_exp)
    norm = [x * tmx.pow2(torch.tensor(-e)) for e in exps]
    m = spec.elem.midpoints.astype(np.float32)
    near = np.concatenate([m, np.nextafter(m, np.float32(-np.inf)),
                           np.nextafter(m, np.float32(np.inf)),
                           np.array([0.0, -0.0, np.inf, -np.inf], np.float32)])
    return torch.cat(norm + [torch.from_numpy(near)])


@pytest.mark.parametrize("elem", FORMATS)
def test_kernel_code_selection_is_exact(elem):
    """The binary search picks the plain version's code (searchsorted left,
    NaN -> the top code) on every input, the NaN bf16 patterns included."""
    spec = MXSpec.make(elem, 32)
    v = _selection_inputs(spec)
    mids, _ = tmx.code_tables(spec, torch.device("cpu"))
    want = torch.where(v.isnan(), len(mids), torch.bucketize(v, mids, right=False))
    got = _kernel_search(v, spec.elem.midpoints, spec.elem.bits)
    assert v.isnan().any() and v.isinf().any()
    assert torch.equal(got, want), int((got != want).sum())

