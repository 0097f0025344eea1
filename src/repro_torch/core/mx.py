"""Block-wise MX quantization / dequantization in plain PyTorch: the port's
oracle, and the plain version of its codec kernels.

Per block of ``B`` consecutive values along the last axis:

    amax       = max |v|            (NaN anywhere in the block => NaN)
    shared_exp = floor(log2(amax)) - emax(elem)   from the fp32 exponent
                 field; amax == 0 or NaN => the scale format's min_exp;
                 clamped to the scale range
    code_i     = searchsorted(midpoints, v_i * 2**-shared_exp, side="left")
                 (NaN => the top code, as searchsorted sorts NaN last)
    v_i'       = code_values[code_i] * 2**shared_exp

Byte-exact with ``repro.core.mx`` on every block whose shared exponent is a
normal fp32 power of two (>= -126). One documented difference: a block whose
exponent clamps below that (e8m0's min_exp = -127: zero blocks, blocks with
a subnormal amax, NaN blocks) is stored as all-zero codes, and a scale below
2**-126 decodes as 0. The reference divides by a flushed-to-zero 2**-127
there (XLA on the CPU) and stores 0/0 or x/0 codes, which its own flushed
dequantize also turns into 0.0, so decoded values agree. Every power of two
here is built from its exponent bits (exact, no ``exp2``), and the port
never casts through ``torch.float8_*`` / ``float4_*``: a code is an index
into the format's sorted code table.

The wire format is a pair of uint8 tensors: ``payload`` (bit-packed code
indices, B*bits/8 bytes per block) and ``scales`` (one biased exponent byte
per block).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.formats import MXSpec
from repro_torch.core.packing import pack_codes, unpack_codes

__all__ = [
    "MXCompressed", "quantize", "dequantize", "quantize_codes",
    "codes_to_values", "fake_quantize", "wire_arrays_shape", "pow2",
    "MIN_NORMAL_EXP", "code_tables",
]

MIN_NORMAL_EXP = -126  # smallest exponent of a normal float32

_TABLES: Dict[Tuple[str, str], Tuple[torch.Tensor, torch.Tensor]] = {}


class MXCompressed(NamedTuple):
    """Wire representation of an MX-compressed tensor."""

    payload: torch.Tensor  # uint8 (..., n_values * bits // 8)
    scales: torch.Tensor   # uint8 (..., n_blocks) biased shared exponents


def pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**k for integer k in [-149, 127], from the bits."""
    k = k.to(torch.int32)
    normal = (k.clamp(min=MIN_NORMAL_EXP) + 127) << 23
    sub = torch.ones_like(k) << (k.clamp(-149, MIN_NORMAL_EXP - 1) + 149)
    return torch.where(k >= MIN_NORMAL_EXP, normal, sub).view(torch.float32)


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    assert x.shape[-1] % block == 0, (
        f"last dim {x.shape[-1]} not divisible by MX block size {block}")
    return x.reshape(*x.shape[:-1], x.shape[-1] // block, block)


def code_tables(spec: MXSpec, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(midpoints, code values) of ``spec``'s element format as float32
    tensors on ``device``, built once per device: on a GPU, a host-to-device
    copy per call would make every call wait for the card."""
    key = (spec.elem.name, str(device))
    if key not in _TABLES:
        _TABLES[key] = (
            torch.tensor(spec.elem.midpoints, dtype=torch.float32, device=device),
            torch.tensor(spec.elem.code_values, dtype=torch.float32, device=device))
    return _TABLES[key]


def shared_exponents(blocks: torch.Tensor, spec: MXSpec) -> torch.Tensor:
    """(..., n_blocks, B) fp32 -> (..., n_blocks) int32 clamped exponents."""
    a = blocks.abs()
    amax = torch.where(a.isnan().any(dim=-1),
                       torch.full((), float("nan"), device=a.device),
                       a.amax(dim=-1))
    field = (amax.contiguous().view(torch.int32) >> 23) & 0xFF
    e = torch.where(amax > 0, field - 127 - spec.elem.emax,
                    torch.full_like(field, spec.scale.min_exp))
    return e.clamp(spec.scale.min_exp, spec.scale.max_exp)


def quantize_codes(x: torch.Tensor, spec: MXSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize to (unpacked code indices uint8 (..., N), shared exponents
    int32 (..., N/B)) — exponents clamped, not yet bias-encoded."""
    blocks = _blocked(x.to(torch.float32), spec.block_size)
    e = shared_exponents(blocks, spec)
    norm = blocks * pow2(-e)[..., None]
    mids, _ = code_tables(spec, x.device)
    idx = torch.bucketize(norm, mids, right=False)       # == searchsorted left
    idx = torch.where(norm.isnan(), len(mids), idx)
    idx = torch.where((e < MIN_NORMAL_EXP)[..., None], spec.elem.zero_code, idx)
    return idx.to(torch.uint8).reshape(x.shape), e


def quantize(x: torch.Tensor, spec: MXSpec) -> MXCompressed:
    """Full wire-format quantization: bit-packed payload + raw scale bytes."""
    assert spec.elem.num_codes <= 2**spec.elem.bits
    codes, e = quantize_codes(x, spec)
    return MXCompressed(payload=pack_codes(codes, spec.elem.bits),
                        scales=(e + spec.scale.bias).to(torch.uint8))


def codes_to_values(codes: torch.Tensor, spec: MXSpec) -> torch.Tensor:
    return code_tables(spec, codes.device)[1][codes.long()]


def _scale_values(e: torch.Tensor) -> torch.Tensor:
    """2**e, with exponents below the normal range decoding to 0."""
    return torch.where(e >= MIN_NORMAL_EXP, pow2(e), torch.zeros((), device=e.device))


def dequantize(comp: MXCompressed, spec: MXSpec,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert ``quantize``: payload/scales -> dense tensor."""
    n_blocks = comp.scales.shape[-1]
    n_values = n_blocks * spec.block_size
    codes = unpack_codes(comp.payload, spec.elem.bits, n_values)
    blocks = _blocked(codes_to_values(codes, spec), spec.block_size)
    e = comp.scales.to(torch.int32) - spec.scale.bias
    out = blocks * _scale_values(e)[..., None]
    return out.reshape(*out.shape[:-2], n_values).to(out_dtype)


def fake_quantize(x: torch.Tensor, spec: MXSpec) -> torch.Tensor:
    """Quantize + dequantize without packing, in ``x``'s dtype."""
    codes, e = quantize_codes(x, spec)
    blocks = _blocked(codes_to_values(codes, spec), spec.block_size)
    out = blocks * _scale_values(e)[..., None]
    return out.reshape(x.shape).to(x.dtype)


def wire_arrays_shape(shape: Tuple[int, ...], spec: MXSpec):
    """(payload shape, scales shape) of the wire arrays for ``shape``."""
    n = shape[-1]
    assert n % spec.block_size == 0
    return (*shape[:-1], n * spec.elem.bits // 8), (*shape[:-1], n // spec.block_size)
