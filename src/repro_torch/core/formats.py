"""MX (microscaling) element and scale formats — the port's own copy of
``repro.core.formats`` (numpy only; importing the reference would import JAX).

An MX-compressed tensor is a sequence of blocks of ``block_size`` consecutive
values. Each block stores one shared power-of-two scale (``EkM0``) plus
``block_size`` low-bit element codes. Element formats are defined by their
exact, sorted, deduplicated code tables; a stored code is an INDEX into that
table, never an IEEE bit pattern (the table's ``fp8_e4m3`` tops out at 480,
which no ``torch.float8_*`` type represents).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

__all__ = [
    "ElementFormat", "ScaleFormat", "MXSpec", "KVCacheSpec",
    "ELEMENT_FORMATS", "SCALE_FORMATS",
]


@dataclasses.dataclass(frozen=True)
class ElementFormat:
    """A low-bit element format: minifloat ``EeMm`` (OCP MX: no inf/nan
    encodings, subnormals, bias ``2**(e-1) - 1`` for ``e >= 2`` and 0 for
    ``e == 1``) or symmetric signed integer ``INTn``."""

    name: str
    kind: str  # "fp" | "int"
    bits: int  # total bits incl. sign
    exp_bits: int = 0
    man_bits: int = 0

    @functools.cached_property
    def code_values(self) -> np.ndarray:
        """All representable values, ascending, deduplicated, float64."""
        if self.kind == "int":
            imax = 2 ** (self.bits - 1) - 1
            return np.arange(-imax, imax + 1, dtype=np.float64)
        e, m = self.exp_bits, self.man_bits
        bias = (2 ** (e - 1) - 1) if e >= 2 else 0
        vals = []
        for r in range(2**e):
            for f in range(2**m):
                if r == 0:  # subnormal
                    mag = 2.0 ** (1 - bias) * (f / 2**m)
                else:
                    mag = 2.0 ** (r - bias) * (1.0 + f / 2**m)
                vals.extend([mag, -mag])
        return np.array(sorted(set(vals)), dtype=np.float64)

    @functools.cached_property
    def max_value(self) -> float:
        return float(self.code_values[-1])

    @functools.cached_property
    def emax(self) -> int:
        """floor(log2(max representable)) — used for shared-exp selection."""
        return int(np.floor(np.log2(self.max_value)))

    @property
    def num_codes(self) -> int:
        return len(self.code_values)

    @functools.cached_property
    def midpoints(self) -> np.ndarray:
        """Midpoints between adjacent code values (round-to-nearest bins)."""
        v = self.code_values
        return (v[:-1] + v[1:]) / 2.0

    @functools.cached_property
    def zero_code(self) -> int:
        """Index of 0.0 in the code table (every format represents zero)."""
        return int(np.flatnonzero(self.code_values == 0.0)[0])


@dataclasses.dataclass(frozen=True)
class ScaleFormat:
    """Power-of-two shared scale ``EkM0``: value = 2**(raw - bias).
    E8M0: raw in [0, 254], bias 127; smaller k: raw in [0, 2**k - 1]."""

    name: str
    exp_bits: int

    @property
    def bias(self) -> int:
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def min_exp(self) -> int:
        return -self.bias

    @property
    def max_exp(self) -> int:
        top = 2**self.exp_bits - 1 - (1 if self.exp_bits == 8 else 0)
        return top - self.bias

    @property
    def bits(self) -> int:
        return self.exp_bits


def _fp(name: str, e: int, m: int) -> ElementFormat:
    return ElementFormat(name=name, kind="fp", bits=1 + e + m, exp_bits=e, man_bits=m)


def _int(name: str, b: int) -> ElementFormat:
    return ElementFormat(name=name, kind="int", bits=b)


ELEMENT_FORMATS = {
    "fp5_e3m1": _fp("fp5_e3m1", 3, 1),
    "fp5_e2m2": _fp("fp5_e2m2", 2, 2),
    "fp5_e1m3": _fp("fp5_e1m3", 1, 3),
    "fp4_e2m1": _fp("fp4_e2m1", 2, 1),
    "fp4_e1m2": _fp("fp4_e1m2", 1, 2),
    "fp3_e1m1": _fp("fp3_e1m1", 1, 1),
    "fp2_e1m0": _fp("fp2_e1m0", 1, 0),
    "int3": _int("int3", 3),
    "int4": _int("int4", 4),
    "int5": _int("int5", 5),
    "fp6_e3m2": _fp("fp6_e3m2", 3, 2),
    "fp8_e4m3": _fp("fp8_e4m3", 4, 3),
    "int8": _int("int8", 8),
}

SCALE_FORMATS = {
    "e8m0": ScaleFormat("e8m0", 8),
    "e7m0": ScaleFormat("e7m0", 7),
    "e6m0": ScaleFormat("e6m0", 6),
    "e5m0": ScaleFormat("e5m0", 5),
    "e4m0": ScaleFormat("e4m0", 4),
}


@dataclasses.dataclass(frozen=True)
class MXSpec:
    """One microscaling compression scheme = (element fmt, block size, scale fmt)."""

    elem: ElementFormat
    block_size: int
    scale: ScaleFormat

    @classmethod
    def make(cls, value_dtype: str, block_size: int, scale_dtype: str = "e8m0") -> "MXSpec":
        return cls(elem=ELEMENT_FORMATS[value_dtype], block_size=int(block_size),
                   scale=SCALE_FORMATS[scale_dtype])

    @property
    def name(self) -> str:
        return f"{self.elem.name}_b{self.block_size}_{self.scale.name}"

    @property
    def effective_bits(self) -> float:
        """Paper's compression metric: value bits + amortized scale bits."""
        return self.elem.bits + self.scale.bits / self.block_size

    def compression_ratio(self, baseline_bits: int = 16) -> float:
        return baseline_bits / self.effective_bits

    def wire_bytes(self, n_values: int) -> int:
        """On-wire bytes for ``n_values`` values: bit-packed codes plus one
        byte per block scale (``n_values`` a multiple of block_size)."""
        assert n_values % self.block_size == 0
        n_blocks = n_values // self.block_size
        return (n_values * self.elem.bits + 7) // 8 + n_blocks

    def wire_bits_per_value(self, n_values: int) -> float:
        """Wire bits per value for ``n_values`` values, scales included."""
        return 8.0 * self.wire_bytes(n_values) / n_values


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Storage format of the paged KV block pools.

    ``mx=None`` is dense (pools hold the engine's cache dtype); an ``MXSpec``
    stores pools in wire format (bit-packed payload + scale bytes), quantized
    on append and dequantized on read. ``use_pallas`` is kept so the
    reference's ``+pallas`` strings parse unchanged; on the port it changes
    nothing, because the paged read on the card always runs the hand-written
    kernel (and its plain version on the CPU).
    """

    mx: Optional[MXSpec] = None
    use_pallas: bool = False

    @property
    def quantized(self) -> bool:
        return self.mx is not None

    @classmethod
    def parse(cls, spec: "KVCacheSpec | MXSpec | str | None") -> "KVCacheSpec":
        """Accept a KVCacheSpec, an MXSpec, None, or a CLI string: ``bf16`` /
        ``none`` / ``dense`` (/ ``bfloat16`` / ``fp32`` / ``float32``) =>
        dense; an element-format name => that format at block 32 / e8m0; a
        full ``<elem>_b<block>_<scale>`` name exactly; any string form may end
        in ``+pallas``."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, MXSpec):
            return cls(mx=spec)
        name = str(spec).lower()
        use_pallas = False
        if name.endswith("+pallas"):
            use_pallas, name = True, name[: -len("+pallas")]
        if name in ("bf16", "bfloat16", "none", "dense", "fp32", "float32"):
            return cls(use_pallas=use_pallas)
        if name in ELEMENT_FORMATS:
            return cls(mx=MXSpec.make(name, 32, "e8m0"), use_pallas=use_pallas)
        for scale in SCALE_FORMATS:
            suffix = f"_{scale}"
            if name.endswith(suffix):
                elem, _, block = name[: -len(suffix)].rpartition("_b")
                if elem in ELEMENT_FORMATS and block.isdigit():
                    return cls(mx=MXSpec.make(elem, int(block), scale),
                               use_pallas=use_pallas)
        raise ValueError(
            f"unknown KV cache spec {spec!r}: expected a dense alias "
            f"(bf16, bfloat16, none, dense, fp32, float32), an element "
            f"format ({', '.join(sorted(ELEMENT_FORMATS))} — block 32, e8m0 "
            f"scales), or a full '<elem>_b<block>_<scale>' MX spec name like "
            f"'fp4_e2m1_b32_e8m0' with scale one of "
            f"{', '.join(sorted(SCALE_FORMATS))}; any form may carry a "
            f"'+pallas' suffix")

    def describe(self) -> str:
        suffix = "+pallas" if self.use_pallas else ""
        if not self.quantized:
            return "dense" + suffix
        return (f"{self.mx.name} ({self.mx.effective_bits:.2f} eff bits, "
                f"{self.mx.compression_ratio():.2f}x vs bf16){suffix}")

