"""Public N-D entry points of the MX codec kernels.

Drop-in counterparts of ``repro_torch.core.mx.{quantize, dequantize}`` and of
the fused dequantize+sum: leading dims are flattened to 2-D (3-D for the
stacked shards) for the kernels. A CUDA tensor always goes through its
kernel (a shape the kernel does not take raises); a CPU tensor runs the
plain version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.formats import MXSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.kernels.build import launch_counts, reset_launch_counts
from repro_torch.kernels.mx_dequant import dequant_reduce, mx_dequantize_2d
from repro_torch.kernels.mx_quant import mx_quantize_2d

__all__ = ["mx_quantize", "mx_dequantize", "mx_dequant_reduce", "launch_counts",
           "reset_launch_counts"]


def mx_quantize(x: torch.Tensor, spec: MXSpec) -> MXCompressed:
    lead, n = x.shape[:-1], x.shape[-1]
    comp = mx_quantize_2d(x.reshape(math.prod(lead), n).contiguous(), spec)
    return MXCompressed(payload=comp.payload.reshape(*lead, comp.payload.shape[-1]),
                        scales=comp.scales.reshape(*lead, comp.scales.shape[-1]))


def mx_dequantize(comp: MXCompressed, spec: MXSpec,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    lead = comp.payload.shape[:-1]
    m = math.prod(lead)
    out = mx_dequantize_2d(comp.payload.reshape(m, -1).contiguous(),
                           comp.scales.reshape(m, -1).contiguous(), spec, out_dtype)
    return out.reshape(*lead, out.shape[-1])


def mx_dequant_reduce(comp: MXCompressed, spec: MXSpec,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused decompress + fp32 sum over the leading (stacked shards) axis."""
    s = comp.payload.shape[0]
    lead = comp.payload.shape[1:-1]
    m = math.prod(lead)
    out = dequant_reduce(comp.payload.reshape(s, m, -1).contiguous(),
                         comp.scales.reshape(s, m, -1).contiguous(), spec, out_dtype)
    return out.reshape(*lead, out.shape[-1])
