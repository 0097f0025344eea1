"""MX block quantization: the CUDA kernel's wrapper and its plain version.

``mx_quantize_2d`` launches ``csrc/mx_quant.cu`` for a CUDA tensor and runs
the plain version (``repro_torch.core.mx.quantize``) only for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import mx as _mx
from repro_torch.core.formats import MXSpec
from repro_torch.core.mx import MXCompressed, code_tables
from repro_torch.kernels.build import check_launch, count_launch, load_kernels, stream_ptr

__all__ = ["mx_quantize_2d", "quantize_plain"]

def quantize_plain(x: torch.Tensor, spec: MXSpec) -> MXCompressed:
    """Plain PyTorch version of the kernel (the port's codec oracle)."""
    return _mx.quantize(x, spec)


def check_block(spec: MXSpec) -> int:
    """Groups of 8 values per MX block. The quantize kernel gives a block of
    up to 32 values to one thread and splits a larger one over up to 8
    lanes of a warp, so this must be a power of two <= 32."""
    gpb = spec.block_size // 8
    if spec.block_size % 8 or gpb & (gpb - 1) or gpb > 32:
        raise ValueError(f"MX block size {spec.block_size}: the CUDA codec takes "
                         f"8, 16, 32, 64, 128 or 256")
    if spec.elem.num_codes > 256:
        raise ValueError(f"{spec.elem.name}: more than 256 codes")
    return gpb


def mx_quantize_2d(x: torch.Tensor, spec: MXSpec) -> MXCompressed:
    """Quantize a 2-D ``(M, N)`` fp32/bf16 tensor, N % block == 0, into
    payload ``(M, N*bits/8)`` + scales ``(M, N/block)`` uint8."""
    if x.device.type == "cpu":
        return quantize_plain(x, spec)
    if x.device.type != "cuda":
        raise ValueError(f"mx_quantize_2d: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mx_quantize_2d takes a 2-D fp32/bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("mx_quantize_2d needs a contiguous, 16-byte aligned tensor")
    m, n = x.shape
    gpb = check_block(spec)
    if n % spec.block_size:
        raise ValueError(f"last dim {n} not divisible by MX block {spec.block_size}")
    bits = spec.elem.bits
    payload = torch.empty((m, n * bits // 8), dtype=torch.uint8, device=x.device)
    scales = torch.empty((m, n // spec.block_size), dtype=torch.uint8, device=x.device)
    n_groups = m * n // 8
    if n_groups:
        mids, _ = code_tables(spec, x.device)
        lib = load_kernels()
        err = lib.mxk_quant(
            x.data_ptr(), int(x.dtype == torch.bfloat16), payload.data_ptr(),
            scales.data_ptr(), mids.data_ptr(), len(spec.elem.midpoints),
            spec.elem.zero_code, n_groups, gpb, bits, spec.elem.emax,
            spec.scale.min_exp, spec.scale.max_exp, spec.scale.bias, stream_ptr())
        check_launch("mx_quant", err)
        count_launch("mx_quant")
    return MXCompressed(payload=payload, scales=scales)
