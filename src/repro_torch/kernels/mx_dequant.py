"""MX dequantization, plain and fused with the shard reduction: the CUDA
kernels' wrappers and their plain versions.

``mx_dequantize_2d``  payload + scales -> dense (``csrc/mx_dequant.cu``).
``dequant_reduce``    S stacked shards -> their fp32 sum in shard order
                      0..S-1, cast once (``csrc/mx_dequant_reduce.cu``).

For a CUDA tensor each wrapper launches its kernel or raises; the plain
version runs only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import mx as _mx
from repro_torch.core.formats import MXSpec
from repro_torch.core.mx import MXCompressed, code_tables
from repro_torch.kernels.build import check_launch, count_launch, load_kernels, stream_ptr
from repro_torch.kernels.mx_quant import check_block

__all__ = ["mx_dequantize_2d", "dequant_reduce", "dequantize_plain",
           "dequant_reduce_plain"]

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def dequantize_plain(comp: MXCompressed, spec: MXSpec,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _mx.dequantize(comp, spec, out_dtype)


def dequant_reduce_plain(comp: MXCompressed, spec: MXSpec,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize the S stacked shards (leading axis) and sum them in fp32 in
    shard order 0..S-1 (a sequential sum, never a tree over the stack)."""
    total = None
    for s in range(comp.payload.shape[0]):
        sh = _mx.dequantize(MXCompressed(comp.payload[s], comp.scales[s]), spec,
                            torch.float32)
        total = sh if total is None else total + sh
    return total.to(out_dtype)


def _check_wire(payload: torch.Tensor, scales: torch.Tensor, spec: MXSpec,
                out_dtype: torch.dtype, ndim: int, name: str) -> int:
    if payload.device.type != "cuda" or scales.device != payload.device:
        raise ValueError(f"{name}: payload and scales must be on one CUDA device")
    if payload.dtype != torch.uint8 or scales.dtype != torch.uint8:
        raise ValueError(f"{name}: wire arrays must be uint8")
    if payload.dim() != ndim or scales.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D wire arrays")
    if not (payload.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: wire arrays must be contiguous")
    if payload.data_ptr() % 16:
        raise ValueError(f"{name}: the payload must be 16-byte aligned (the kernel reads "
                         f"whole groups as words)")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16")
    gpb = check_block(spec)
    n = payload.shape[-1] * 8 // spec.elem.bits
    if payload.shape[-1] * 8 % spec.elem.bits or n != scales.shape[-1] * spec.block_size \
            or payload.shape[:-1] != scales.shape[:-1]:
        raise ValueError(f"{name}: payload {tuple(payload.shape)} and scales "
                         f"{tuple(scales.shape)} do not describe one {spec.name} tensor")
    return gpb


def mx_dequantize_2d(payload: torch.Tensor, scales: torch.Tensor, spec: MXSpec,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(M, N*bits/8)`` + ``(M, N/block)`` -> ``(M, N)`` in ``out_dtype``."""
    if payload.device.type == "cpu":
        return dequantize_plain(MXCompressed(payload, scales), spec, out_dtype)
    gpb = _check_wire(payload, scales, spec, out_dtype, 2, "mx_dequantize_2d")
    m = payload.shape[0]
    n = scales.shape[-1] * spec.block_size
    out = torch.empty((m, n), dtype=out_dtype, device=payload.device)
    n_groups = m * n // 8
    if n_groups:
        _, vals = code_tables(spec, payload.device)
        err = load_kernels().mxk_dequant(
            payload.data_ptr(), scales.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), vals.data_ptr(), spec.elem.num_codes,
            n_groups, gpb, spec.elem.bits, spec.scale.bias, stream_ptr())
        check_launch("mx_dequant", err)
        count_launch("mx_dequant")
    return out


def dequant_reduce(payload: torch.Tensor, scales: torch.Tensor, spec: MXSpec,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(S, M, N*bits/8)`` + ``(S, M, N/block)`` -> ``(M, N)``: dequantize
    the S gathered shards and sum them in fp32, order 0..S-1, in one pass."""
    if payload.device.type == "cpu":
        return dequant_reduce_plain(MXCompressed(payload, scales), spec, out_dtype)
    gpb = _check_wire(payload, scales, spec, out_dtype, 3, "dequant_reduce")
    s, m = payload.shape[:2]
    n = scales.shape[-1] * spec.block_size
    out = torch.empty((m, n), dtype=out_dtype, device=payload.device)
    n_groups = m * n // 8
    if n_groups and s:
        _, vals = code_tables(spec, payload.device)
        err = load_kernels().mxk_dequant_reduce(
            payload.data_ptr(), scales.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), vals.data_ptr(), spec.elem.num_codes,
            n_groups, s, gpb, spec.elem.bits, spec.scale.bias, stream_ptr())
        check_launch("mx_dequant_reduce", err)
        count_launch("mx_dequant_reduce")
    return out
