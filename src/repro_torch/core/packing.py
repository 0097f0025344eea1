"""n-bit code packing: 8 consecutive n-bit codes <-> n bytes, LSB first.

The layout equals the reference's bit-matrix transform: code ``c`` of a row
occupies bits ``[c*n, (c+1)*n)`` of the row's little-endian bitstream, so
every width 1-8 reads as one contiguous stream (the CUDA kernels rely on it).
A nibble path covers n == 4 and n == 8 is the identity.
"""
from __future__ import annotations

import torch

__all__ = ["pack_codes", "unpack_codes"]


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes (..., K), K % 8 == 0, each < 2**bits -> (..., K*bits//8)."""
    codes = codes.to(torch.uint8)
    if bits == 8:
        return codes
    k = codes.shape[-1]
    assert k % 8 == 0, f"pack_codes needs multiple-of-8 lanes, got {k}"
    if bits == 4:
        return codes[..., 0::2] | (codes[..., 1::2] << 4)
    groups = codes.reshape(*codes.shape[:-1], k // 8, 8).to(torch.int64)
    shifts = torch.arange(8, device=codes.device, dtype=torch.int64) * bits
    word = (groups << shifts).sum(dim=-1, keepdim=True)       # (..., K/8, 1)
    byte_shifts = torch.arange(bits, device=codes.device, dtype=torch.int64) * 8
    packed = ((word >> byte_shifts) & 0xFF).to(torch.uint8)   # (..., K/8, bits)
    return packed.reshape(*codes.shape[:-1], k * bits // 8)


def unpack_codes(packed: torch.Tensor, bits: int, n_values: int) -> torch.Tensor:
    """Inverse of pack_codes: (..., n_values*bits//8) -> (..., n_values)."""
    packed = packed.to(torch.uint8)
    if bits == 8:
        return packed
    if bits == 4:
        out = torch.stack([packed & 0xF, packed >> 4], dim=-1)
        return out.reshape(*packed.shape[:-1], n_values)
    nbytes = packed.shape[-1]
    assert nbytes == n_values * bits // 8
    groups = packed.reshape(*packed.shape[:-1], nbytes // bits, bits).to(torch.int64)
    byte_shifts = torch.arange(bits, device=packed.device, dtype=torch.int64) * 8
    word = (groups << byte_shifts).sum(dim=-1, keepdim=True)  # (..., G, 1)
    shifts = torch.arange(8, device=packed.device, dtype=torch.int64) * bits
    codes = ((word >> shifts) & ((1 << bits) - 1)).to(torch.uint8)
    return codes.reshape(*packed.shape[:-1], n_values)
