"""Tensor-parallel linear layers on one device — the port's ``core/tp.py``
without meshes or pool ops.

``TPContext`` carries the compression policy and ``simulate_tp``: with
``simulate_tp = N > 1`` and an active policy, ``row_linear`` splits its
contraction into N partial sums exactly as N tensor-parallel ranks would
and reduces them through the paper's compressed reduction
(``collectives.compressed_psum``), so the codec runs on the served path of
one card. The partial products stay ``torch.matmul``.

On this simulated path the policy's ``variant="two_phase"`` re-quantizes
the reduced result once more (one more ``mx_quantize`` and
``mx_dequantize``), and ``keep_local_fp``, ``overlap_chunks`` and
``accum_dtype`` have no effect, as in the reference's simulated
``row_linear`` (``overlap_chunks`` is bit-identical either way there; the
other two change only what ranks exchange).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.collectives import compressed_psum
from repro_torch.core.policy import CompressionPolicy, NO_COMPRESSION
from repro_torch.kernels import ops

__all__ = ["TPContext", "column_linear", "row_linear"]


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Everything model code needs to know about distribution (one device:
    no mesh yet)."""

    policy: CompressionPolicy = NO_COMPRESSION
    simulate_tp: int = 0     # single-device TP emulation: split row-parallel
                             # contractions into N quantized partial sums

    def without_compression(self) -> "TPContext":
        """The dense gate variant of this context (uncompressed reductions)."""
        if not self.policy.enabled:
            return self
        return dataclasses.replace(self, policy=NO_COMPRESSION)


def column_linear(ctx: TPContext, x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w with w (Fin, Fout)."""
    y = torch.matmul(x, w.to(x.dtype))
    return y if bias is None else y + bias.to(y.dtype)


def row_linear(ctx: TPContext, x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               n_tokens: Optional[int] = None) -> torch.Tensor:
    """y = sum over shards of x_shard @ w_shard — the row-parallel layer whose
    reduction the paper compresses. x (..., Fin), w (Fin, Fout); bias added
    once after the reduction. ``n_tokens`` is accepted for the reference's
    signature; the simulated path has no token gate (as in the reference)."""
    del n_tokens
    n = ctx.simulate_tp
    policy = ctx.policy
    if (n > 1 and policy.enabled and policy.compress_tp_reduce
            and x.shape[-1] % n == 0
            and w.shape[-1] % policy.spec.block_size == 0):
        fin, fout = x.shape[-1], w.shape[-1]
        xs = x.reshape(-1, n, fin // n).transpose(0, 1)            # (n, M, c)
        ws = w.reshape(n, fin // n, fout).to(x.dtype)              # (n, c, o)
        parts = torch.matmul(xs, ws)                                # (n, M, o)
        y = compressed_psum(parts, policy.spec)
        if policy.variant == "two_phase":
            # two-phase re-quantizes the reduced result once more
            y = ops.mx_dequantize(ops.mx_quantize(y, policy.spec), policy.spec,
                                  out_dtype=x.dtype)
        y = y.reshape(*x.shape[:-1], fout)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    return y if bias is None else y + bias.to(y.dtype)
