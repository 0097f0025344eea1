"""The compressed row-parallel reduction (the paper's Fig. 1b, gather
variant) over N stacked partial sums — what one card needs.

``compressed_psum`` quantizes every partial to the MX wire format (payload +
scale bytes), [gathers the N shards' bytes], and dequantizes and sums them
in fp32 in shard order 0..N-1 in one fused pass, casting back to the
partials' dtype. Under ``TPContext.simulate_tp`` the N partials already sit
stacked on one device, so the gather step is the identity; a multi-GPU slice
replaces it with ``torch.distributed.all_gather_into_tensor`` of the two
uint8 tensors and nothing else changes. The codec runs through
``kernels/ops.py``: the hand-written kernels on the card, their plain
versions on the CPU. ``tp.row_linear`` adds the ``two_phase`` variant's
second quantize of the reduced result itself, as the reference's simulated
path does.

``masked_owner_psum`` is the bit-exact ownership select of the
sequence-sharded pools (``core/tp.py``): a ``torch.distributed`` all-reduce
over the kv group in which exactly one rank contributes each byte.

Not ported yet (see ROADMAP.md): the rank collectives of the ``two_phase``
variant (reduce-scatter + all-gather), ``keep_local_fp``, ``overlap_chunks``
and a non-fp32 accumulator, which change what ranks exchange or sum (a call
here that asks for any of them raises, see ``check_ported``); the
straight-through-estimator gradient and ``compressed_all_to_all``.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.formats import MXSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import ops

__all__ = ["compressed_psum", "psum", "psum_maybe_compressed", "check_ported",
           "masked_owner_psum", "exchange_counts", "reset_exchange_counts"]

# masked_owner_psum calls since the last reset: all-reduces, bytes each rank
# contributes, and host seconds spent in them (device-to-host copy, the
# all-reduce, host-to-device copy; each call ends synchronized)
_EXCHANGE: Dict[str, float] = {"all_reduce": 0, "bytes": 0, "seconds": 0.0}


def exchange_counts() -> Dict[str, float]:
    """``masked_owner_psum`` all-reduces, bytes and seconds since the last
    reset (the sharded pools' exchange; counted like a kernel launch)."""
    return dict(_EXCHANGE)


def reset_exchange_counts() -> None:
    _EXCHANGE.update(all_reduce=0, bytes=0, seconds=0.0)


def masked_owner_psum(x: torch.Tensor, own: torch.Tensor, group) -> torch.Tensor:
    """Bit-exact ownership select across the ranks of ``group``.

    Every rank contributes the elements of ``x`` it owns (``own``, a bool
    tensor broadcastable to ``x``, True on exactly one rank per element) and
    zeros elsewhere; the sum over the group rebuilds the whole tensor on
    every rank. The select and the sum run on the tensor's BYTES (a uint8
    view): with one nonzero contributor per byte the sum is exact, so bf16
    and fp32 pool values (``-0.0`` and NaN payloads included) and uint8 wire
    bytes all arrive bit for bit. (A float sum would turn ``-0.0`` into
    ``+0.0``, and gloo has no 16- or 32-bit unsigned sum.)

    Transport: gloo on the host. A tensor on the card is staged through
    host memory (device-to-host copy, the all-reduce, host-to-device copy),
    so each call ends synchronized; the pools and every kernel stay on the
    card. ``x`` has at least one dimension. Returns a new tensor like
    ``x``."""
    t0 = time.perf_counter()
    x = x.contiguous()
    u = x.view(torch.uint8).reshape(*x.shape, x.element_size())   # (..., bytes)
    own = torch.as_tensor(own, dtype=torch.bool, device=x.device)
    buf = torch.where(own[..., None], u, torch.zeros((), dtype=torch.uint8, device=x.device))
    host = buf.cpu() if buf.device.type != "cpu" else buf.contiguous()
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
    out = host.to(x.device).reshape(-1).view(x.dtype).reshape(x.shape)
    _EXCHANGE["all_reduce"] += 1
    _EXCHANGE["bytes"] += host.numel()
    _EXCHANGE["seconds"] += time.perf_counter() - t0
    return out


def check_ported(policy: CompressionPolicy) -> None:
    """Raise on a policy option whose rank collective is not ported yet, so
    that a request for it is refused and never silently served by the plain
    gather variant. (On the simulated path, ``tp.row_linear``, these options
    need no collective: it serves ``two_phase`` and ignores the rest, as the
    reference does.)"""
    unported = [name for name, asked in (
        (f"variant={policy.variant!r}", policy.variant != "gather"),
        ("keep_local_fp", policy.keep_local_fp),
        (f"overlap_chunks={policy.overlap_chunks}", policy.overlap_chunks != 1),
        (f"accum_dtype={policy.accum_dtype!r}", policy.accum_dtype != "float32"),
    ) if asked]
    if unported:
        raise NotImplementedError(
            f"compressed collective option(s) not ported yet: {', '.join(unported)}; "
            f"only the paper's 'gather' variant with an fp32 accumulator runs")


def compressed_psum(partials: torch.Tensor, spec: MXSpec, *,
                    variant: str = "gather") -> torch.Tensor:
    """Sum N stacked partials ``(N, ..., F)`` through the MX wire format:
    quantize -> [gather] -> fused dequantize + fp32 sum (order 0..N-1) ->
    cast to ``partials.dtype``. Returns ``(..., F)``."""
    if variant != "gather":
        raise NotImplementedError(
            f"compressed_psum variant {variant!r} is not ported yet; only the "
            f"paper's 'gather' variant runs")
    comp = ops.mx_quantize(partials, spec)
    # [gather]: the N shards' wire bytes are already stacked on this device
    gathered = MXCompressed(comp.payload, comp.scales)
    return ops.mx_dequant_reduce(gathered, spec, out_dtype=partials.dtype)


def psum(partials: torch.Tensor) -> torch.Tensor:
    """Uncompressed reduction of N stacked partials: fp32 sum in shard
    order 0..N-1, cast back."""
    total = partials[0].float()
    for i in range(1, partials.shape[0]):
        total = total + partials[i].float()
    return total.to(partials.dtype)


def psum_maybe_compressed(partials: torch.Tensor,
                          policy: Optional[CompressionPolicy], *,
                          n_tokens: Optional[int] = None) -> torch.Tensor:
    """Policy-gated reduction of N stacked partials ``(N, ..., F)``.

    ``n_tokens`` defaults to the number of activation rows crossing the wire
    (the product of the dims between the shard axis and the features) — the
    prefill/decode discriminator of ``CompressionPolicy.active_for``."""
    if n_tokens is None:
        n_tokens = math.prod(partials.shape[1:-1]) if partials.dim() > 2 else 1
    if policy is None or not policy.active_for(n_tokens):
        return psum(partials)
    check_ported(policy)
    return compressed_psum(partials, policy.spec)
