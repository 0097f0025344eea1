"""The paper's compressed row-parallel reduction (Fig. 1b) — over N partial
sums stacked on one card, and between the ranks of a ``torch.distributed``
group — and the bit-exact ownership select of the sequence-sharded pools.

Simulated (``TPContext.simulate_tp``): ``compressed_psum`` quantizes the N
stacked partials to the MX wire format (payload + scale bytes), [gathers the
N shards' bytes] (the identity: they already sit on this card), and
dequantizes and sums them in fp32 in shard order 0..N-1 in one fused pass,
casting back to the partials' dtype. ``tp.row_linear`` adds the
``two_phase`` variant's second quantize of the reduced result itself, as the
reference's simulated path does.

Ranks (``TPContext.tp_group``, the reference's ``collectives.py:139-398``):
``rank_compressed_psum`` reduces this rank's partial ``(..., F)`` over the
group. The gather variant quantizes every feature chunk
(``overlap_chunks``) before any collective is issued, all-gathers each
chunk's payload and then its scales, and dequantizes and sums the N gathered
shards in rank order 0..N-1 (``mx_dequant_reduce``); ``keep_local_fp``
swaps the dequantized own shard for the full-precision partial. The
``two_phase`` variant is a quantized reduce-scatter (``all_to_all`` of the
per-destination feature slices, ``mx_dequant_reduce`` of the N received
slices) followed by a quantized all-gather of the reduced slices. Both give
bit for bit the simulated path's result on the same partials (MX blocks are
independent, and the sums run in the same order), and every rank the same
bytes, except under ``keep_local_fp``. ``rank_psum`` is the dense gate
variant (an all-reduce in the partial's dtype, the reference's
``lax.psum``); ``psum_maybe_compressed`` picks one with the policy's
``min_tokens`` gate, ``compressed_all_gather`` gathers a tensor in
compressed form, and ``rank_all_gather`` gathers one densely (a vision
prefix's ``mm_proj`` columns: the all-gather GSPMD inserts for the
reference's column-parallel ``P(d, model)``, uncompressed there too). The
codec runs through ``kernels/ops.py``: the hand-written kernels on the
card, their plain versions on the CPU.

The MoE expert-parallel island (``models/moe.py``, over a data group):
``compressed_all_to_all`` moves its dispatch and combine tensors in MX form
(the reference's ``collectives.py:343-363``: quantize along the last axis,
all-to-all the payload and the scales, dequantize), ``dense_all_to_all``
moves them in their own dtype, and ``dp_all_gather`` puts the data ranks'
row groups back together after the combine.

Transport: ``wire`` stages a tensor through host memory when the group is a
gloo group and the tensor lives on the card (ranks sharing a card), and
returns it as it is under NCCL (one card per rank) or on the CPU; each
collective's result goes back to the tensor's device. ``tp_counts`` counts
the rank collectives (all-gathers, all-to-alls, all-reduces, dense
all-gathers, the bytes this rank puts into them and the host seconds they
take; the island's all-to-alls, data all-gathers and entries under keys of
their own), ``exchange_counts`` the sequence-sharded pools'
``masked_owner_psum`` calls.

Training (the backward of each rank collective a forward calls; each is a
``torch.autograd.Function`` when the input needs a gradient, and the plain
forward otherwise): ``rank_compressed_psum`` is the reference's
straight-through estimator (``collectives.py:283-298``): every variant's
backward returns the output cotangent unchanged, cast to the partial's
dtype, with no collective (the codec runs on detached tensors, so its
kernels never see the backward). ``rank_psum``'s backward is the identity,
right wherever replicated code reads the reduced output; ``rank_all_gather``
takes this rank's slice of the cotangent. ``copy_to_group`` is the identity
forward whose backward all-reduces the gradient over the group: the
reduction GSPMD inserts where a replicated activation feeds a rank's shard
of a weight. ``rank_sum_scalar`` and ``dp_mean`` are the optimizer's (the
global norm over a TP group, the gradient average over a data group).
``tp_counts`` counts the backward's all-reduces (``backward_all_reduce``,
``backward_bytes``) and the optimizer's (``grad_all_reduce``,
``grad_bytes``) apart from the forward's, and ``bytes`` holds the forward's
only.
"""
from __future__ import annotations

import contextlib
import math
import time
import warnings
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.formats import MXSpec
from repro_torch.core.mx import MXCompressed
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import ops

__all__ = ["compressed_psum", "psum", "psum_maybe_compressed", "rank_compressed_psum",
           "rank_psum", "rank_all_gather", "compressed_all_gather", "check_stacked",
           "masked_owner_psum", "wire", "transport", "compressed_all_to_all",
           "dense_all_to_all", "dp_all_gather", "count_island",
           "exchange_counts", "reset_exchange_counts", "tp_counts", "reset_tp_counts",
           "recorded_collectives", "add_tp_counts", "reset_downgrade_warnings",
           "copy_to_group", "rank_sum_scalar", "dp_mean"]

# masked_owner_psum calls since the last reset: all-reduces, bytes each rank
# contributes, and host seconds spent in them (each call ends synchronized
# when staged through the host)
_EXCHANGE: Dict[str, float] = {"all_reduce": 0, "bytes": 0, "seconds": 0.0}
# the rank collectives of the TP and data groups since the last reset: calls
# by kind (``dense_all_gather``: ``rank_all_gather``; the MoE island's
# ``compressed_all_to_all`` / ``dense_all_to_all`` and ``dp_all_gather``, each
# with its own bytes), the bytes this rank puts into them all (its input
# tensors) and host seconds; ``island``: MoE layers that ran the
# expert-parallel island, ``island_down_bytes`` what their ``down``
# reductions sent
_TP: Dict[str, float] = {"all_gather": 0, "all_to_all": 0, "all_reduce": 0,
                         "dense_all_gather": 0, "dense_all_gather_bytes": 0,
                         "compressed_all_to_all": 0, "compressed_all_to_all_bytes": 0,
                         "dense_all_to_all": 0, "dense_all_to_all_bytes": 0,
                         "dp_all_gather": 0, "dp_all_gather_bytes": 0,
                         "island": 0, "island_down_bytes": 0, "bytes": 0, "seconds": 0.0,
                         "backward_all_reduce": 0, "backward_bytes": 0,
                         "grad_all_reduce": 0, "grad_bytes": 0}


def exchange_counts() -> Dict[str, float]:
    """``masked_owner_psum`` all-reduces, bytes and seconds since the last
    reset (the sharded pools' exchange; counted like a kernel launch)."""
    return dict(_EXCHANGE)


def reset_exchange_counts() -> None:
    _EXCHANGE.update(all_reduce=0, bytes=0, seconds=0.0)


def tp_counts() -> Dict[str, float]:
    """The TP and data groups' collectives since the last reset:
    ``all_gather``, ``all_to_all``, ``all_reduce`` calls (of the compressed
    and the dense reductions), ``dense_all_gather`` calls
    (``rank_all_gather``) and the ``dense_all_gather_bytes`` this rank put
    into them; the MoE island's ``compressed_all_to_all`` and
    ``dense_all_to_all`` calls and ``dp_all_gather`` calls, each with its
    ``*_bytes``, and its entries (``island``) with the bytes its ``down``
    reductions sent (``island_down_bytes``); ``bytes`` this rank put into
    all of them and host ``seconds`` (staging included; under NCCL the
    enqueue only); in training the backward's all-reduces
    (``backward_all_reduce``, ``backward_bytes``: ``copy_to_group``) and the
    optimizer's (``grad_all_reduce``, ``grad_bytes``), which ``bytes`` leaves
    out."""
    return dict(_TP)


def reset_tp_counts() -> None:
    _TP.update({k: 0 for k in _TP})


@contextlib.contextmanager
def recorded_collectives() -> Iterator[Dict[str, float]]:
    """Within the block (a CUDA graph's capture, which runs no collective),
    the TP collectives go into the yielded record instead of the counters;
    ``add_tp_counts(record)`` at each replay counts them. Host seconds are
    not recorded."""
    before = dict(_TP)
    record: Dict[str, float] = {}
    try:
        yield record
    finally:
        for k in _TP:
            if k != "seconds":
                record[k] = _TP[k] - before[k]
        _TP.update(before)


def add_tp_counts(record: Dict[str, float]) -> None:
    """Count the collectives of one replay of a graph whose capture gave
    ``record``."""
    for k, n in record.items():
        _TP[k] += n


def _count(kind: str, t: torch.Tensor, t0: float, bytes_key: str = "bytes") -> None:
    _TP[kind] += 1
    _TP[bytes_key] += t.numel() * t.element_size()
    _TP["seconds"] += time.perf_counter() - t0


def count_island(down_bytes: int) -> None:
    """One MoE layer ran the expert-parallel island; its ``down`` reduction
    sent ``down_bytes``."""
    _TP["island"] += 1
    _TP["island_down_bytes"] += down_bytes


def transport(group) -> str:
    """How ``group``'s collectives move data: ``"nccl"`` (device memory) or
    ``"gloo-staged"`` (host memory; a tensor on the card is copied out and
    back)."""
    return "nccl" if dist.get_backend(group) == "nccl" else "gloo-staged"


def wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as ``group``'s collectives take it: a host copy when the group
    is gloo and ``t`` lives on the card (ranks that share a card), else
    ``t`` itself (NCCL moves device memory; CPU tensors are already on the
    host). Contiguous either way."""
    if t.device.type == "cuda" and transport(group) == "gloo-staged":
        return t.cpu()
    return t.contiguous()


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

    Transport (``wire``): under gloo a tensor on the card is staged through
    host memory (device-to-host copy, the all-reduce, host-to-device copy),
    so each call ends synchronized; under NCCL it stays on the card. The
    pools and every kernel stay on the card. ``x`` has at least one
    dimension. Returns a new tensor like ``x``."""
    t0 = time.perf_counter()
    x = x.contiguous()
    u = x.view(torch.uint8).reshape(*x.shape, x.element_size())   # (..., bytes)
    own = torch.as_tensor(own, dtype=torch.bool, device=x.device)
    buf = wire(torch.where(own[..., None], u,
                           torch.zeros((), dtype=torch.uint8, device=x.device)), group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out = buf.to(x.device).reshape(-1).view(x.dtype).reshape(x.shape)
    _EXCHANGE["all_reduce"] += 1
    _EXCHANGE["bytes"] += buf.numel()
    _EXCHANGE["seconds"] += time.perf_counter() - t0
    return out


# ----------------------------------------------------------------- simulated


def compressed_psum(partials: torch.Tensor, spec: MXSpec, *,
                    variant: str = "gather") -> torch.Tensor:
    """Sum N stacked partials ``(N, ..., F)`` through the MX wire format:
    quantize -> [gather] -> fused dequantize + fp32 sum (order 0..N-1) ->
    cast to ``partials.dtype``. Returns ``(..., F)``. (The ``two_phase``
    variant's second quantize is ``tp.row_linear``'s.)"""
    if variant != "gather":
        raise NotImplementedError(
            f"compressed_psum variant {variant!r}: the simulated reduction runs the "
            f"gather variant (tp.row_linear adds two_phase's second quantize)")
    comp = ops.mx_quantize(partials, spec)
    # [gather]: the N shards' wire bytes are already stacked on this device
    gathered = MXCompressed(comp.payload, comp.scales)
    return ops.mx_dequant_reduce(gathered, spec, out_dtype=partials.dtype)


def check_stacked(policy: CompressionPolicy) -> None:
    """Raise on a policy option that only the rank collective gives a
    meaning (``two_phase``'s reduce-scatter, ``keep_local_fp``'s own shard,
    ``overlap_chunks``' staged gathers, a non-fp32 accumulator): the stacked
    reduction of ``psum_maybe_compressed`` without a group has no ranks, so
    a request for one is refused there and never silently served by the
    plain gather variant. (``tp.row_linear``'s simulated path serves
    ``two_phase`` and ignores the rest, as the reference's does; the rank
    path, ``group=``, runs them all.)"""
    asked = [name for name, on in (
        (f"variant={policy.variant!r}", policy.variant != "gather"),
        ("keep_local_fp", policy.keep_local_fp),
        (f"overlap_chunks={policy.overlap_chunks}", policy.overlap_chunks != 1),
        (f"accum_dtype={policy.accum_dtype!r}", policy.accum_dtype != "float32"),
    ) if on]
    if asked:
        raise NotImplementedError(
            f"compressed collective option(s) {', '.join(asked)} need ranks: the stacked "
            f"reduction runs the paper's 'gather' variant with an fp32 accumulator only; "
            f"pass group= (a TP group) for the rank collective")


def psum(partials: torch.Tensor) -> torch.Tensor:
    """Uncompressed reduction of N stacked partials: fp32 sum in shard
    order 0..N-1, cast back."""
    total = partials[0].float()
    for i in range(1, partials.shape[0]):
        total = total + partials[i].float()
    return total.to(partials.dtype)


# ------------------------------------------------------------------ autograd


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _PassThrough(torch.autograd.Function):
    """``fn(partial)`` forward (a reduction on a detached partial); the
    backward hands the cotangent back unchanged, cast to the partial's
    dtype, with no collective: the reference's STE for the compressed
    reduction, the identity for the dense one."""

    @staticmethod
    def forward(ctx, partial, fn):
        ctx.dtype = partial.dtype
        return fn(partial)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherLast(torch.autograd.Function):
    """``rank_all_gather`` forward; backward: this rank's slice of the last
    axis of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.width, ctx.rank = x.shape[-1], dist.get_rank(group)
        return rank_all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def _all_reduce_counted(g: torch.Tensor, group, kind: str, bytes_key: str) -> torch.Tensor:
    """A new tensor: the sum of ``g`` over ``group`` in ``g``'s dtype
    (staged through host memory under gloo on the card), counted under
    ``kind`` with its bytes under ``bytes_key``."""
    t0 = time.perf_counter()
    w = wire(g, group)
    if w is g:
        w = w.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    _count(kind, w, t0, bytes_key)
    return w.to(g.device)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; backward: the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce_counted(g.contiguous(), ctx.group, "backward_all_reduce",
                                    "backward_bytes"), None)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself forward; in backward, the gradient of ``x`` summed over
    ``group`` with one all-reduce in its dtype (``backward_all_reduce``).
    A replicated tensor that feeds each rank's shard of a weight gets only
    that shard's share of its gradient on each rank; this sums the shares.
    ``x`` unchanged when it needs no gradient or there is no group."""
    if group is None or not _needs_grad(x):
        return x
    return _CopyToGroup.apply(x, group)


def rank_sum_scalar(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (a few fp32 values) summed over ``group``: the optimizer's
    global norm over a TP group (one ``grad_all_reduce``)."""
    return _all_reduce_counted(t.reshape(-1), group, "grad_all_reduce",
                               "grad_bytes").reshape(t.shape)


def dp_mean(ts: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean over ``group``'s ranks of each tensor of ``ts``, in fp32,
    with one all-reduce of one fp32 bucket (``grad_all_reduce``): the data
    group's gradient average."""
    flat = torch.cat([t.reshape(-1).float() for t in ts])
    total = _all_reduce_counted(flat, group, "grad_all_reduce", "grad_bytes")
    total /= dist.get_world_size(group)
    return [c.view(t.shape) for c, t in zip(total.split([t.numel() for t in ts]), ts)]


# --------------------------------------------------------------------- ranks


_DOWNGRADE_WARNED: set = set()


def reset_downgrade_warnings() -> None:
    """Forget which two_phase downgrades have already warned."""
    _DOWNGRADE_WARNED.clear()


def _variant_downgrade(reason: str, strict: bool, key: tuple = ()) -> None:
    """A requested two_phase reduction cannot run: raise under ``strict`` or
    warn once per distinct (reason, spec, feature dim, group size) site, as
    the reference does."""
    msg = (
        f"compressed_psum: variant='two_phase' requested but {reason}; "
        "falling back to the gather variant. Plumb axis_size (the TP degree) "
        "and ensure the feature dim is divisible by axis_size * block_size, "
        "or set strict=False/strict_variant=False to accept the fallback."
    )
    if strict:
        raise ValueError(msg)
    dedup = (reason,) + key
    if dedup not in _DOWNGRADE_WARNED:
        _DOWNGRADE_WARNED.add(dedup)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _overlap_chunks(f: int, spec: MXSpec, requested: int) -> int:
    """Largest chunk count <= ``requested`` that splits a feature dim of
    ``f`` into equal block-aligned chunks (1 when none does). MX blocks are
    independent, so any block-aligned split gives the unchunked codec's
    bytes: chunking changes the schedule, never the values."""
    n = max(1, int(requested))
    while n > 1 and (f % n != 0 or (f // n) % spec.block_size != 0):
        n -= 1
    return n


def _all_gather(t: torch.Tensor, group, kind: str = "all_gather") -> torch.Tensor:
    """``(N, *t.shape)``: every rank's ``t`` in rank order, on ``t``'s
    device; counted under ``kind``."""
    t0 = time.perf_counter()
    w = wire(t, group)
    n = dist.get_world_size(group)
    out = torch.empty((n, *w.shape), dtype=w.dtype, device=w.device)
    dist.all_gather(list(out.unbind(0)), w, group=group)
    _count(kind, w, t0)
    return out.to(t.device)


def _all_to_all(t: torch.Tensor, group, kind: Optional[str] = "all_to_all") -> torch.Tensor:
    """``t`` ``(N, ...)``: slice i goes to rank i; returns ``(N, ...)`` whose
    slice j came from rank j. Counted under ``kind`` (None: only its bytes
    and seconds; the caller counts the call)."""
    t0 = time.perf_counter()
    w = wire(t, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    if kind is None:
        _TP["bytes"] += w.numel() * w.element_size()
        _TP["seconds"] += time.perf_counter() - t0
    else:
        _count(kind, w, t0)
    return out.to(t.device)


def _quantize_staged(x: torch.Tensor, spec: MXSpec, n_chunks: int):
    """Quantize every feature chunk before any collective is issued (the
    reference's ``_quantize_staged``)."""
    chunks = [x] if n_chunks == 1 else list(x.chunk(n_chunks, dim=-1))
    return chunks, [ops.mx_quantize(c.contiguous(), spec) for c in chunks]


def _gather_staged(comps: List[MXCompressed], group):
    """Each chunk's payload, then its scales, gathered from every rank."""
    return [MXCompressed(_all_gather(c.payload, group), _all_gather(c.scales, group))
            for c in comps]


def _gathered_reduce(gathered: MXCompressed, comp: MXCompressed, chunk: torch.Tensor,
                     spec: MXSpec, keep_local_fp: bool, accum: torch.dtype) -> torch.Tensor:
    """One chunk's gathered ``(N, ..., f)`` shards summed in fp32, rank order
    0..N-1 (``mx_dequant_reduce``), in ``accum`` (the partial's dtype when
    that is all that follows); with ``keep_local_fp`` the own shard's
    dequantized values swapped for the partial itself."""
    if not keep_local_fp:
        out = chunk.dtype if accum == torch.float32 else accum
        return ops.mx_dequant_reduce(gathered, spec, out_dtype=out)
    total = ops.mx_dequant_reduce(gathered, spec, out_dtype=accum)
    own_q = ops.mx_dequantize(comp, spec, out_dtype=accum)
    return total - own_q + chunk.to(accum)


def _compressed_psum_fwd(partial: torch.Tensor, group, spec: MXSpec, keep_local_fp: bool,
                         accum: torch.dtype, overlap_chunks: int) -> torch.Tensor:
    n_chunks = _overlap_chunks(partial.shape[-1], spec, overlap_chunks)
    chunks, comps = _quantize_staged(partial, spec, n_chunks)
    wires = _gather_staged(comps, group)
    totals = [_gathered_reduce(w, c, x, spec, keep_local_fp, accum)
              for w, c, x in zip(wires, comps, chunks)]
    total = totals[0] if n_chunks == 1 else torch.cat(totals, dim=-1)
    return total.to(partial.dtype)


def _compressed_psum_two_phase(partial: torch.Tensor, group, spec: MXSpec,
                               accum: torch.dtype) -> torch.Tensor:
    """Quantized reduce-scatter (all-to-all of the N destination slices of
    the features, then ``mx_dequant_reduce`` of the N received ones in rank
    order, the reference's ``jnp.sum(axis=0)``) and a quantized all-gather
    of the reduced slices."""
    n = dist.get_world_size(group)
    lead, f = partial.shape[:-1], partial.shape[-1]
    m = math.prod(lead)
    slices = partial.reshape(m, n, f // n).transpose(0, 1).contiguous()   # (N, M, F/N)
    comp = ops.mx_quantize(slices, spec)
    recv = MXCompressed(_all_to_all(comp.payload, group), _all_to_all(comp.scales, group))
    out = partial.dtype if accum == torch.float32 else accum
    mine = ops.mx_dequant_reduce(recv, spec, out_dtype=out).to(partial.dtype)   # (M, F/N)
    comp2 = ops.mx_quantize(mine, spec)
    gathered = MXCompressed(_all_gather(comp2.payload, group),
                            _all_gather(comp2.scales, group))
    full = ops.mx_dequantize(gathered, spec, out_dtype=partial.dtype)          # (N, M, F/N)
    return full.transpose(0, 1).reshape(*lead, f)


_ACCUM = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rank_compressed_psum(partial: torch.Tensor, group, spec: MXSpec, *,
                         keep_local_fp: bool = False, accum_dtype: str = "float32",
                         variant: str = "gather", strict: bool = False,
                         overlap_chunks: int = 1) -> torch.Tensor:
    """The paper's compressed reduction of this rank's partial ``(..., F)``
    over ``group`` (F a multiple of the block size): the sum of every rank's
    partial up to quantization error, moving ``16 / effective_bits`` times
    fewer bytes than a bf16 reduction.

    ``variant="two_phase"`` runs the reduce-scatter + all-gather form when
    F divides into N block-aligned slices, and otherwise falls back to the
    gather variant with a warning (once per site) or, under ``strict``, a
    ``ValueError``. ``keep_local_fp`` (gather variant) adds the own partial
    at full precision; the result then differs from rank to rank by each
    rank's own quantization residual. ``accum_dtype``: the fused kernel
    sums in fp32 and hands the total over in this dtype (float32 or
    bfloat16), as the reference's kernel route does. Returns the partial's
    shape and dtype."""
    if _needs_grad(partial):
        return _PassThrough.apply(partial, lambda p: rank_compressed_psum(
            p, group, spec, keep_local_fp=keep_local_fp, accum_dtype=accum_dtype,
            variant=variant, strict=strict, overlap_chunks=overlap_chunks))
    accum = _ACCUM[accum_dtype]
    n = dist.get_world_size(group)
    f = partial.shape[-1]
    if variant == "two_phase":
        if n > 1 and f % (n * spec.block_size) == 0:
            return _compressed_psum_two_phase(partial, group, spec, accum)
        key = (spec.name, f, n)
        if n <= 1:
            _variant_downgrade(f"axis_size={n} is not plumbed (need the TP degree)",
                               strict, key)
        else:
            _variant_downgrade(f"feature dim {f} is not divisible by axis_size * "
                               f"block_size = {n * spec.block_size}", strict, key)
    return _compressed_psum_fwd(partial, group, spec, keep_local_fp, accum, overlap_chunks)


def rank_psum(partial: torch.Tensor, group) -> torch.Tensor:
    """The dense reduction of this rank's partial over ``group``: one
    all-reduce in the partial's dtype (the reference's ``lax.psum``). Its
    backward is the identity (every rank's replicated code hands back the
    same cotangent); where rank code reads the output, ``copy_to_group``
    after it reduces that code's gradient."""
    if _needs_grad(partial):
        return _PassThrough.apply(partial, lambda p: rank_psum(p, group))
    return _all_reduce_counted(partial, group, "all_reduce", "bytes")


def rank_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last axis in rank order,
    moved uncompressed in ``x``'s dtype: a column-parallel output made
    whole on every rank (one ``dense_all_gather``). Its backward keeps this
    rank's slice of the cotangent."""
    if _needs_grad(x):
        return _GatherLast.apply(x, group)
    out = _all_gather(x, group, "dense_all_gather")
    _TP["dense_all_gather_bytes"] += x.numel() * x.element_size()
    return torch.cat(out.unbind(0), dim=-1)


def compressed_all_gather(x: torch.Tensor, group, spec: MXSpec, *,
                          overlap_chunks: int = 1) -> torch.Tensor:
    """Every rank's ``x`` (``(N, *x.shape)``, rank order), moved in
    compressed form and dequantized to ``x``'s dtype; ``overlap_chunks``
    as in the gather reduction (bit-identical to one chunk)."""
    n_chunks = _overlap_chunks(x.shape[-1], spec, overlap_chunks)
    _, comps = _quantize_staged(x, spec, n_chunks)
    outs = [ops.mx_dequantize(w, spec, out_dtype=x.dtype)
            for w in _gather_staged(comps, group)]
    return outs[0] if n_chunks == 1 else torch.cat(outs, dim=-1)


def compressed_all_to_all(x: torch.Tensor, group, spec: MXSpec) -> torch.Tensor:
    """The MoE island's compressed exchange (the reference's
    ``compressed_all_to_all`` with ``split_axis = concat_axis = 0``): ``x``
    ``(N, ..., F)``, slice i for rank i, quantized along the last axis; the
    payload and the scales go through one ``all_to_all_single`` each and the
    received ``(N, ..., F)`` (slice j from rank j) is dequantized to
    ``x``'s dtype. Counted as one ``compressed_all_to_all`` with the bytes
    of both."""
    comp = ops.mx_quantize(x, spec)
    before = _TP["bytes"]
    recv = MXCompressed(_all_to_all(comp.payload, group, None),
                        _all_to_all(comp.scales, group, None))
    _TP["compressed_all_to_all"] += 1
    _TP["compressed_all_to_all_bytes"] += _TP["bytes"] - before
    return ops.mx_dequantize(recv, spec, out_dtype=x.dtype)


def dense_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The MoE island's exchange in ``x``'s own dtype: ``x`` ``(N, ...)``,
    slice i for rank i; returns slice j from rank j. One
    ``dense_all_to_all``."""
    before = _TP["bytes"]
    out = _all_to_all(x, group, "dense_all_to_all")
    _TP["dense_all_to_all_bytes"] += _TP["bytes"] - before
    return out


def dp_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every data rank's rows ``x`` ``(M, ...)`` stacked in rank order,
    ``(N * M, ...)``, moved in ``x``'s dtype: the island's row groups made
    whole on every rank (one ``dp_all_gather``)."""
    out = _all_gather(x, group, "dp_all_gather")
    _TP["dp_all_gather_bytes"] += x.numel() * x.element_size()
    return out.reshape(-1, *x.shape[1:])


def psum_maybe_compressed(partials: torch.Tensor,
                          policy: Optional[CompressionPolicy], *,
                          n_tokens: Optional[int] = None, group=None) -> torch.Tensor:
    """Policy-gated reduction: of N stacked partials ``(N, ..., F)`` on this
    card, or with ``group`` of this rank's partial ``(..., F)`` over the
    group's ranks.

    ``n_tokens`` defaults to the number of activation rows crossing the wire
    (the product of the dims between the shard axis, if any, and the
    features) — the prefill/decode discriminator of
    ``CompressionPolicy.active_for``."""
    rows = partials.shape[:-1] if group is not None else partials.shape[1:-1]
    if n_tokens is None:
        n_tokens = math.prod(rows)
    compress = policy is not None and policy.active_for(n_tokens)
    if group is None:
        if not compress:
            return psum(partials)
        check_stacked(policy)
        return compressed_psum(partials, policy.spec)
    if not compress:
        return rank_psum(partials, group)
    return rank_compressed_psum(
        partials, group, policy.spec, keep_local_fp=policy.keep_local_fp,
        accum_dtype=policy.accum_dtype, variant=policy.variant,
        strict=policy.strict_variant, overlap_chunks=policy.overlap_chunks)
