"""Tensor-parallel linear layers — simulated on one card, or across the
ranks of a TP group — and the sequence-sharded paged pools over a kv group
of ranks: the port's ``core/tp.py``.

``TPContext`` carries the compression policy and one of two ways to run
the row-parallel reductions the paper compresses:

* ``simulate_tp = N > 1`` (one card): with an active policy,
  ``row_linear`` splits its contraction into N partial sums exactly as N
  ranks would and reduces them through ``collectives.compressed_psum``, so
  the codec runs on the served path of one card. The policy's
  ``variant="two_phase"`` re-quantizes the reduced result once more (one
  more ``mx_quantize`` and ``mx_dequantize``); ``keep_local_fp``,
  ``overlap_chunks`` and ``accum_dtype`` have no effect there, as in the
  reference's simulated ``row_linear``.
* ``tp_group`` (a ``torch.distributed`` group of N ranks, the reference's
  ``model`` mesh axis): each rank holds ``1/N`` of the heads and of the MLP
  columns (``ModelConfig.tp_shard``, ``Model.init_params(tp=...)``).
  ``column_linear`` is the local product on this rank's output columns (no
  collective); ``row_linear`` reduces this rank's partial with
  ``collectives.psum_maybe_compressed`` over the group (the compressed rank
  collective, every policy option included, or an all-reduce under the
  ``min_tokens`` gate) and adds the bias once, after the reduction;
  ``fused_mlp`` is their composition. ``transport`` says how the group
  moves bytes (``launch/mesh.py``).

The two are exclusive.

Training (autograd through either path): on a TP group the replicated
input of a ``column_linear`` goes through ``collectives.copy_to_group`` at
its caller (once for the products that share it, as q/k/v do) and that of
``fused_mlp``'s gate and up inside it, so its gradient is summed over the
group in backward (each rank's columns give only their share); the rank
reductions' own backwards are in ``collectives``. The
simulated compressed reduction has the reference's gradient, zero: the
reference's ``fake_quantize`` has no custom gradient, so nothing flows back
through a quantized partial (its inputs are detached here). ``remat``
recomputes each layer in backward (``torch.utils.checkpoint``,
non-reentrant), as the reference's ``_maybe_remat``.

Data-parallel ranks (the reference's ``data`` mesh axis): ``dp_group`` is a
``torch.distributed`` group of the ``dp_size`` ranks that hold the same TP
shard (one column of a ``data x model`` grid; ``tp_group`` is its row). Every
data rank runs the whole engine on the same requests and computes every row
outside the MoE layers; a MoE layer that meets the reference's island gate
splits its tokens into ``dp_size`` groups, and data rank g routes group g
through its ``E / dp_size`` experts (``models/moe.py``).

Sequence-sharded pools (the reference's kv mesh axis): ``TPContext.kv_group``
is a ``torch.distributed`` process group of ``kv_shards`` ranks, each of
which runs the whole model and holds a contiguous slab of ``per_shard =
n_blocks // kv_shards`` blocks of every pool. Global block id ``g`` lives on
rank ``g // per_shard`` at local row ``g % per_shard``. Writes are
communication-free (a rank drops the rows it does not own); the read side
exchanges exactly the blocks a step's tables name (``pool_exchange``, one
``masked_owner_psum`` per pool plane). Pool ops update the local slabs in
place and return them, so call sites read like the reference's.

The three groups compose into the reference's ``kv x data x model`` mesh
(``launch/mesh.py``): a kv group is then the K ranks of one (data, model)
position, and every pool plane a rank holds is its TP-local slab
``(per_shard, bs, width / M)``, since the engine sizes its pools from the
rank-local config (the rank's kv heads: the reference's ``P(kv, None, m)``
split of the plane's width). The pool ops see only the slab, so each
plane's exchange runs over the kv group of the rank's position, while the
row-parallel reductions stay on the row and the MoE island on the data
group. Two groups of one context share exactly this rank; a context whose
groups share more (the same group twice, say) raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.collectives import (
    compressed_psum, copy_to_group, masked_owner_psum, psum_maybe_compressed, transport,
)
from repro_torch.core.policy import CompressionPolicy, NO_COMPRESSION
from repro_torch.kernels import ops

__all__ = ["TPContext", "column_linear", "row_linear", "fused_mlp", "pool_exchange",
           "pool_scatter", "pool_block_write", "pool_block_fill", "pool_block_copy"]


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Everything model code needs to know about distribution: the
    compression policy, simulated TP on one device or the TP group of
    ranks, and the kv group of sequence-sharded pools (None: replicated
    pools)."""

    policy: CompressionPolicy = NO_COMPRESSION
    simulate_tp: int = 0     # single-device TP emulation: split row-parallel
                             # contractions into N quantized partial sums
    kv_group: Any = None     # torch.distributed ProcessGroup of the kv ranks
    tp_group: Any = None     # torch.distributed ProcessGroup of the TP ranks
    dp_group: Any = None     # torch.distributed ProcessGroup of the data ranks
    remat: bool = False      # recompute each layer in backward (training)

    def __post_init__(self):
        ranks = self.tp_group is not None or self.dp_group is not None
        if ranks and self.simulate_tp > 1:
            raise ValueError(
                f"simulate_tp={self.simulate_tp} with a tp_group or dp_group: a context "
                f"either simulates TP on one card or runs it across ranks, not both")
        groups = [(name, set(dist.get_process_group_ranks(g)))
                  for name, g in (("tp_group", self.tp_group), ("dp_group", self.dp_group),
                                  ("kv_group", self.kv_group)) if g is not None]
        for i, (a, ra) in enumerate(groups):
            for b, rb in groups[i + 1:]:
                if len(ra & rb) > 1:
                    raise ValueError(
                        f"{a} and {b} overlap in ranks {sorted(ra & rb)}: on a kv x data x "
                        f"model grid two groups of a rank share that rank alone "
                        f"(launch/mesh.py spawn_ranks(..., tp=M, kv=K))")

    @property
    def kv_shards(self) -> int:
        """Number of shards the paged pools' block dim is split into."""
        return dist.get_world_size(self.kv_group) if self.kv_group is not None else 1

    @property
    def kv_rank(self) -> int:
        """This process's shard: its rank in ``kv_group`` (0 when replicated)."""
        return dist.get_rank(self.kv_group) if self.kv_group is not None else 0

    @property
    def kv_sharded(self) -> bool:
        return self.kv_shards > 1

    @property
    def tp_size(self) -> int:
        """Ranks of the TP group (1 without one)."""
        return dist.get_world_size(self.tp_group) if self.tp_group is not None else 1

    @property
    def tp_rank(self) -> int:
        """This process's rank in ``tp_group`` (0 without one)."""
        return dist.get_rank(self.tp_group) if self.tp_group is not None else 0

    @property
    def dp_size(self) -> int:
        """Ranks of the data group (1 without one)."""
        return dist.get_world_size(self.dp_group) if self.dp_group is not None else 1

    @property
    def dp_rank(self) -> int:
        """This process's rank in ``dp_group`` (0 without one)."""
        return dist.get_rank(self.dp_group) if self.dp_group is not None else 0

    @property
    def transport(self) -> Optional[str]:
        """How the group of ranks moves bytes: ``"nccl"`` or
        ``"gloo-staged"`` (``launch/mesh.py``); None without a group."""
        group = next((g for g in (self.tp_group, self.dp_group, self.kv_group)
                      if g is not None), None)
        return None if group is None else transport(group)

    def without_compression(self) -> "TPContext":
        """The dense gate variant of this context (uncompressed reductions)."""
        if not self.policy.enabled:
            return self
        return dataclasses.replace(self, policy=NO_COMPRESSION)


def column_linear(ctx: TPContext, x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w with w (Fin, Fout): on a TP group, this rank's output
    columns (``w`` is its shard); no collective. In training the caller
    passes a replicated ``x`` through ``copy_to_group`` first."""
    y = torch.matmul(x, w.to(x.dtype))
    return y if bias is None else y + bias.to(y.dtype)


def row_linear(ctx: TPContext, x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               n_tokens: Optional[int] = None) -> torch.Tensor:
    """y = sum over shards of x_shard @ w_shard — the row-parallel layer whose
    reduction the paper compresses. x (..., Fin), w (Fin, Fout); bias added
    once after the reduction. On a TP group x and w are this rank's shard
    of the contraction and ``n_tokens`` (default: the rows of x) feeds the
    policy's ``min_tokens`` gate; the simulated path has no token gate (as
    in the reference)."""
    n = ctx.simulate_tp
    policy = ctx.policy
    if ctx.tp_group is not None:
        part = torch.matmul(x, w.to(x.dtype))
        y = psum_maybe_compressed(part, policy, n_tokens=n_tokens, group=ctx.tp_group)
    elif (n > 1 and policy.enabled and policy.compress_tp_reduce
            and x.shape[-1] % n == 0
            and w.shape[-1] % policy.spec.block_size == 0):
        fin, fout = x.shape[-1], w.shape[-1]
        # detached: the reference's gradient through fake_quantize is zero
        xs = x.detach().reshape(-1, n, fin // n).transpose(0, 1)   # (n, M, c)
        ws = w.detach().reshape(n, fin // n, fout).to(x.dtype)     # (n, c, o)
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


def fused_mlp(ctx: TPContext, x: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_up: torch.Tensor, w_down: torch.Tensor, *, act: Callable,
              n_tokens: Optional[int] = None) -> torch.Tensor:
    """Column (gate, up) + activation + row (down): ``act(x @ gate) * (x @
    up)`` (``act(x @ up)`` without a gate), then ``row_linear`` with
    ``down``. On a TP group the weights are this rank's shards: the hidden
    columns stay on the rank and only ``down``'s reduction crosses ranks
    (and, in training, one backward all-reduce of ``x``'s gradient)."""
    x = copy_to_group(x, ctx.tp_group)
    h = column_linear(ctx, x, w_up)
    h = act(column_linear(ctx, x, w_gate)) * h if w_gate is not None else act(h)
    return row_linear(ctx, h, w_down, n_tokens=n_tokens)


# --------------------------------------------------------------------------
# Sequence-sharded paged pools (the reference's core/tp.py:329-505). A pool
# plane is one (per_shard, bs, width) tensor of this rank: a dense K or V
# pool, or the payload or scales of a wire pool.
# --------------------------------------------------------------------------


def _kv_geometry(ctx: TPContext, slab: torch.Tensor) -> Tuple[Any, int]:
    """(kv group, per-shard block count) of a sharded pool plane."""
    assert ctx.kv_sharded, "pool ops need a kv-sharded context"
    return ctx.kv_group, slab.shape[0]


def _owned(ctx: TPContext, per_shard: int, blk: torch.Tensor):
    """(positions in ``blk`` of the global ids this rank owns, their local
    rows). One device-to-host sync: the scatters then drop the rest."""
    blk = blk.long()
    keep = torch.nonzero((blk // per_shard) == ctx.kv_rank)[:, 0]
    return keep, blk[keep] % per_shard


def pool_exchange(ctx: TPContext, pools: Sequence[torch.Tensor],
                  tables: torch.Tensor) -> List[torch.Tensor]:
    """The blocks ``tables`` (R, nb) names, from every plane in ``pools``,
    on every rank: returns (R*nb, bs, width) "virtual pools" in table order,
    ``out[r*nb + j] == pool[tables[r, j]]`` bit for bit (the global pool,
    which no rank holds). Each plane moves R*nb blocks (one all-reduce),
    never the whole pool."""
    group, per_shard = _kv_geometry(ctx, pools[0])
    flat = tables.reshape(-1).long()
    own = ((flat // per_shard) == ctx.kv_rank)[:, None, None]
    local = flat % per_shard
    return [masked_owner_psum(p[local], own, group) for p in pools]


def pool_scatter(ctx: TPContext, pools_vals, blk: torch.Tensor,
                 offs: torch.Tensor) -> List[torch.Tensor]:
    """Per-position append: each (plane, vals) pair writes ``vals[i]``
    ((N, width)) at (``blk[i]``, ``offs[i]``), in place. Communication-free:
    a rank writes only the rows it owns."""
    _, per_shard = _kv_geometry(ctx, pools_vals[0][0])
    keep, local = _owned(ctx, per_shard, blk)
    o = offs.long()[keep]
    for pool, vals in pools_vals:
        pool.index_put_((local, o), vals[keep])
    return [p for p, _ in pools_vals]


def pool_block_write(ctx: TPContext, pools_vals, block_ids) -> List[torch.Tensor]:
    """Whole-block write: each (plane, vals) pair writes ``vals`` ((n, bs,
    width)) at global blocks ``block_ids``, in place; communication-free."""
    ref = pools_vals[0][0]
    _, per_shard = _kv_geometry(ctx, ref)
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=ref.device)
    keep, local = _owned(ctx, per_shard, ids)
    for pool, vals in pools_vals:
        pool[local] = vals[keep]
    return [p for p, _ in pools_vals]


def pool_block_fill(ctx: TPContext, pools_fills, block: int) -> List[torch.Tensor]:
    """Fill global block ``block`` of each (plane, scalar) pair with the
    scalar (fault injection), in place, on its owner only."""
    _, per_shard = _kv_geometry(ctx, pools_fills[0][0])
    if int(block) // per_shard == ctx.kv_rank:
        for pool, fill in pools_fills:
            pool[int(block) % per_shard] = fill
    return [p for p, _ in pools_fills]


def pool_block_copy(ctx: TPContext, pools: Sequence[torch.Tensor], src: int,
                    dst: int) -> List[torch.Tensor]:
    """Copy global block ``src`` to block ``dst`` in every plane (the
    copy-on-write fork): the owner of ``src`` contributes it to one
    ``masked_owner_psum`` per plane, the owner of ``dst`` writes it."""
    group, per_shard = _kv_geometry(ctx, pools[0])
    src, dst = int(src), int(dst)
    own = torch.tensor(src // per_shard == ctx.kv_rank)
    for p in pools:
        data = masked_owner_psum(p[src % per_shard], own.to(p.device), group)
        if dst // per_shard == ctx.kv_rank:
            p[dst % per_shard] = data
    return list(pools)
