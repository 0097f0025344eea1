"""Mixture-of-Experts layer: the reference's ``models/moe.py`` (top-k routing,
the capacity-bound sort-based dispatch, the tiny-token dense path, shared
experts, and the expert-parallel island of a ``data x model`` grid).

Routing is grouped, as the reference's: the call's tokens, flattened in
(batch, sequence) order (the mixed step's budget pads last), split into ``G
= num_groups(dp_size, B)`` groups of ``B / G`` whole batch rows, and each
group is dispatched on its own with the capacity of its ``Tg`` tokens.
Without a data group G is 1: one group of every token of the call. Routing
runs in fp32: softmax, the ``top_k`` largest in descending order with ties
to the lower expert (``jax.lax.top_k``'s order, from a stable sort), gates
renormalised by ``max(sum, 1e-9)``. With more than 64 tokens in the call the
dispatch is the reference's, per group: a stable sort of the group's
(token, choice) slots by expert id, each slot's position within its expert
from the segment starts (``searchsorted``), slots at position ``>= C`` sent
to the group's overflow row ``E*C`` (dropped), a scatter into the group's
``(E*C + 1, d)`` buffer, the experts' SwiGLU (always silu-gated, whatever
``cfg.activation`` says), and the combine as a scatter-add of each token's
``top_k`` gated rows onto zeros in the activation dtype. Which tokens drop
depends on the stable order of every token of the group, as in the
reference. With 64 tokens or fewer every expert runs on every token and the
outputs are mixed by the gate weights (the groups play no part). Nothing
here reads a device value on the host, so the layer runs inside a captured
CUDA graph.

Tensor parallelism: each rank holds its experts' slice of ``d_ff`` (``up`` /
``gate`` by columns, ``down`` by rows) and routes every token itself (the
router is replicated), so its combine is a partial sum of the routed output,
reduced over the TP group with one dense all-reduce
(``collectives.rank_psum``) after the combine: the combine is linear, so
reducing after it instead of before changes only rounding. The reference's
TP-only mesh leaves this reduction to GSPMD, uncompressed
(``moe.py:81-90``). Under ``simulate_tp`` the routed experts run unsplit, as
the reference's simulated path runs them.

Data-parallel ranks (``TPContext.dp_group`` of ``dp`` ranks): when ``E %
dp == 0`` each data rank holds ``E / dp`` experts (experts ``[r E/dp, (r+1)
E/dp)`` on data rank r, ``shard_params`` / ``Model.init_params(dp=...)``),
else every expert. The expert-parallel island runs exactly when the
reference's ``use_island`` holds on a call that dispatches (``E % dp == 0``
and ``G == dp > 1``): data rank g dispatches group g, one all-to-all over
the data group hands each rank its experts' rows of every group, it runs
SwiGLU on its ``d_ff`` slice of those experts, reduces the ``down`` partial
``(dp, E/dp, C, d)`` over the TP group with the policy's reduction
(``psum_maybe_compressed`` with ``n_tokens = dp * E/dp * C``: the paper's
compressed collective, which now reaches the routed experts), and a second
all-to-all sends the rows back. The all-to-alls are compressed
(``collectives.compressed_all_to_all``) under an enabled policy's
``compress_all_to_all``, dense otherwise. After the combine one dense
all-gather over the data group (``collectives.dp_all_gather``) gives every
rank the whole batch again: every data rank computes every row outside the
island (the pools are replicated over data, as the reference pins them).
Any other call on a rank that holds ``E / dp`` experts runs them on every
group of the call and sums the ranks' partial outputs with one dense
all-reduce over the TP group and one over the data group. Shared experts
are dense MLPs (``models/mlp.py``): their ``down`` reduction is the
policy's compressed one on every path.

Training: ``moe(..., aux=True)`` gives the reference's aux losses; on a TP
group the routed experts' tokens and gates go through
``collectives.copy_to_group`` (their gradient shares summed in backward) and
``rank_psum``'s backward is the identity. The island has no backward here
(its all-to-alls' backwards are a later slice): training refuses a MoE on a
data group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import (
    compressed_all_to_all, copy_to_group, count_island, dense_all_to_all, dp_all_gather,
    psum_maybe_compressed, rank_psum, tp_counts,
)
from repro_torch.core.tp import TPContext
from repro_torch.models.mlp import mlp

__all__ = ["moe", "capacity", "route", "num_groups", "uses_island", "DENSE_MAX_TOKENS"]

DENSE_MAX_TOKENS = 64   # at most this many tokens: every expert on every token


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a group of ``tokens`` tokens (the reference's
    expression, so it rounds the same way)."""
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(1, c)


def num_groups(dp: int, batch: int) -> int:
    """Token groups of a call of ``batch`` rows on ``dp`` data ranks: the
    largest divisor of ``batch`` not above ``dp`` (the reference's
    ``_num_groups``)."""
    g = dp
    while batch % g != 0:
        g -= 1
    return max(g, 1)


def uses_island(cfg: ModelConfig, dp: int, batch: int, tokens: int) -> bool:
    """Whether a MoE call of ``batch`` rows and ``tokens`` tokens runs the
    expert-parallel island on ``dp`` data ranks: it dispatches (more than
    ``DENSE_MAX_TOKENS`` tokens), ``E % dp == 0`` and ``G == dp > 1`` (the
    reference's ``use_island`` after its tiny-token gate)."""
    return (dp > 1 and tokens > DENSE_MAX_TOKENS and cfg.n_experts % dp == 0
            and num_groups(dp, batch) == dp)


def route(params, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (router logits (T, E) fp32, probs (T, E), gates (T, k)
    renormalised, expert ids (T, k) int64 in descending order of prob)."""
    logits = torch.matmul(x.float(), params["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gates, idx


def _aux_losses(logits, probs, idx, E: int, G: int) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance loss (per group, averaged over the G
    groups) and router z-loss (fp32 scalars)."""
    T, k = idx.shape
    me = F.one_hot(idx, E).float().view(G, T // G * k, E).mean(dim=1)
    ce = probs.view(G, T // G, E).mean(dim=1)
    return {"load_balance": E * (me * ce).sum(-1).mean(),
            "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()}


def _dense_mixture(params, x, gates, idx, first: int) -> torch.Tensor:
    """This rank's experts ``first ..`` on every token of x (T, d), mixed by
    the gate weights: (T, d)."""
    experts = torch.arange(first, first + params["up"]["w"].shape[0], device=x.device)
    wmix = (gates[..., None] * (idx[..., None] == experts)).sum(-2).to(x.dtype)  # (T, El)
    # x broadcast over the experts: an (E, d, f) weight is read in place (an
    # einsum of "td,edf" would copy it into one (d, E*f) matrix first)
    h = torch.matmul(x, params["up"]["w"].to(x.dtype))                 # (El, T, f)
    g = torch.matmul(x, params["gate"]["w"].to(x.dtype))
    eo = torch.bmm(F.silu(g) * h, params["down"]["w"].to(x.dtype))    # (El, T, d)
    return torch.einsum("etd,te->td", eo, wmix)


def _experts(params, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of this rank's experts on their rows xe (El, N, d): (El, N, d)."""
    h = torch.bmm(xe, params["up"]["w"].to(xe.dtype))
    g = torch.bmm(xe, params["gate"]["w"].to(xe.dtype))
    return torch.bmm(F.silu(g) * h, params["down"]["w"].to(xe.dtype))


def _dispatch(x, gates, idx, E: int, C: int, G: int):
    """The sort-based capacity dispatch of x (T, d) in G groups of T/G rows:
    (expert_in (G, E, C, d), the flat buffer row of each (token, choice)
    slot, its source row of x, its gate), slots in each group's sorted
    order."""
    T, d = x.shape
    Tg, k = T // G, idx.shape[1]
    R = E * C + 1                                         # a group's rows, overflow last
    dev = x.device
    fe = idx.reshape(G, Tg * k)                           # expert id per slot
    base = torch.arange(G, device=dev)[:, None]
    order = (torch.argsort(fe, dim=-1, stable=True) + base * (Tg * k)).reshape(-1)
    se = idx.reshape(-1).index_select(0, order).view(G, Tg * k)   # sorted expert ids
    st = order // k                                       # source token (row of x)
    sg = gates.reshape(-1).to(x.dtype).index_select(0, order)
    starts = torch.searchsorted(se, torch.arange(E, device=dev, dtype=se.dtype)
                                .expand(G, E).contiguous())
    pos = torch.arange(Tg * k, device=dev) - starts.gather(1, se)
    dest = (torch.where(pos < C, se * C + pos, E * C) + base * R).reshape(-1)
    # duplicate indices only at the discarded overflow rows
    buf = x.new_zeros(G * R, d).index_copy_(0, dest, x.index_select(0, st))
    expert_in = buf.view(G, R, d)[:, :E * C].reshape(G, E, C, d)
    return expert_in, dest, st, sg


def _combine(eo: torch.Tensor, dest, st, sg, T: int) -> torch.Tensor:
    """Each token's ``top_k`` gated expert rows of eo (G, E, C, d) summed
    onto zeros (at most top_k terms a token: the same bits in any order):
    (T, d)."""
    G, E, C, d = eo.shape
    flat = torch.cat([eo.reshape(G, E * C, d), eo.new_zeros(G, 1, d)], dim=1)
    contrib = flat.reshape(-1, d).index_select(0, dest) * sg[:, None]
    return eo.new_zeros(T, d).index_add_(0, st, contrib)


def _island(ctx: TPContext, params, expert_in: torch.Tensor) -> torch.Tensor:
    """The expert-parallel island on this data rank's group: expert_in (E, C,
    d) -> its experts' outputs (E, C, d), through this rank's E/dp experts
    on every group's rows (module docstring)."""
    E, C, d = expert_in.shape
    dp, policy = ctx.dp_size, ctx.policy
    El = E // dp
    if policy.enabled and policy.compress_all_to_all:
        a2a = lambda t: compressed_all_to_all(t, ctx.dp_group, policy.spec)
    else:
        a2a = lambda t: dense_all_to_all(t, ctx.dp_group)
    x = a2a(expert_in.reshape(dp, El, C, d))              # (dp source groups, El, C, d)
    part = _experts(params, x.transpose(0, 1).reshape(El, dp * C, d))
    part = part.view(El, dp, C, d).transpose(0, 1).contiguous()      # (dp, El, C, d)
    before = tp_counts()["bytes"]
    if ctx.tp_group is not None:
        part = psum_maybe_compressed(part, policy, n_tokens=dp * El * C, group=ctx.tp_group)
    count_island(tp_counts()["bytes"] - before)
    return a2a(part).reshape(E, C, d)                     # back: expert blocks in order


def moe(ctx: TPContext, params, x: torch.Tensor, cfg: ModelConfig, *,
        aux: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), aux losses). The losses
    (``load_balance``, ``router_z``) are computed only with ``aux=True``
    (serving never asks: the reference's serving programs drop them as
    dead code); else the dict is empty."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    dp = ctx.dp_size
    G = num_groups(dp, B)
    El = params["up"]["w"].shape[0]     # this rank's experts: E, or E / dp on a data group
    first = ctx.dp_rank * El if El < E else 0
    x2 = x.reshape(T, d)
    logits, probs, gates, idx = route(params, x2, cfg)
    losses = _aux_losses(logits, probs, idx, E, G) if aux else {}
    if uses_island(cfg, dp, B, T):
        Tg, g = T // G, ctx.dp_rank
        rows = slice(g * Tg, (g + 1) * Tg)
        expert_in, dest, st, sg = _dispatch(x2[rows], gates[rows], idx[rows], E,
                                            capacity(cfg, Tg), 1)
        eo = _island(ctx, params, expert_in[0])
        out = dp_all_gather(_combine(eo[None], dest, st, sg, Tg), ctx.dp_group)
    else:
        # training on a TP group: the replicated tokens and gates meet this
        # rank's d_ff slice (a partial of every expert row), so each rank's
        # gradient of them is a share, summed over the group in backward
        # (the router itself runs replicated)
        x2, gates = copy_to_group(x2, ctx.tp_group), copy_to_group(gates, ctx.tp_group)
        if T <= DENSE_MAX_TOKENS:
            out = _dense_mixture(params, x2, gates, idx, first)
        else:
            C = capacity(cfg, T // G)
            expert_in, dest, st, sg = _dispatch(x2, gates, idx, E, C, G)
            mine = expert_in[:, first:first + El]              # (G, El, C, d)
            eo = _experts(params, mine.transpose(0, 1).reshape(El, G * C, d))
            eo = eo.view(El, G, C, d).transpose(0, 1)
            if El < E:   # the other data ranks' experts contribute nothing here
                eo = torch.cat([eo.new_zeros(G, first, C, d), eo,
                                eo.new_zeros(G, E - first - El, C, d)], dim=1)
            out = _combine(eo, dest, st, sg, T)
        if ctx.tp_group is not None:   # this rank's d_ff slice of its experts: a partial
            out = rank_psum(out, ctx.tp_group)
        if El < E:                     # and of its data rank's experts
            out = rank_psum(out, ctx.dp_group)
    out = out.reshape(B, S, d)
    for i in range(cfg.n_shared_experts):
        out = out + mlp(ctx, params[f"shared{i}"], x, cfg)
    return out, losses
