"""Mixture-of-Experts layer: the reference's ``models/moe.py`` (top-k routing,
the capacity-bound sort-based dispatch, the tiny-token dense path, shared
experts) for one group of tokens.

The reference splits tokens into groups aligned with its data shards; the
port has no data axis, so there is one group of every token of the call,
flattened in (batch, sequence) order (the mixed step's budget pads last).
Routing runs in fp32: softmax, the ``top_k`` largest in descending order
with ties to the lower expert (``jax.lax.top_k``'s order, from a stable
sort), gates renormalised by ``max(sum, 1e-9)``. With more than 64 tokens
the dispatch is the reference's: a stable sort of the (token, choice) slots
by expert id, each slot's position within its expert from the segment
starts (``searchsorted``), slots at position ``>= C`` sent to the overflow
row ``E*C`` (dropped), a scatter into the ``(E*C + 1, d)`` buffer, the
experts' SwiGLU (always silu-gated, whatever ``cfg.activation`` says), and
the combine as a scatter-add of each token's ``top_k`` gated rows onto zeros
in the activation dtype. Which tokens drop depends on the stable order of
every token of the call, as in the reference. With 64 tokens or fewer every
expert runs on every token and the outputs are mixed by the gate weights.
Nothing here reads a device value on the host, so the layer runs inside a
captured CUDA graph.

Tensor parallelism: each rank holds every expert's slice of ``d_ff``
(``up`` / ``gate`` by columns, ``down`` by rows) and routes every token
itself (the router is replicated), so its combine is a partial sum of the
routed output. On a TP group that (T, d) partial is reduced with one dense
all-reduce (``collectives.rank_psum``) after the combine: the combine is
linear, so reducing after it instead of before changes only rounding. The
reference's TP-only mesh leaves this reduction to GSPMD, uncompressed
(``moe.py:81-90``); its compressed expert-parallel island needs data-parallel
ranks, which the port does not have. Under ``simulate_tp`` the routed
experts run unsplit, as the reference's simulated path runs them. Shared
experts are dense MLPs (``models/mlp.py``): their ``down`` reduction is the
policy's compressed one on either path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import rank_psum
from repro_torch.core.tp import TPContext
from repro_torch.models.mlp import mlp

__all__ = ["moe", "capacity", "route", "DENSE_MAX_TOKENS"]

DENSE_MAX_TOKENS = 64   # at most this many tokens: every expert on every token


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (the reference's expression,
    so it rounds the same way)."""
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(1, c)


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


def _aux_losses(logits, probs, idx, E: int) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance loss and router z-loss (fp32 scalars)."""
    me = F.one_hot(idx, E).float().mean(dim=(0, 1))
    ce = probs.mean(dim=0)
    return {"load_balance": E * (me * ce).sum(),
            "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()}


def _dense_mixture(params, x, gates, idx, E: int) -> torch.Tensor:
    """Every expert on every token (T, d), mixed by the gate weights."""
    experts = torch.arange(E, device=x.device)
    wmix = (gates[..., None] * (idx[..., None] == experts)).sum(-2).to(x.dtype)  # (T, E)
    # x broadcast over the experts: an (E, d, f) weight is read in place (an
    # einsum of "td,edf" would copy it into one (d, E*f) matrix first)
    h = torch.matmul(x, params["up"]["w"].to(x.dtype))                 # (E, T, f)
    g = torch.matmul(x, params["gate"]["w"].to(x.dtype))
    eo = torch.bmm(F.silu(g) * h, params["down"]["w"].to(x.dtype))    # (E, T, d)
    return torch.einsum("etd,te->td", eo, wmix)


def _dispatch(params, x, gates, idx, E: int, C: int) -> torch.Tensor:
    """The sort-based capacity dispatch of x (T, d): (T, d)."""
    T, d = x.shape
    k = idx.shape[1]
    dev = x.device
    fe = idx.reshape(-1)                                  # expert id per slot
    fg = gates.reshape(-1).to(x.dtype)
    order = torch.argsort(fe, stable=True)
    se = fe.index_select(0, order)                        # sorted expert ids
    st = order // k                                       # source token
    sg = fg.index_select(0, order)
    starts = torch.searchsorted(se, torch.arange(E, device=dev, dtype=se.dtype))
    pos = torch.arange(T * k, device=dev) - starts.index_select(0, se)
    dest = torch.where(pos < C, se * C + pos, E * C)      # E*C: the overflow row
    # duplicate indices only at the discarded overflow row
    buf = x.new_zeros(E * C + 1, d).index_copy_(0, dest, x.index_select(0, st))
    expert_in = buf[:E * C].view(E, C, d)
    h = torch.bmm(expert_in, params["up"]["w"].to(x.dtype))
    g = torch.bmm(expert_in, params["gate"]["w"].to(x.dtype))
    eo = torch.bmm(F.silu(g) * h, params["down"]["w"].to(x.dtype))     # (E, C, d)
    flat = torch.cat([eo.reshape(E * C, d), eo.new_zeros(1, d)])
    contrib = flat.index_select(0, dest) * sg[:, None]
    # at most top_k terms a token, onto zeros: the same bits in any order
    return x.new_zeros(T, d).index_add_(0, st, contrib)


def moe(ctx: TPContext, params, x: torch.Tensor, cfg: ModelConfig, *,
        aux: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), aux losses). The losses
    (``load_balance``, ``router_z``) are computed only with ``aux=True``
    (serving never asks: the reference's serving programs drop them as
    dead code); else the dict is empty."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    x2 = x.reshape(T, d)
    logits, probs, gates, idx = route(params, x2, cfg)
    losses = _aux_losses(logits, probs, idx, E) if aux else {}
    if T <= DENSE_MAX_TOKENS:
        out = _dense_mixture(params, x2, gates, idx, E)
    else:
        out = _dispatch(params, x2, gates, idx, E, capacity(cfg, T))
    if ctx.tp_group is not None:   # this rank's d_ff slice of every expert: a partial
        out = rank_psum(out, ctx.tp_group)
    out = out.reshape(B, S, d)
    for i in range(cfg.n_shared_experts):
        out = out + mlp(ctx, params[f"shared{i}"], x, cfg)
    return out, losses
