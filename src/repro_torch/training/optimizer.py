"""AdamW with a cosine schedule and global-norm clipping on the parameter
tree: the reference's ``training/optimizer.py``, as plain functions.

The update is the reference's, step for step: the gradients in fp32, one
global norm, the clip scale ``min(1, clip / max(norm, 1e-9))``, the moments
in fp32, the bias corrections and the learning rate at the new step in
fp32, and ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)`` in fp32,
rounded once to the weight's dtype (``torch.optim.AdamW`` on bf16 weights
would round twice: after the decay and after the step). The leaves go
through ``torch._foreach_*`` in batches of about 2^26 elements, so the
update's fp32 transients stay a batch's, not the model's.

On a TP group (``tp_group``) the norm is the whole model's: each rank's
squares of its TP-sharded leaves (``sharded``: a bool per leaf, in
``leaves`` order) are summed over the group with one all-reduce, and the
replicated leaves, whole and equal on every rank, count once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import rank_sum_scalar

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update", "cosine_lr",
           "leaves", "rebuild", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any      # first moment (a tree like the params, fp32)
    nu: Any      # second moment
    step: int    # updates taken


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list tree in the reference's leaf
    order (``jax.tree.leaves``: dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def rebuild(like, flat: Sequence[Any]):
    """A tree shaped like ``like`` holding ``flat`` in ``leaves`` order."""
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it)

    return walk(like)


def init_opt_state(params) -> OptState:
    zeros = lambda: rebuild(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                     for p in leaves(params)])
    return OptState(mu=zeros(), nu=zeros(), step=0)


def cosine_lr(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``, computed in fp32 as the reference's."""
    f = np.float32
    s = f(step)
    warm = s / f(max(cfg.warmup_steps, 1))
    prog = np.clip((s - f(cfg.warmup_steps)) / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return float(f(cfg.lr) * (warm if s < f(cfg.warmup_steps) else cos))


def global_norm(grads: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                tp_group=None) -> torch.Tensor:
    """The fp32 norm of every gradient (0-d, on the gradients' device); on
    ``tp_group`` the sharded leaves' squares summed over the group first."""
    sq = lambda ts: (torch.stack([torch.sum(g.float() * g.float()) for g in ts]).sum()
                     if ts else torch.zeros((), device=grads[0].device))
    if tp_group is None or sharded is None:
        return torch.sqrt(sq(grads))
    part = sq([g for g, s in zip(grads, sharded) if s])
    whole = sq([g for g, s in zip(grads, sharded) if not s])
    return torch.sqrt(rank_sum_scalar(part, tp_group) + whole)


_GROUP_ELEMS = 1 << 26   # leaves updated per foreach batch: about 256 MB of fp32 each


def _groups(ts: Sequence[torch.Tensor]) -> List[List[int]]:
    """Leaf indices in batches of about ``_GROUP_ELEMS`` elements, so the
    update's fp32 transients stay a few batches' worth, not the model's."""
    out: List[List[int]] = [[]]
    n = 0
    for i, t in enumerate(ts):
        if out[-1] and n + t.numel() > _GROUP_ELEMS:
            out.append([])
            n = 0
        out[-1].append(i)
        n += t.numel()
    return out


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState, *,
                 sharded: Optional[Sequence[bool]] = None, tp_group=None):
    """Returns (params, new state, metrics ``{"grad_norm": 0-d tensor, "lr":
    float}``). The weights and the moments are updated in place (the
    returned trees hold the same tensors); ``grads`` is a tree like the
    params."""
    p_l, g_l = leaves(params), leaves(grads)
    mu, nu = leaves(state.mu), leaves(state.nu)
    gnorm = global_norm(g_l, sharded, tp_group)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    step = state.step + 1
    b1, b2 = cfg.betas
    f = np.float32
    bc1 = float(f(1) - f(b1) ** f(step))
    bc2 = float(f(1) - f(b2) ** f(step))
    lr = cosine_lr(cfg, step)
    for idx in _groups(p_l):
        p, m, v = [p_l[i] for i in idx], [mu[i] for i in idx], [nu[i] for i in idx]
        g = torch._foreach_mul([g_l[i].float() for i in idx], scale)
        torch._foreach_mul_(m, b1)                           # b1 m + (1 - b1) g
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        gg = torch._foreach_mul(g, 1 - b2)                   # b2 v + ((1 - b2) g) g
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        del g, gg
        den = torch._foreach_div(v, bc2)                     # sqrt(vhat) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(m, bc1)                   # mhat / den + wd p
        torch._foreach_div_(delta, den)
        del den
        p32 = [t.float() for t in p]
        torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        new = torch._foreach_sub(p32, delta)                 # p - lr delta, rounded once
        del delta, p32
        for t, n in zip(p, new):
            t.copy_(n)
    return params, OptState(mu=state.mu, nu=state.nu, step=step), {"grad_norm": gnorm, "lr": lr}
