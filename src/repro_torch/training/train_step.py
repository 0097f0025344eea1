"""Train-step builder: the loss, its gradient and the AdamW update of one
step (the reference's ``training/train_step.py``).

The state is ``{"params": tree, "opt": OptState}`` of this process's
tensors: the whole model on one card; on a TP group the rank's shard of
every sharded leaf (``Model.init_params(tp=...)`` or
``convert.shard_params``) and every replicated leaf whole, with moments of
the same shapes. The reference's ``train_state_specs`` and
``batch_sharding`` have no counterpart: a rank's state is already its
shard, and its batch is its rows (``data.Batches(rows=...)``).

One step: ``Model.loss`` forward, ``torch.autograd.grad`` over every leaf
(a leaf the loss does not reach gets a zero gradient, as ``jax.grad``
gives it), on a data group one all-reduce of one fp32 bucket that averages
every gradient and the metrics over the data ranks
(``collectives.dp_mean``), then ``adamw_update`` in place, with the global
norm taken over the TP group (sharded leaves' squares summed over it,
replicated leaves once). A data rank holds its TP shard of the weights and
moments whole: the reference's ZeRO sharding over data
(``TPContext.zero_weights``) moves where memory sits, not the numbers, and
is not ported (ROADMAP.md).

Refused (``check_trainable``, at build time): a ``keep_local_fp`` policy on
a TP group, and a MoE on a data group.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import dp_mean
from repro_torch.core.policy import CompressionPolicy
from repro_torch.core.tp import TPContext
from repro_torch.models.model import Model, layer_block, param_shapes, shard_axis
from repro_torch.training.optimizer import (
    AdamWConfig, adamw_update, init_opt_state, leaves, rebuild,
)

__all__ = ["make_train_step", "init_train_state", "sharded_leaves", "check_trainable"]


def check_trainable(cfg: ModelConfig, policy: CompressionPolicy, tp: int, dp: int) -> None:
    """Raise for what the port does not train on ``tp`` x ``dp`` ranks:
    ``keep_local_fp`` on a TP group (each rank keeps its own quantization
    residual, so the ranks' replicated weights would part; the engine
    refuses it too), and a MoE family on a data group (the expert-parallel
    island's all-to-alls and gather have no backward: its experts' and
    router's gradients would come back as zeros)."""
    if tp > 1 and policy.enabled and policy.keep_local_fp:
        raise ValueError(
            "keep_local_fp on a TP group gives each rank its own reduced activations (its "
            "own quantization residual), so the ranks' replicated weights would part; "
            "refused as the engine refuses it (ROADMAP.md Queue 3 item 11)")
    if dp > 1 and any(s.moe for s in cfg.layers):
        raise NotImplementedError(
            f"{cfg.name} on {dp} data ranks: a MoE's expert-parallel island and its "
            f"data-sharded experts need backward all-to-alls, which the port does not train "
            f"yet (ROADMAP.md Queue 1 item 1); train it on a TP group alone")


def sharded_leaves(model: Model, tp: int) -> List[bool]:
    """Per leaf (``leaves`` order): whether a TP group of ``tp`` ranks
    shards it (``model.shard_axis``); all False on one rank."""
    cfg = model.cfg

    def walk(node, key, parent, block=None):
        if isinstance(node, dict):
            return [f for k in sorted(node) for f in walk(node[k], k, key, block)]
        if isinstance(node, list):
            return [f for i, v in enumerate(node)
                    for f in walk(v, key, parent, layer_block(cfg, key, i, block))]
        return [tp > 1 and shard_axis(parent, key, block) is not None]

    return walk(param_shapes(cfg), "", "")


def make_train_step(model: Model, ctx: TPContext, opt_cfg: AdamWConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the state updated in
    place, metrics 0-d tensors (``loss``, ``ce``, aux losses,
    ``grad_norm``) and ``lr`` (a float); on a data group the loss and
    metrics are the data ranks' mean. Raises as ``check_trainable``."""
    check_trainable(model.cfg, ctx.policy, ctx.tp_size, ctx.dp_size)
    sharded = sharded_leaves(model, ctx.tp_size)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        params = state["params"]
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = model.loss(ctx, params, batch)
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
        names = sorted(metrics)
        values = [metrics[k].detach().reshape(1) for k in names]
        if ctx.dp_group is not None:
            *grads, vals = dp_mean(grads + [torch.cat(values)], ctx.dp_group)
            values = list(vals.unbind(0))
        metrics = {k: v.detach().reshape(()) for k, v in zip(names, values)}
        with torch.no_grad():
            params, opt, opt_metrics = adamw_update(
                opt_cfg, params, rebuild(params, grads), state["opt"], sharded=sharded,
                tp_group=ctx.tp_group)
        return {"params": params, "opt": opt}, {**metrics, **opt_metrics}

    return train_step


def init_train_state(model: Model, params=None, **init) -> Dict[str, Any]:
    """``{"params": params, "opt": init_opt_state(params)}``: ``params`` as
    given (from ``convert``: this rank's shard on a group), else
    ``model.init_params(**init)`` (``device``, ``seed``, ``tp``, ``dp``)."""
    if params is None:
        params = model.init_params(**init)
    return {"params": params, "opt": init_opt_state(params)}
