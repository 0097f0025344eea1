"""Weight bridge: the reference's parameter tree, already converted to numpy,
into the port's parameter dict — so both frameworks compute with identical
weights (tests build the numpy tree with ``jax.tree.map(np.asarray, params)``
on the reference's ``Model.init_params``) — and its optimizer state
(``opt_state_from_numpy``); a rank's shard of a tree (``shard_params``) and
its inverse over the ranks of a group (``gather_params``)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import (
    check_supported, expert_range, is_expert_leaf, layer_block, param_shapes, shard_axis,
    shard_leaf, torch_dtype,
)

__all__ = ["params_from_numpy", "shard_params", "gather_params", "opt_state_from_numpy"]


def _convert(node: Any, dtype: torch.dtype, device: torch.device, path: str):
    if isinstance(node, dict):
        return {k: _convert(v, dtype, device, f"{path}/{k}") for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, dtype, device, f"{path}[{i}]") for i, v in enumerate(node)]
    arr = np.asarray(node)
    if arr.dtype.kind not in "fV":  # bfloat16 from ml_dtypes reports kind "V"
        raise TypeError(f"{path}: expected a float array, got {arr.dtype}")
    # bfloat16 -> float32 is exact; the cast back to ``dtype`` restores it
    return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)


def _check_tree(got, want, path: str) -> None:
    """``got`` (tensors) has exactly the keys, list lengths and leaf shapes
    of ``want`` (``param_shapes``)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"{path or '/'}: keys {have}, expected {sorted(want)}")
        for k in want:
            _check_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            n = len(got) if isinstance(got, list) else type(got).__name__
            raise ValueError(f"{path}: {n} entries, expected {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_tree(g, w, f"{path}[{i}]")
    elif tuple(got.shape) != tuple(want):
        raise ValueError(f"{path}: shape {tuple(got.shape)}, expected {tuple(want)}")


def params_from_numpy(tree, cfg: ModelConfig, device: str | torch.device = "cuda"):
    """Numpy parameter tree (reference names and layouts) -> torch tensors on
    ``device`` in the config's dtype. Checks the tree against ``cfg``'s
    (``model.param_shapes``): the layer count, every leaf's shape, biases
    and q/k norms where the config has them, no ``gate`` for a non-gated
    MLP and no ``lm_head`` for tied embeddings; a vision model's
    ``mm_proj``, an encoder-decoder's ``enc_layers``, ``enc_norm`` and
    ``xattn``."""
    check_supported(cfg)
    dev = resolve_device(device)
    params = _convert(tree, torch_dtype(cfg.dtype), dev, "")
    _check_tree(params, param_shapes(cfg), "")
    return params


def shard_params(tree, cfg: ModelConfig, rank: int, n: int, *, dp_rank: int = 0,
                 dp: int = 1):
    """Rank ``rank``'s shard of a numpy parameter tree (reference names and
    layouts) on a TP group of ``n`` ranks, in data rank ``dp_rank`` of
    ``dp`` (a ``data x model`` grid), by ``model.shard_axis``, as
    ``Model.init_params(tp=(rank, n), dp=(dp_rank, dp))`` keeps it: the n
    shards put together are the tree: a vision model's ``mm_proj`` by output
    columns, an encoder-decoder's ``enc_layers`` and each ``xattn[i].core``
    as a decoder layer (``enc_norm`` and the ``xattn`` norms whole), an
    xLSTM layer by its block's kind (an sLSTM block whole but its FF); a
    MoE's routed experts cut to the data rank's ``E / dp`` when dp divides
    E (``model.expert_range``, the reference's ``moe_specs``), so the data
    ranks' expert slices put together along the expert axis are the TP
    shard. Checks the tree against ``cfg`` first; raises when ``cfg`` does
    not shard over ``n`` ranks (``ModelConfig.tp_shard``)."""
    check_supported(cfg)
    cfg.tp_shard(n)
    _check_tree(tree, param_shapes(cfg), "")
    lo, hi = expert_range(cfg, dp_rank, dp)

    def leaf(a, key, parent, block):
        if is_expert_leaf(parent, key, a.ndim):
            a = a[lo:hi]
        return np.ascontiguousarray(shard_leaf(a, parent, key, rank, n, block))

    def walk(node, key, parent, block=None):
        if isinstance(node, dict):
            return {k: walk(v, k, key, block) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key, parent, layer_block(cfg, key, i, block))
                    for i, v in enumerate(node)]
        return leaf(np.asarray(node), key, parent, block)

    return walk(tree, "", "")



def opt_state_from_numpy(opt, cfg: ModelConfig, device: str | torch.device = "cuda"):
    """The reference's ``OptState`` (``mu``, ``nu``: numpy trees like the
    params; ``step``) as the port's: fp32 moment tensors on ``device``,
    checked against ``cfg``'s tree, and an int step."""
    from repro_torch.training.optimizer import OptState

    dev = resolve_device(device)
    moments = [_convert(t, torch.float32, dev, "") for t in (opt.mu, opt.nu)]
    for m in moments:
        _check_tree(m, param_shapes(cfg), "")
    return OptState(mu=moments[0], nu=moments[1], step=int(np.asarray(opt.step)))


def _gather(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``axis`` in rank order (one
    uncounted all-gather: a checkpoint's, not a step's)."""
    import torch.distributed as dist

    from repro_torch.core.collectives import wire

    w = wire(t.detach(), group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=axis).to(t.device)


def gather_params(tree, cfg: ModelConfig, ctx):
    """The inverse of ``shard_params``: a tree of this rank's tensors (the
    params, or moments like them) made whole on every rank of ``ctx``'s
    groups. Each TP-sharded leaf is all-gathered along its shard axis over
    the TP group, and on a data group a routed-expert leaf that holds the
    data rank's ``E / dp`` experts along the expert axis over the data
    group; replicated leaves come back as they are. Every rank calls it
    (the gathers are collective)."""
    n, dp = ctx.tp_size, ctx.dp_size
    lo, hi = expert_range(cfg, 0, dp)

    def leaf(t, key, parent, block):
        if is_expert_leaf(parent, key, t.ndim) and hi - lo < cfg.n_experts:
            t = _gather(t, ctx.dp_group, 0)
        axis = shard_axis(parent, key, block)
        if axis is not None and n > 1:
            t = _gather(t, ctx.tp_group, axis % t.ndim)
        return t

    def walk(node, key, parent, block=None):
        if isinstance(node, dict):
            return {k: walk(node[k], k, key, block) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v, key, parent, layer_block(cfg, key, i, block))
                    for i, v in enumerate(node)]
        return leaf(node, key, parent, block)

    return walk(tree, "", "")
