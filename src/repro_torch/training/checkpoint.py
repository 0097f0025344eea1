"""Checkpoints in the reference's format (``training/checkpoint.py``), so
either package reads the other's files: the state flattened to path-keyed
arrays in an ``.npz`` with a ``.json`` sidecar of each key's shape and
dtype and the step. Keys join the tree path with ``::`` as JAX's tree paths
print them (dict keys sorted, list indices, the ``OptState`` field names):
``params::layers::0::core::wq::w``, ``opt::mu::...``, ``opt::nu::...``,
``opt::step``. bf16 arrays are stored as their uint16 bits, with dtype
``"bfloat16"`` in the sidecar.

On a group of ranks (``ctx`` with a TP or data group) every rank calls
both functions: ``save_checkpoint`` gathers the whole tensors
(``convert.gather_params``) and the grid's first rank writes them;
``restore_checkpoint`` reads the whole file on every rank and keeps the
rank's shard (``convert.shard_params``).
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tp import TPContext
from repro_torch.training.optimizer import OptState

__all__ = ["save_checkpoint", "restore_checkpoint"]

_SEP = "::"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{key: leaf}`` in JAX's flatten order (dict keys sorted, an
    ``OptState`` by field)."""
    out: Dict[str, Any] = {}
    join = lambda k: f"{prefix}{_SEP}{k}" if prefix else str(k)
    if isinstance(tree, OptState):
        for name, v in zip(tree._fields, tree):
            out.update(_flatten(v, join(name)))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], join(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, join(i)))
    else:
        out[prefix] = tree
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):   # the optimizer's step: the reference's int32 scalar
        return np.asarray(leaf, np.int32)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _whole(state, cfg, ctx: Optional[TPContext]):
    """``state`` with its params and moments gathered over ``ctx``'s groups."""
    if ctx is None or (ctx.tp_group is None and ctx.dp_group is None):
        return state
    from repro_torch.models.convert import gather_params

    g = lambda tree: gather_params(tree, cfg, ctx)
    opt = state["opt"]
    return {"params": g(state["params"]),
            "opt": OptState(mu=g(opt.mu), nu=g(opt.nu), step=opt.step)}


def _first_rank(ctx: Optional[TPContext]) -> bool:
    return ctx is None or not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(path: str, state, *, step: int = 0, cfg=None,
                    ctx: Optional[TPContext] = None) -> None:
    """Write ``state`` (``{"params", "opt"}``) to ``path`` (``.npz`` +
    ``.json``). On a group (``ctx``, with the model's ``cfg``) every rank
    calls it and the first rank writes the gathered whole tensors."""
    flat = _flatten(_whole(state, cfg, ctx))
    if not _first_rank(ctx):
        return
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k] = _to_numpy(v)
        dtypes[k] = ("bfloat16" if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                     else str(arrays[k].dtype))
    np.savez(p.with_suffix(".npz"), **arrays)
    meta = {"step": step,
            "keys": {k: {"shape": list(arrays[k].shape), "dtype": dtypes[k]} for k in arrays}}
    p.with_suffix(".json").write_text(json.dumps(meta, indent=1))


def _load(data, meta, key: str) -> np.ndarray:
    arr = data[key]
    if meta["keys"][key]["dtype"] == "bfloat16":   # uint16 bits -> fp32 (exact)
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def restore_checkpoint(path: str, like, *, cfg=None, ctx: Optional[TPContext] = None):
    """Restore into the structure, dtypes and devices of ``like`` (a state
    ``{"params", "opt"}`` or any tree of tensors); on a group (``ctx``, with
    ``cfg``) each rank keeps its shard of the params and moments."""
    p = pathlib.Path(path)
    data = np.load(p.with_suffix(".npz"))
    meta = json.loads(p.with_suffix(".json").read_text())
    grouped = ctx is not None and (ctx.tp_group is not None or ctx.dp_group is not None)

    def tree(prefix: str, node):
        """The numpy tree under ``prefix`` shaped like ``node``."""
        if isinstance(node, dict):
            return {k: tree(f"{prefix}{_SEP}{k}" if prefix else k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [tree(f"{prefix}{_SEP}{i}", v) for i, v in enumerate(node)]
        return _load(data, meta, prefix)

    def place(arrs, node):
        if isinstance(node, dict):
            return {k: place(arrs[k], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [place(a, v) for a, v in zip(arrs, node)]
        return torch.from_numpy(np.ascontiguousarray(arrs)).to(device=node.device,
                                                                dtype=node.dtype)

    def restore(prefix: str, node):
        arrs = tree(prefix, node)
        if grouped:
            from repro_torch.models.convert import shard_params

            arrs = shard_params(arrs, cfg, ctx.tp_rank, ctx.tp_size, dp_rank=ctx.dp_rank,
                                dp=ctx.dp_size)
        return place(arrs, node)

    if isinstance(like, dict) and isinstance(like.get("opt"), OptState):
        opt = like["opt"]
        return {"params": restore("params", like["params"]),
                "opt": OptState(mu=restore(f"opt{_SEP}mu", opt.mu),
                                nu=restore(f"opt{_SEP}nu", opt.nu),
                                step=int(data[f"opt{_SEP}step"]))}
    return restore("", like)
