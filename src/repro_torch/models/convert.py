"""Weight bridge: the reference's parameter tree, already converted to numpy,
into the port's parameter dict — so both frameworks compute with identical
weights (tests build the numpy tree with ``jax.tree.map(np.asarray, params)``
on the reference's ``Model.init_params``)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import check_supported, torch_dtype

__all__ = ["params_from_numpy"]


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


def params_from_numpy(tree, cfg: ModelConfig, device: str | torch.device = "cuda"):
    """Numpy parameter tree (reference names and layouts) -> torch tensors on
    ``device`` in the config's dtype. Checks the tree's layer count and the
    linear weights' shapes against ``cfg``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config {cfg.n_layers}")
    params = _convert(tree, torch_dtype(cfg.dtype), dev, "")
    expect = {"wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
              "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model)}
    for i, lp in enumerate(params["layers"]):
        for name, shape in expect.items():
            got = tuple(lp["core"][name]["w"].shape)
            if got != shape:
                raise ValueError(f"layers[{i}].core.{name}: shape {got}, expected {shape}")
    return params
