"""The port's Model: parameter init and the unified mixed token-budget step
for dense pure-attention decoders (the reference's ``Model.init_params`` and
``Model.mixed_step``). Other families raise ``NotImplementedError``.

Parameters are a plain nested dict with the reference's tree and names
(``embed``, ``layers[i].{ln1, core.{wq, wk, wv, wo}, ln2, mlp.{up, down,
gate}}``, ``final_norm``, ``lm_head``) and its layouts (linear weights
``(Fin, Fout)`` applied as ``x @ w``; ``embed``/``lm_head`` ``(V, d)``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tp import TPContext
from repro_torch.device import resolve_device
from repro_torch.models.attention import paged_attention_mixed
from repro_torch.models.common import Initializer, embed, rms_norm, unembed
from repro_torch.models.mlp import mlp

__all__ = ["Model", "torch_dtype"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise on anything but a dense pure-attention text decoder."""
    bad = [s for s in cfg.layers if s.kind != "attn" or s.moe]
    if (bad or cfg.encoder_decoder or cfg.frontend is not None or cfg.norm != "rmsnorm"
            or cfg.activation != "silu" or cfg.d_ff <= 0):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense pure-attention SwiGLU decoders "
            f"only (MoE, SSM/xLSTM, encoder-decoder and vision frontends are not "
            f"ported yet)")


class Model:
    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device: str | torch.device = "cuda", *, seed: int = 0) -> Dict[str, Any]:
        """Random weights from ``generator`` (default: a fresh generator on
        ``device`` seeded with ``seed``), drawn on ``device`` in the config's
        dtype. Runs on the card unless ``device="cpu"``."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        cfg = self.cfg
        init = Initializer(generator, torch_dtype(cfg.dtype), dev)
        d, ff = cfg.d_model, cfg.d_ff

        def linear(fin, fout, bias=False):
            p = {"w": init.linear((fin, fout))}
            if bias:
                p["b"] = init.zeros((fout,))
            return p

        p: Dict[str, Any] = {
            "embed": {"w": init.linear((cfg.vocab_size, d), scale=d**-0.5)}}
        layers = []
        for _ in cfg.layers:
            core = {"wq": linear(d, cfg.q_dim, cfg.qkv_bias),
                    "wk": linear(d, cfg.kv_dim, cfg.qkv_bias),
                    "wv": linear(d, cfg.kv_dim, cfg.qkv_bias),
                    "wo": linear(cfg.q_dim, d)}
            if cfg.qk_norm:
                core["q_norm"] = {"w": init.ones((cfg.head_dim,))}
                core["k_norm"] = {"w": init.ones((cfg.head_dim,))}
            layers.append({
                "ln1": {"w": init.ones((d,))},
                "core": core,
                "ln2": {"w": init.ones((d,))},
                "mlp": {"up": linear(d, ff), "down": linear(ff, d),
                        "gate": linear(d, ff)},
            })
        p["layers"] = layers
        p["final_norm"] = {"w": init.ones((d,))}
        if not cfg.tie_embeddings:
            p["lm_head"] = {"w": init.linear((cfg.vocab_size, d))}
        return p

    def mixed_step(self, ctx: TPContext, params, tokens, state, slot_ids, positions,
                   valid, is_decode, slot_starts, tables, sample_idx,
                   cache_spec=None) -> Tuple[torch.Tensor, Any]:
        """One unified mixed-batch token-budget step (see the reference's
        ``Model.mixed_step``): tokens (1, T) int32 right-padded; slot_ids /
        positions / valid / is_decode (T,); slot_starts (n_slots,);
        tables (n_slots, max_blocks); sample_idx (n_slots,) — the flat index
        each slot samples from. Appends every real token's K/V to the pools
        of ``state`` (in place) and returns (logits (n_slots, V), state)."""
        cfg = self.cfg
        x = embed(ctx, params["embed"]["w"], tokens)
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
        pools_k, pools_v = list(state["pools_k"]), list(state["pools_v"])
        for i, spec in enumerate(cfg.layers):
            lp = params["layers"][i]
            h = rms_norm(x, lp["ln1"]["w"])
            out, pools_k[i], pools_v[i] = paged_attention_mixed(
                ctx, lp["core"], h, cfg, positions=positions, slot_ids=slot_ids,
                slot_starts=slot_starts, valid=valid, is_decode=is_decode,
                tables=tables, pool_k=pools_k[i], pool_v=pools_v[i],
                window=spec.window, cache_spec=cache_spec)
            x = x + out
            h = rms_norm(x, lp["ln2"]["w"])
            x = x + mlp(ctx, lp["mlp"], h, cfg)
        # logits only at each slot's sampled token (norm + unembed stay
        # O(n_slots), not O(token_budget))
        x = x[0][sample_idx.long()][:, None]
        x = rms_norm(x, params["final_norm"]["w"])
        head = params.get("lm_head", params["embed"])["w"]
        logits = unembed(ctx, x, head)[:, 0]
        return logits, {**state, "pools_k": pools_k, "pools_v": pools_v}
