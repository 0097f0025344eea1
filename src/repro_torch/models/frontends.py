"""Stub modality frontends, after the reference's ``models/frontends.py``.

[vlm]   the vision encoder + projector is stubbed: ``patch_embeds`` arrive as
        precomputed (B, n_patches, d_model) embeddings, which the model's
        ``mm_proj`` maps into the decoder (early fusion).
[audio] the mel-spectrogram + conv feature extractor is stubbed:
        ``encoder_frames`` arrive as (B, encoder_seq, d_model) embeddings,
        the encoder's input.

The stubs are random stand-ins, standard normals scaled by
``d_model**-0.5``, drawn in fp32 from an explicit ``torch.Generator`` on its
device and cast to ``dtype`` (zeros without a generator). Nothing is
downloaded. Their values differ from the reference's ``jax.random`` draws;
tests hand both packages the same numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["frontend_shapes", "patch_embed_stub", "audio_frames_stub", "frontend_stubs"]


def frontend_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, int, int]]:
    """The extra model inputs of ``cfg`` (name -> shape for ``batch``
    requests): ``patch_embeds`` for a vision model, ``encoder_frames`` for
    an audio encoder-decoder, none for a text decoder."""
    if cfg.frontend == "vision":
        return {"patch_embeds": (batch, cfg.n_patches, cfg.d_model)}
    if cfg.frontend == "audio":
        return {"encoder_frames": (batch, cfg.encoder_seq, cfg.d_model)}
    return {}


def _stub(shape, cfg: ModelConfig, generator: Optional[torch.Generator],
          dtype: torch.dtype) -> torch.Tensor:
    if generator is None:
        return torch.zeros(shape, dtype=dtype)
    x = torch.randn(*shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(cfg.d_model**-0.5).to(dtype)


def patch_embed_stub(cfg: ModelConfig, batch: int, generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stand-in patch embeddings (batch, n_patches, d_model)."""
    return _stub((batch, cfg.n_patches, cfg.d_model), cfg, generator, dtype)


def audio_frames_stub(cfg: ModelConfig, batch: int, generator: Optional[torch.Generator] = None,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stand-in encoder frames (batch, encoder_seq, d_model)."""
    return _stub((batch, cfg.encoder_seq, cfg.d_model), cfg, generator, dtype)


def frontend_stubs(cfg: ModelConfig, batch: int, seed: int,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every extra input of ``cfg`` for ``batch`` requests, drawn on the
    host from a generator seeded with ``seed`` (the ``extra_inputs`` of
    ``Engine.run``); empty for a text decoder."""
    generator = torch.Generator().manual_seed(seed)
    stubs = {"patch_embeds": patch_embed_stub, "encoder_frames": audio_frames_stub}
    return {k: stubs[k](cfg, batch, generator, dtype) for k in frontend_shapes(cfg, batch)}
