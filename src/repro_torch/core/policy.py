"""Compression policy: *where* and *when* the MX codec is applied — the
port's copy of ``repro.core.policy``.

The paper compresses the collective after every row-parallel TP linear during
prefill. Decode payloads (one token) are small and codec overhead dominates,
so the policy carries a ``min_tokens`` gate, a per-step prefill-fraction gate
and per-collective switches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.formats import MXSpec

__all__ = ["CompressionPolicy", "NO_COMPRESSION", "PAPER_DEFAULT"]


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    spec: Optional[MXSpec] = None          # None => uncompressed collectives
    variant: str = "gather"                # "gather" = paper Fig 1b;
                                           # "two_phase" = compressed
                                           # reduce-scatter + all-gather
    compress_tp_reduce: bool = True        # row-parallel reductions (the paper)
    compress_all_to_all: bool = False      # MoE dispatch/combine
    min_tokens: int = 8                    # compress only if tokens >= gate
    keep_local_fp: bool = False            # keep own shard in full precision
    use_pallas: bool = False               # reference's codec-kernel switch;
                                           # the port's codec always runs its
                                           # kernels on the card
    accum_dtype: str = "float32"           # reduction accumulator
    strict_variant: bool = False           # raise (vs warn once) on downgrade
    min_prefill_fraction: float = 0.5      # per-step gate on the mixed batch's
                                           # REAL prefill share
    overlap_chunks: int = 1                # feature-dim chunks of the payload

    @property
    def enabled(self) -> bool:
        return self.spec is not None

    def active_for(self, n_tokens: int) -> bool:
        return self.enabled and self.compress_tp_reduce and n_tokens >= self.min_tokens

    def active_for_step(self, n_prefill: int, n_decode: int) -> bool:
        """Per-step gate on the mixed batch's REAL (valid) token counts: a
        step compresses when its real token count clears ``min_tokens`` and
        prefill tokens make up at least ``min_prefill_fraction`` of them."""
        n_real = n_prefill + n_decode
        if not self.active_for(n_real):
            return False
        return n_prefill >= self.min_prefill_fraction * n_real

    def describe(self) -> str:
        if not self.enabled:
            return "uncompressed (bf16 psum)"
        return (f"{self.spec.name} ({self.spec.effective_bits:.2f} eff bits, "
                f"{self.spec.compression_ratio():.2f}x vs bf16)")


NO_COMPRESSION = CompressionPolicy(spec=None)
# Table 3 profiling configuration: FP4 E2M1, block 32, E8M0 scale.
PAPER_DEFAULT = CompressionPolicy(spec=MXSpec.make("fp4_e2m1", 32, "e8m0"))
