"""The analytic TTFT model of the paper's Table 3 (the reference's
``Hardware``, ``HARDWARE``, ``ttft_breakdown`` and ``ttft_seconds``, with an
H100 entry fitted on the card), and the measured serving statistics:
per-request timing and per-run aggregates (``RequestTiming``,
``ServeStats``).

The paper's profiling setup all-gathers the full partial tensor from the
other N-1 workers and sums locally, so each row-parallel reduction moves
(N-1) x tensor bytes per device, and compression divides that term:

TTFT(model, hw, B, S) =
    compute:   2 * P_active * B*S / (N * peak_flops * mfu)
  + comm:      n_reductions * (N-1) * bytes(B*S*d_model) / link_bw
  + codec:     [if compressed] n_reductions * (codec_passes * N * bytes /
               hbm_bw + codec_fixed_s)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import MXSpec
from repro_torch.serving.errors import (
    OUTCOME_CANCELLED, OUTCOME_OK, OUTCOME_REJECTED, OUTCOME_TIMED_OUT, TERMINAL_OUTCOMES,
)

__all__ = ["Hardware", "HARDWARE", "ttft_seconds", "ttft_breakdown", "RequestTiming",
           "ServeStats"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip, fp16/bf16 dense
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # effective all-gather bytes/s per chip
    mfu: float                 # calibrated prefill MFU
    codec_fixed_s: float = 2e-4  # per-collective codec launch overhead
    codec_passes: float = 3.0    # HBM passes for quant+dequant+sum


HARDWARE: Dict[str, Hardware] = {
    # the reference's entries, as they are there
    "L4": Hardware("L4", peak_flops=60.5e12, hbm_bw=300e9, link_bw=7.0e9, mfu=0.45),
    "A100": Hardware("A100", peak_flops=312e12, hbm_bw=2.0e12, link_bw=180e9, mfu=0.50),
    "TPUv5e": Hardware("TPUv5e", peak_flops=197e12, hbm_bw=819e9, link_bw=45e9, mfu=0.55),
    # NVIDIA H100 SXM. peak_flops, hbm_bw: data sheet (dense bf16, HBM3).
    # link_bw: data sheet, NVLink 4 at 900 GB/s both ways = 450 GB/s each
    # way per GPU; not measured (one card). The rest fitted by
    # launch/ttft_table.py ``fit_h100`` on a chip_smoke.py run (NVIDIA H100
    # 80GB HBM3, power limit 700 W):
    "H100": Hardware(
        "H100", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
        # graphed uncompressed measure_ttft of llama2-7b at 2048 tokens on
        # one card, 122.012 ms (its attention is plain PyTorch)
        mfu=0.2287,
        # two codec launches per reduction at the launch floor, 0.00216 ms
        codec_fixed_s=4.32e-6,
        # the codec's device time at the whole-prompt shapes of 512 tokens,
        # TP 4: quantize (2048, 4096) 0.0128 ms + dequantize-and-sum
        # 4 x (512, 4096) 0.0052 ms, less the fixed cost, over 16.8 MB
        codec_passes=2.7212),
}


def _n_row_reductions(cfg: ModelConfig) -> int:
    """Row-parallel reductions per forward pass (attn.o + mlp/moe.down, plus
    mamba/xlstm out-proj)."""
    n = 0
    for spec in cfg.layers:
        n += 1  # core block out-proj (attn.o / mamba.out / xlstm.down)
        if spec.kind in ("attn", "mamba") and (cfg.d_ff > 0 or spec.moe):
            n += 1  # mlp or moe down
    if cfg.encoder_decoder:
        n += 2 * cfg.n_encoder_layers + cfg.n_layers  # enc layers + cross-attn
    return n


def ttft_breakdown(cfg: ModelConfig, hw: Hardware, tp: int, batch: int, seq: int,
                   spec: Optional[MXSpec] = None, *, bytes_per_el: float = 2.0,
                   scheme: str = "gather") -> Dict[str, float]:
    """Seconds of compute, comm and codec (and their total) of one prefill.
    scheme: per-device bytes moved per reduction —
      "gather"    (N-1) x tensor        (the paper's stack)
      "ring"      2 (N-1)/N x tensor    (ring all-reduce / rs+ag)
      "two_phase" 2 (N-1)/N x tensor    on the COMPRESSED payload
    An encoder-decoder's encoder reductions and compute are sized at the
    decoder's ``batch * seq`` tokens, not its ``encoder_seq`` frames, as
    the reference's are (ROADMAP.md Queue 3 item 15).
    """
    tokens = batch * seq
    compute = 2.0 * cfg.active_param_count() * tokens / (tp * hw.peak_flops * hw.mfu)

    n_red = _n_row_reductions(cfg)
    tensor_bytes = tokens * cfg.d_model * bytes_per_el
    if spec is not None:
        wire = tensor_bytes * spec.wire_bits_per_value(cfg.d_model) / (8 * bytes_per_el)
    else:
        wire = tensor_bytes
    if scheme == "gather":
        per_red = (tp - 1) * wire
    else:  # ring / two_phase
        per_red = 2.0 * (tp - 1) / tp * wire
    comm = n_red * per_red / hw.link_bw

    codec = 0.0
    if spec is not None:
        # gather: each device dequantizes all N gathered partials;
        # two_phase: about constant passes whatever N
        hbm_bytes = hw.codec_passes * tensor_bytes * (tp if scheme == "gather" else 1)
        codec = n_red * (hbm_bytes / hw.hbm_bw + hw.codec_fixed_s)
    return {"compute": compute, "comm": comm, "codec": codec,
            "total": compute + comm + codec}


def ttft_seconds(cfg: ModelConfig, hw: Hardware, tp: int, batch: int, seq: int,
                 spec: Optional[MXSpec] = None, scheme: str = "gather") -> float:
    return ttft_breakdown(cfg, hw, tp, batch, seq, spec, scheme=scheme)["total"]


# ----------------------------------------------------- measured serving stats


@dataclasses.dataclass
class RequestTiming:
    """Wall-clock milestones (seconds from the run's start) and token counts
    of one request, filled at its terminal outcome. A request that never
    produced a token (rejected, timed out or cancelled first) has no
    ``first_token_s``: its ``ttft_s`` is NaN."""

    arrival_s: float
    admitted_s: Optional[float]
    first_token_s: Optional[float]
    finished_s: float
    n_prompt: int                    # tokens in the ORIGINAL prompt
    n_generated: int
    n_preemptions: int = 0           # evict-and-recompute round trips
    n_cached_prompt: int = 0         # prompt tokens served from shared prefix
                                     # blocks (summed over readmissions)
    inter_token_s: Optional[List[float]] = None  # gaps between sampled tokens
    outcome: str = OUTCOME_OK

    def __post_init__(self) -> None:
        if self.outcome not in TERMINAL_OUTCOMES:
            raise ValueError(f"unknown outcome {self.outcome!r}: expected one of "
                             f"{', '.join(TERMINAL_OUTCOMES)}")

    @property
    def ttft_s(self) -> float:
        if self.first_token_s is None:
            return float("nan")
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        if self.admitted_s is None:
            return float("nan")
        return self.admitted_s - self.arrival_s


def _percentile(xs: List[float], p: float) -> float:
    xs = sorted(xs)
    if not xs:
        return float("nan")
    i = min(len(xs) - 1, max(0, round(p / 100 * (len(xs) - 1))))
    return xs[i]


class ServeStats:
    """Aggregates ``RequestTiming`` records and per-step dispatch accounting
    across one serving run; ``summary()`` gives the reported distributions
    (same keys as the reference). ``n_{ok,rejected,timed_out,cancelled}``
    count terminal outcomes; ``goodput_tokens_per_s`` counts the tokens of
    ``ok`` requests only; TTFT percentiles cover the requests that produced
    a first token."""

    def __init__(self):
        self.timings: List[RequestTiming] = []
        self.n_steps = 0
        self.n_dispatches = 0
        self.step_tokens: List[tuple] = []  # (n_prefill, n_decode) per step
        self.n_compressed_steps = 0
        # prompt tokens processed outside budgeted steps (whole-prompt
        # prefill at admission)
        self.off_step_prefill_tokens = 0

    def record(self, t: RequestTiming) -> None:
        self.timings.append(t)

    def merge(self, other: "ServeStats") -> None:
        """Fold another run's records into this one (the supervisor sums its
        attempts this way). Timings are appended as they are; the supervisor
        drops a replayed request's superseded records itself."""
        self.timings.extend(other.timings)
        self.n_steps += other.n_steps
        self.n_dispatches += other.n_dispatches
        self.step_tokens.extend(other.step_tokens)
        self.n_compressed_steps += other.n_compressed_steps
        self.off_step_prefill_tokens += other.off_step_prefill_tokens

    def record_step(self, n_prefill: int, n_decode: int, n_dispatches: int = 1,
                    compressed: bool = False) -> None:
        self.n_steps += 1
        self.n_dispatches += n_dispatches
        self.step_tokens.append((n_prefill, n_decode))
        if compressed:
            self.n_compressed_steps += 1

    def record_dispatch(self, n: int = 1, prefill_tokens: int = 0) -> None:
        """Off-step dispatches (whole-prompt prefill + insert at admission, a
        prefix-cache COW fork) and the prompt tokens they processed."""
        self.n_dispatches += n
        self.off_step_prefill_tokens += prefill_tokens

    def summary(self) -> Dict[str, float]:
        ts = self.timings
        if not ts:
            return {"n_requests": 0}
        ttfts = [t.ttft_s for t in ts if t.first_token_s is not None]
        lats = [t.latency_s for t in ts]
        gaps = [g for t in ts for g in (t.inter_token_s or [])]
        generated = sum(t.n_generated for t in ts)
        makespan = max(t.finished_s for t in ts) - min(t.arrival_s for t in ts)
        prompt_tokens = sum(t.n_prompt for t in ts)
        cached = sum(t.n_cached_prompt for t in ts)
        step_total = sum(p + d for p, d in self.step_tokens)
        outcomes = {o: sum(1 for t in ts if t.outcome == o) for o in TERMINAL_OUTCOMES}
        good = sum(t.n_generated for t in ts if t.outcome == OUTCOME_OK)
        return {
            "n_requests": len(ts),
            "ttft_p50_s": _percentile(ttfts, 50) if ttfts else 0.0,
            "ttft_p90_s": _percentile(ttfts, 90) if ttfts else 0.0,
            "ttft_mean_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "latency_p50_s": _percentile(lats, 50),
            "latency_p90_s": _percentile(lats, 90),
            "tpot_p50_s": _percentile(gaps, 50) if gaps else 0.0,
            "tpot_p95_s": _percentile(gaps, 95) if gaps else 0.0,
            "n_inter_token_samples": len(gaps),
            "n_steps": self.n_steps,
            "n_dispatches": self.n_dispatches,
            "n_compressed_steps": self.n_compressed_steps,
            "tokens_per_step_mean": step_total / self.n_steps if self.n_steps else 0.0,
            "prefill_tokens": (sum(p for p, _ in self.step_tokens)
                               + self.off_step_prefill_tokens),
            "decode_tokens": sum(d for _, d in self.step_tokens),
            "n_generated": generated,
            "makespan_s": makespan,
            "tokens_per_s": generated / makespan if makespan > 0 else float("nan"),
            "n_preemptions": sum(t.n_preemptions for t in ts),
            "prefill_tokens_skipped": cached,
            "prefix_hit_rate": cached / prompt_tokens if prompt_tokens else 0.0,
            "n_ok": outcomes[OUTCOME_OK],
            "n_rejected": outcomes[OUTCOME_REJECTED],
            "n_timed_out": outcomes[OUTCOME_TIMED_OUT],
            "n_cancelled": outcomes[OUTCOME_CANCELLED],
            "goodput_tokens_per_s": good / makespan if makespan > 0 else float("nan"),
        }
