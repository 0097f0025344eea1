"""Measured serving statistics: per-request timing and per-run aggregates
(the reference's ``RequestTiming`` and ``ServeStats``). The analytic
``ttft_breakdown`` waits for H100 constants measured on the card."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serving.errors import (
    OUTCOME_CANCELLED, OUTCOME_OK, OUTCOME_REJECTED, OUTCOME_TIMED_OUT, TERMINAL_OUTCOMES,
)

__all__ = ["RequestTiming", "ServeStats"]


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
