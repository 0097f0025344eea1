"""Supervised recovery for the engine (the reference's
``serving/supervisor.py``).

``EngineSupervisor`` wraps ``Engine.run`` in a retry loop: when a run aborts
with one of the ``RECOVERABLE`` faults it restores the engine and replays
every request that has not reached a terminal outcome, with exponential
backoff between attempts.

* ``EngineDead`` / ``WireCorruption``: pools lost or poisoned, so HARD
  recovery (``engine.recover(hard=True)`` rebuilds pools, allocator and
  prefix index).
* ``StepStuck``: host state and pools intact, so WARM recovery on a
  ``persistent_cache`` engine (in-flight blocks released, pools and index
  kept, so the replay re-hits its cached prefixes); hard otherwise.

A replayed request restarts from its ``Request`` (prompt and options; any
partial output is recomputed) at ``arrival_s = 0`` on the new run's clock.
Under greedy decoding the engine's tokens do not depend on scheduling, so a
replay gives the fault-free run's tokens. Finished requests are never rerun.
At most ``max_restarts`` recoveries per ``run``; the fault after that
propagates. Backoff sleeps ``backoff_s * backoff_mult**(attempt-1)``
(``sleep`` is injectable for tests).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.errors import EngineDead, StepStuck, WireCorruption
from repro_torch.serving.ttft import ServeStats

__all__ = ["EngineSupervisor", "RecoveryEvent", "RECOVERABLE"]

RECOVERABLE = (EngineDead, StepStuck, WireCorruption)


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """One supervised recovery: what failed, how it was recovered, and the
    time from detection to a ready engine (the backoff sleep apart)."""

    attempt: int          # 1-based recovery count within this run
    error: str            # exception class name (EngineDead / ...)
    detail: str           # str(exception)
    mode: str             # "hard" | "warm"
    n_replayed: int       # unfinished requests carried into the next attempt
    backoff_s: float      # backoff slept before the next attempt
    recovery_s: float     # detection -> engine ready (excludes backoff)


class EngineSupervisor:
    """Retry-and-replay wrapper over one ``Engine`` (module docstring).

    ``run(requests)`` returns the request list with every request at a
    terminal outcome, or raises the last fault after ``max_restarts``
    recoveries. Each attempt's stats are merged into ``self.stats``, whose
    ``timings`` keep one record per request (a replayed request's earlier
    partial records are dropped). ``self.events`` lists the recoveries;
    ``report()`` sums them up.
    """

    def __init__(self, engine: Engine, *, max_restarts: int = 3, backoff_s: float = 0.05,
                 backoff_mult: float = 2.0, sleep: Callable[[float], None] = time.sleep):
        self.engine = engine
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self._sleep = sleep
        self.events: List[RecoveryEvent] = []
        self.stats = ServeStats()

    def run(self, requests: List[Request], *, seed: int = 0,
            extra_inputs: Optional[Dict[str, object]] = None) -> List[Request]:
        """``extra_inputs`` (one row per request of ``requests``) follow
        their requests into every replay."""
        self.events = []
        self.stats = ServeStats()
        pending = list(requests)
        rows = {id(r): i for i, r in enumerate(requests)}
        attempt = 0
        while True:
            extra = None
            if extra_inputs is not None:
                idx = [rows[id(r)] for r in pending]
                extra = {k: v[idx] for k, v in extra_inputs.items()}
            try:
                self.engine.run(pending, seed=seed, extra_inputs=extra)
            except RECOVERABLE as e:
                t_detect = time.perf_counter()
                attempt += 1
                self.stats.merge(self.engine.stats)
                if attempt > self.max_restarts:
                    raise
                warm = isinstance(e, StepStuck) and self.engine.persistent_cache
                self.engine.recover(hard=not warm)
                pending = [r for r in pending if r.timing is None]
                for r in pending:
                    r.arrival_s = 0.0  # replay at once on the new run's clock
                recovery_s = time.perf_counter() - t_detect
                backoff = self.backoff_s * self.backoff_mult ** (attempt - 1)
                self.events.append(RecoveryEvent(
                    attempt=attempt, error=type(e).__name__, detail=str(e),
                    mode="warm" if warm else "hard", n_replayed=len(pending),
                    backoff_s=backoff, recovery_s=recovery_s))
                if backoff > 0:
                    self._sleep(backoff)
                continue
            self.stats.merge(self.engine.stats)
            break
        finals = {id(r.timing) for r in requests if r.timing is not None}
        self.stats.timings = [t for t in self.stats.timings if id(t) in finals]
        return requests

    def report(self) -> Dict[str, object]:
        """Recovery summary: counts by mode, total backoff and recovery time,
        the errors in order, and the merged serving summary."""
        return {
            "n_recoveries": len(self.events),
            "n_hard": sum(1 for e in self.events if e.mode == "hard"),
            "n_warm": sum(1 for e in self.events if e.mode == "warm"),
            "recovery_s_total": sum(e.recovery_s for e in self.events),
            "backoff_s_total": sum(e.backoff_s for e in self.events),
            "errors": [e.error for e in self.events],
            "serve": self.stats.summary(),
        }
