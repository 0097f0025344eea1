"""Typed serving errors and terminal request outcomes (the reference's
``serving/errors.py``).

Three failure surfaces:

* **Per-request impossibility** — a request this engine can never serve
  (``InvalidRequest``) or a pool that cannot cover it even with every other
  request evicted (``PoolExhausted``). These raise where they are found.
* **Per-request degradation** — deadlines, bounded admission and
  cancellation never raise: the request leaves with an explicit terminal
  ``outcome`` (``rejected`` / ``timed_out`` / ``cancelled``) in its
  ``RequestTiming``, counted by ``ServeStats``.
* **Engine-level faults** — poisoned pools (``WireCorruption``, caught by the
  non-finite logits watch), a wedged step loop (``StepStuck``, raised by the
  step watchdog and the stall guard) or a crash (``EngineDead``). These
  abort ``Engine.run`` and are what ``EngineSupervisor`` recovers from.
"""
from __future__ import annotations

__all__ = [
    "ServingError", "PoolExhausted", "SlotExhausted", "InvalidRequest",
    "EngineDead", "StepStuck", "WireCorruption",
    "OUTCOME_OK", "OUTCOME_REJECTED", "OUTCOME_TIMED_OUT",
    "OUTCOME_CANCELLED", "TERMINAL_OUTCOMES",
]


class ServingError(RuntimeError):
    """Base of every typed serving-stack error."""


class PoolExhausted(ServingError):
    """The KV block pool cannot cover a request even with nothing left to
    evict: the pool is too small for it, not merely busy. Transient pressure
    (other requests' blocks, fault-held blocks) defers instead."""


class SlotExhausted(ServingError):
    """No decode slot can ever become available (e.g. ``max_slots=0``)."""


class InvalidRequest(ServingError, ValueError):
    """A request rejected at validation: empty prompt, non-positive
    ``max_new_tokens``, non-positive deadline, or a prompt+decode footprint
    beyond ``max_len``."""


class EngineDead(ServingError):
    """The engine's state is gone mid-run (a ``die`` fault, or a real crash
    surfaced by a wrapper). Device pools count as lost: hard recovery."""


class StepStuck(ServingError):
    """The step watchdog tripped: one step took longer than
    ``step_timeout_s``, or no token progress for ``stall_limit`` consecutive
    steps. Host request state and device pools are intact: recovery can be
    warm."""


class WireCorruption(ServingError):
    """Non-finite logits reached a row that samples a token: the signature
    of a corrupted KV pool block. Pools are poisoned: hard recovery."""


# Terminal outcomes in ``RequestTiming.outcome``: WAITING -> {REJECTED,
# TIMED_OUT, CANCELLED} and WAITING -> RUNNING -> {OK, TIMED_OUT, CANCELLED}.
OUTCOME_OK = "ok"                   # retired normally (max_new_tokens / eos)
OUTCOME_REJECTED = "rejected"       # never admitted: bounded-queue overflow
OUTCOME_TIMED_OUT = "timed_out"     # TTFT or total-latency deadline expired
OUTCOME_CANCELLED = "cancelled"     # Request.cancel()

TERMINAL_OUTCOMES = (OUTCOME_OK, OUTCOME_REJECTED, OUTCOME_TIMED_OUT,
                     OUTCOME_CANCELLED)
