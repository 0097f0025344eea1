"""Typed serving errors and terminal request outcomes (the classes the
port's engine raises; the fault-recovery errors and the outcomes other than
``ok`` come with deadlines and the supervisor in a later slice)."""
from __future__ import annotations

__all__ = [
    "ServingError", "PoolExhausted", "SlotExhausted", "InvalidRequest",
    "OUTCOME_OK", "TERMINAL_OUTCOMES",
]


class ServingError(RuntimeError):
    """Base of every typed serving-stack error."""


class PoolExhausted(ServingError):
    """The KV block pool cannot cover a request's next allocation and there
    is nothing to preempt (a single request in flight)."""


class SlotExhausted(ServingError):
    """No decode slot can ever become available (e.g. ``max_slots=0``)."""


class InvalidRequest(ServingError, ValueError):
    """A request rejected at validation: empty prompt, non-positive
    ``max_new_tokens``, or a prompt+decode footprint beyond ``max_len``."""


OUTCOME_OK = "ok"

TERMINAL_OUTCOMES = (OUTCOME_OK,)
