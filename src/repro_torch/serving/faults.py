"""Deterministic fault injection for the serving engine (the reference's
``serving/faults.py``; numpy and the standard library only).

A ``FaultPlan`` is a seeded, step-indexed schedule of fault events that the
engine consults at the top of every step. The plan decides what fails and
when; the engine applies it (``Engine._apply_faults``).

Fault kinds (``Fault.kind``):

* ``"exhaust"`` — hold ``n_blocks`` blocks (every free block when 0) out of
  the allocator's free list for ``duration`` steps: a dry pool without a
  byte of real pressure. The held blocks return on schedule.
* ``"corrupt"`` — poison one live pool block (``block`` id, or the lowest
  live block when -1) in every attention layer's K and V pool: scale bytes
  255 in MX pools, NaN in dense pools. The engine's non-finite logits watch
  raises ``WireCorruption`` when a sampled row reads it.
* ``"slow"`` — sleep ``sleep_s`` in the step's dispatch.
* ``"stuck"`` — sleep long enough to trip the step watchdog
  (``max(sleep_s, 2 * step_timeout_s)``): ``StepStuck``.
* ``"die"`` — raise ``EngineDead`` before the step dispatches.

Events are one-shot: each fires at the first step counter >= ``step`` and
never again, so a supervisor replay (which restarts the step counter) does
not re-trigger the fault that ended the previous attempt.

CLI grammar (``FaultPlan.parse``): semicolon-separated events
``kind@step[:arg][xduration]``, e.g. ``exhaust@6x4`` (hold every free
block from step 6 for 4 steps), ``exhaust@6:8x4`` (8 blocks),
``corrupt@9``, ``corrupt@9:3`` (block 3), ``slow@3:0.25``, ``stuck@7``,
``die@12``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Fault", "FaultPlan", "FAULT_KINDS"]

FAULT_KINDS = ("exhaust", "corrupt", "slow", "stuck", "die")

_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<step>\d+)"
    r"(?::(?P<arg>[0-9.]+))?(?:x(?P<duration>\d+))?$")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault event (kinds in the module docstring)."""

    kind: str
    step: int                 # engine step counter at which to fire
    duration: int = 1         # exhaust: steps the held blocks stay held
    n_blocks: int = 0         # exhaust: blocks to hold (0 = all free)
    sleep_s: float = 0.0      # slow/stuck: injected dispatch latency
    block: int = -1           # corrupt: block id (-1 = lowest live block)

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: expected one of "
                             f"{', '.join(FAULT_KINDS)}")
        if self.step < 0 or self.duration < 1:
            raise ValueError(f"fault {self.kind!r}: step must be >= 0 and duration >= 1")

    def describe(self) -> str:
        extra = {
            "exhaust": f":{self.n_blocks or 'all'}x{self.duration}",
            "corrupt": f":{'live' if self.block < 0 else self.block}",
            "slow": f":{self.sleep_s}s",
            "stuck": f":{self.sleep_s}s" if self.sleep_s else "",
            "die": "",
        }[self.kind]
        return f"{self.kind}@{self.step}{extra}"


class FaultPlan:
    """A seeded, one-shot schedule of ``Fault`` events.

    ``take(step)`` returns the events not yet fired that are due at or
    before ``step`` and marks them fired. ``reset()`` re-arms every event
    and reseeds ``rng`` for a from-scratch rerun; a supervisor recovery does
    not reset, so the fault that ended an attempt cannot end the replay.
    """

    def __init__(self, faults: Sequence[Fault] = (), *, seed: int = 0):
        self.faults: List[Fault] = sorted(faults, key=lambda f: (f.step, f.kind))
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._fired = [False] * len(self.faults)

    @classmethod
    def parse(cls, text: Optional[str], *, seed: int = 0) -> "FaultPlan":
        """Parse the CLI grammar (module docstring); None or "" gives an
        empty plan."""
        events: List[Fault] = []
        for raw in (text or "").split(";"):
            raw = raw.strip()
            if not raw:
                continue
            m = _EVENT_RE.match(raw)
            if m is None:
                raise ValueError(
                    f"bad fault event {raw!r}: expected 'kind@step[:arg][xduration]' with "
                    f"kind one of {', '.join(FAULT_KINDS)} (e.g. 'exhaust@6x4', "
                    f"'slow@3:0.25', 'die@12')")
            kind, step = m.group("kind"), int(m.group("step"))
            arg, dur = m.group("arg"), int(m.group("duration") or 1)
            if kind == "exhaust":
                f = Fault(kind=kind, step=step, duration=dur,
                          n_blocks=int(float(arg)) if arg else 0)
            elif kind == "corrupt":
                f = Fault(kind=kind, step=step, block=int(float(arg)) if arg else -1)
            elif kind in ("slow", "stuck"):
                f = Fault(kind=kind, step=step, sleep_s=float(arg) if arg else 0.0)
            else:
                if arg or dur != 1:
                    raise ValueError(f"fault event {raw!r}: '{kind}' takes no argument "
                                     f"or duration")
                f = Fault(kind=kind, step=step)
            events.append(f)
        return cls(events, seed=seed)

    def __len__(self) -> int:
        return len(self.faults)

    @property
    def n_pending(self) -> int:
        return self._fired.count(False)

    def take(self, step: int) -> List[Fault]:
        """Pop every event not yet fired that is due at or before ``step``."""
        out: List[Fault] = []
        for i, f in enumerate(self.faults):
            if not self._fired[i] and f.step <= step:
                self._fired[i] = True
                out.append(f)
        return out

    def reset(self) -> None:
        """Re-arm every event and reseed ``rng``."""
        self._fired = [False] * len(self.faults)
        self.rng = np.random.default_rng(self.seed)

    def garbage_bytes(self, shape: tuple) -> np.ndarray:
        """Seeded random bytes (the engine's corruption does not use them: it
        writes scale bytes 255 or NaN, as the reference's does)."""
        return self.rng.integers(0, 256, size=shape, dtype=np.uint8)

    def describe(self) -> str:
        if not self.faults:
            return "no faults"
        return "; ".join(f.describe() for f in self.faults) + f" (seed {self.seed})"
