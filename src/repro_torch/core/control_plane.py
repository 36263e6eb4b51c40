"""The control plane's shared §4.4 straggler policy.

The port's copy of ``StragglerTracker`` from ``repro/core/control_plane.py``:
the same streak rule, so a deadline round driven by either package
escalates the same silo in the same round.  The rest of the control plane
(the module Protocols, ``ControlPlane`` and the ``Experiment`` builder)
comes with the port's builder, ``ROADMAP.md`` queue 1, item 9.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["StragglerTracker"]


class StragglerTracker:
    """Consecutive deadline-miss streaks with an escalation threshold.

    The same policy object serves the simulator's round settlement and
    the live engine's fold loop: a miss advances the silo's streak; at
    ``escalate_after`` the tracker reports the streak (the caller
    escalates to the Dynamic Scheduler) and resets it; an on-time
    delivery — or a revocation that already replaced the VM, destroying
    the slow-VM evidence — clears it."""

    def __init__(self, escalate_after: int = 2) -> None:
        if escalate_after < 1:
            raise ValueError("escalate_after must be >= 1")
        self.escalate_after = escalate_after
        self._streak: Dict[str, int] = {}

    def record_miss(self, task: str) -> Optional[int]:
        """Advance ``task``'s streak; return it if escalation is due
        (resetting the streak), else None."""
        streak = self._streak.get(task, 0) + 1
        if streak >= self.escalate_after:
            self._streak[task] = 0
            return streak
        self._streak[task] = streak
        return None

    def clear(self, task: str) -> None:
        self._streak[task] = 0

    def streak_of(self, task: str) -> int:
        return self._streak.get(task, 0)
