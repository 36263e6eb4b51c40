"""The control plane's shared §4.4 straggler policy and hierarchy face.

The port's copies of ``StragglerTracker`` and the ``HierarchyAPI``
Protocol from ``repro/core/control_plane.py``: the same streak rule, so a
deadline round driven by either package escalates the same silo in the
same round, and the same surface for the two-level aggregation hierarchy
(:class:`~repro_torch.federated.hierarchy.HierarchyCoordinator` is its
concrete form).  The rest of the control plane (the other module
Protocols, ``ControlPlane`` and ``Experiment``) comes with ``ROADMAP.md``
queue 1, item 9.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, Sequence, runtime_checkable

__all__ = ["HierarchyAPI", "StragglerTracker"]


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


@runtime_checkable
class HierarchyAPI(Protocol):
    """Two-level aggregation: regional cohort folds composed via partial
    sums (see :mod:`repro_torch.federated.hierarchy` for the concrete
    coordinator and the numerical-equivalence contract)."""

    @property
    def region_ids(self) -> List[str]: ...

    def cohort_for(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> List[str]: ...

    def fold_partials(
        self,
        round_idx: int,
        partials: Sequence[Any],
        base_params: Any,
        now_s: float = ...,
    ) -> Any: ...

    def fold_round(
        self,
        round_idx: int,
        results: Sequence[Any],
        schedule: Any = ...,
        base_params: Any = ...,
    ) -> Any: ...
