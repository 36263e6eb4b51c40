"""The comparison that decides ``correct``.

The program's first round (set-up's warm-up round, through the window's
own call) against the plain reference's round from the same weights and
batches.  Six numbers, each against its cell's limit
(``fedbench/limits/<workload>.json``):

* ``step_loss``: the largest relative gap of a local step's loss, over
  the first STEPS_FOLLOWED steps of every silo.
* ``grad1``: each silo's first gradient as the optimizer got it (its
  first moment after one step over 1 - b1), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
* ``delta3``: the same for each leaf's change over a silo's first
  STEPS_FOLLOWED steps, as the next step's update is handed it.
* ``delta``: the same for each leaf's change over the whole round, the
  global weights after the fold against before.
* ``eval_loss``: the relative gap between the round's evaluation loss and
  the reference's evaluation of the program's own round weights (the
  evaluation stage by itself).
* ``fold``: the fold stage by itself, over every round of set-up (two
  where the update carries a codec, so that each silo's error feedback
  from the first round is folded into the second): the program's new
  global weights against the reference's fold of what the program's
  silos shipped (``reference.fedavg.fold_rounds``), on codec blocks drawn
  from the seed.  By the worst block: the norm of the difference over
  the larger of the block's change and the blocks' root-mean-square
  change.  The fold is a function of what it is handed, so unlike the
  training numbers it is not subject to chaos and its limit is tight.

Later local steps are not compared one by one: a silo's training is
chaotic over tens of Adam steps (rounding-level gaps grow to percents of
a late step's loss in float32 on both sides), so only the first steps
and the round's result carry a limit.  Leaves whose reference gradient is
under a thousandth of the median leaf's (a LoRA ``a`` factor's first
gradient, zero while ``b`` is, and every frozen leaf) move by the
optimizer's rounding alone: they are left out of ``grad1``, ``delta3`` and
``delta``, by that rule and not by name.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from .reference.fedavg import STEPS_FOLLOWED

NAMES = ("step_loss", "grad1", "delta3", "delta", "eval_loss", "fold")
QUIET = 1e-3   # a leaf whose reference gradient is under this share of the median's


def _median(x: torch.Tensor) -> torch.Tensor:
    return torch.quantile(x, 0.5)


def _worst_leaf(got: torch.Tensor, want: torch.Tensor) -> float:
    if want.numel() == 0:
        return 0.0
    floor = torch.maximum(want, _median(want))
    return float(((got - want).abs() / floor).max())


def fold_gap(rounds: List[Dict[str, Any]], want: List[torch.Tensor]) -> float:
    """``fold``: the program's new weights of each round (``rounds[i]
    ["new"]``) against the reference's (``want[i]``), by the worst block."""
    worst = 0.0
    for rnd, w in zip(rounds, want, strict=True):
        change = (w - rnd["base"]).double().norm(dim=1)
        floor = torch.maximum(change, change.square().mean().sqrt())
        worst = max(worst, float(((rnd["new"] - w).double().norm(dim=1) / floor).max()))
    return worst


def readings(prog: Dict[str, Any], ref: Dict[str, Any], eval_ref: float,
             fold: float = math.nan) -> Dict[str, float]:
    """The six numbers; NaN where the program gave none or a non-finite
    one.  ``eval_ref`` is the reference's evaluation loss of the program's
    own round weights, ``fold`` the reading of ``fold_gap``."""
    gaps: List[float] = []
    for got, want in zip(prog["losses"], ref["losses"]):
        if len(got) != len(want):
            return dict.fromkeys(NAMES, math.nan)
        gaps += [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got[:STEPS_FOLLOWED], want[:STEPS_FOLLOWED])]
    g_ref, g_prog = ref["grad1"].double(), prog["grad1"].double()
    if g_prog.shape != g_ref.shape or prog["delta3"].shape != ref["delta3"].shape:
        return dict.fromkeys(NAMES, math.nan)
    loud = g_ref.amax(0) >= QUIET * _median(g_ref.amax(0))
    grad1 = max(_worst_leaf(g_prog[s, loud], g_ref[s, loud]) for s in range(g_ref.shape[0]))
    d3_ref, d3_prog = ref["delta3"].double(), prog["delta3"].double()
    delta3 = max((_worst_leaf(d3_prog[s, loud], d3_ref[s, loud]) for s in range(d3_ref.shape[0])),
                 default=0.0)
    trained = torch.as_tensor(ref["trained"])[loud]
    delta = _worst_leaf(prog["delta"].double()[trained], ref["delta"].double()[trained])
    out = {"step_loss": max(gaps), "grad1": grad1, "delta3": delta3, "delta": delta,
           "eval_loss": abs(prog["eval_loss"] - eval_ref) / max(abs(eval_ref), 1e-30),
           "fold": fold}
    return {k: (v if math.isfinite(v) else math.nan) for k, v in out.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, in a fixed order.  A number
    the cell's limits leave out is not compared (see its limits file)."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES if k in limits}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
