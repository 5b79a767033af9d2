"""What every comparison shares: the arithmetic of its numbers, and the
judge that sets each number beside its limit.  Which numbers a cell compares,
and how they are read, is its kind's (``kinds/<kind>.py``, ``NUMBERS``)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

Tensor = torch.Tensor
STILL_FRACTION = 1e-3  # of the median leaf's reference gradient


def worst(values) -> float:
    """The largest of ``values``; infinite where any is not a number, which
    Python's ``max`` would let pass or not depending on the order."""
    values = list(values)
    return float("inf") if any(v != v for v in values) else max(values)


def relative(program: float, reference: float) -> float:
    return abs(program - reference) / abs(reference)


def norms(leaves: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in leaves.items()}


def leaf_gaps(program: Dict[str, Tensor], reference: Dict[str, Tensor], keys) -> Dict[str, float]:
    """Per leaf: the gap of norms over the larger of the leaf's and the median
    leaf's reference norm."""
    keys = list(keys)
    p, r = norms({k: program[k] for k in keys}), norms({k: reference[k] for k in keys})
    median = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keys}


def moving_leaves(grads: Dict[str, Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least ``STILL_FRACTION`` of
    the median leaf's; the others move under Adam by round-off alone."""
    g = norms(grads)
    median = statistics.median(g.values())
    return [k for k, v in g.items() if v >= STILL_FRACTION * median]


def judge(values: Dict[str, float], limits: Dict[str, float],
          numbers: Sequence[str]) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and, per number, its value beside its limit.  A number with
    no limit, or that is not finite, fails."""
    out, correct = {}, True
    for name in numbers:
        value, limit = values[name], limits.get(name)
        ok = limit is not None and value == value and value <= limit
        correct = correct and ok
        out[name] = {"value": value, "limit": limit}
    return correct, out
