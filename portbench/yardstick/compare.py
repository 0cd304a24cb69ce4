"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each a relative gap.

- ``loss_gap``: the largest |program - reference| / |reference| over the
  rounds' losses;
- ``norm_gap``: over the leaves, the largest gap between the program's
  norm of a leaf's change and the reference's, over the reference's norm
  of that leaf or of the median leaf, whichever is larger. A leaf whose
  change in the reference's first round is under a thousandth of the
  median leaf's moves by round-off alone, and is left out.
"""
from __future__ import annotations

import math
import statistics

ROUNDOFF_SHARE = 1e-3


def worst(values) -> float:
    """The largest value; NaN if any is NaN."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def median(values) -> float:
    """The median; NaN if any value is NaN."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else statistics.median(values)


def loss_gap(prog: list, ref: list) -> float:
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program losses against {len(ref)} reference losses")
    return worst(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def moved(first: dict) -> list:
    """The leaves whose reference change in the first round is not round-off."""
    med = statistics.median(first.values())
    return sorted(k for k, v in first.items() if v >= ROUNDOFF_SHARE * med)


def norm_gap(prog: dict, ref: dict, leaves: list) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)
