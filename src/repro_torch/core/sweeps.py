"""Sweep grid expansion for campaigns (port of ``repro/core/sweeps.py``).

A job config plus a ``sweep:`` section expands into S trajectories — the
row-major product of the sweep axes. The axes split into planes, which is
what lets all S trajectories share ONE vmapped pass per round:

- **data plane** (``seed``, ``dirichlet_alpha``): the value changes the root
  dataset and/or the client partitions; unique roots are staged once and
  each lane indexes its own (``data/pipeline.stage_partitions_dedup``).
- **schedule plane** (``staleness_exponent``): async only — the value
  reshapes the host event schedule; lanes sharing (seed, partition, alpha,
  staleness_exponent) share one schedule.
- **scalar plane** (``client_lr``, ``prox_mu``, ``server_lr``, ...): the
  value reaches the round as a per-lane device tensor
  (``core/rounds.bind_hyper``).

``seed`` lives in the data plane and the scalar plane, which is why it is
also in ``configs.base.SWEEPABLE_SCALARS``. Categorical axes (``strategy``,
``topology``, ``placement``, ``mode``, ``async_buffer``, ``compression``)
change the round program itself; ``parse_sweep`` validates them and the
planner (``core/plan.py``, ``runtime/scheduler.PlanExecutor``) runs one
campaign per program signature.

Determinism contract: expansion is bookkeeping — trajectory ``s`` of a
campaign is bitwise a single run of the s-th expanded config
(``tests/test_torch_sweeps.py``).
"""
from __future__ import annotations

import dataclasses
import difflib
import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (SWEEPABLE_CATEGORICAL, SWEEPABLE_SCALARS,
                                      FLConfig)
from repro_torch.core import determinism

DATA_AXES = ("seed", "dirichlet_alpha")
SCHEDULE_AXES = ("staleness_exponent",)
SCALAR_AXES = tuple(k for k in SWEEPABLE_SCALARS if k != "seed")
CATEGORICAL_AXES = SWEEPABLE_CATEGORICAL
# cohort plane: population and cohort sizes are host-side slab-plan values
# under the ragged client plane (max_cohort > 0), so lanes sweeping them
# share one round program; with max_cohort == 0 they change the round's
# shapes and bucket through the planner like categorical axes
COHORT_AXES = ("n_clients", "cohort")
KNOWN_AXES = (DATA_AXES + SCHEDULE_AXES + SCALAR_AXES + COHORT_AXES
              + CATEGORICAL_AXES)

# job-YAML convenience: `sweep: {seeds: [0, 1, 2]}`
_AXIS_ALIASES = {"seeds": "seed"}

# legal values per categorical axis; None -> resolved from the live registry
_CATEGORICAL_CHOICES = {
    "strategy": None,
    "topology": ("client_server", "hierarchical", "decentralized"),
    "placement": ("spatial", "temporal", "auto"),
    "mode": ("sync", "async"),
    "async_buffer": None,            # any int >= 0
    "compression": ("none", "int8", "topk"),
}


def _categorical_values(name, values) -> Tuple[Any, ...]:
    """Validate one categorical axis' values (did-you-mean on typos)."""
    if name == "async_buffer":
        return tuple(int(v) for v in values)
    if name == "strategy":
        from repro_torch.core.strategies import REGISTRY
        choices = tuple(sorted(REGISTRY))
    else:
        choices = _CATEGORICAL_CHOICES[name]
    out = []
    for v in values:
        if v not in choices:
            hint = difflib.get_close_matches(str(v), choices, n=1)
            suffix = (f" — did you mean {hint[0]!r}?" if hint
                      else f"; known values: {list(choices)}")
            raise KeyError(f"unknown {name} value {v!r} in sweep axis{suffix}")
        out.append(str(v))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Ordered sweep axes; the grid is their row-major product."""
    axes: Tuple[Tuple[str, Tuple[Any, ...]], ...]

    @property
    def names(self) -> Tuple[str, ...]:
        """Sweep axis names in declaration order."""
        return tuple(n for n, _ in self.axes)

    @property
    def size(self) -> int:
        """Number of grid points (product of axis lengths)."""
        s = 1
        for _, vals in self.axes:
            s *= len(vals)
        return s

    def coords(self) -> List[Dict[str, Any]]:
        """One {axis: value} dict per trajectory, row-major (the last axis
        varies fastest) — the key order of the results table."""
        if not self.axes:
            return [{}]
        return [dict(zip(self.names, combo))
                for combo in itertools.product(*(v for _, v in self.axes))]

    @property
    def categorical_names(self) -> Tuple[str, ...]:
        """The swept axes whose values change the round program."""
        return tuple(n for n in self.names if n in CATEGORICAL_AXES)


def parse_sweep(section) -> Optional[SweepSpec]:
    """Validate a job's ``sweep:`` section into a SweepSpec (None if absent);
    unknown axis names fail with a near-miss suggestion."""
    if section is None:
        return None
    if not isinstance(section, dict) or not section:
        raise ValueError("sweep: section must be a non-empty mapping of "
                         f"axis -> list of values; got {section!r}")
    axes = []
    for raw_name, values in section.items():
        name = _AXIS_ALIASES.get(raw_name, raw_name)
        if name not in KNOWN_AXES:
            hint = difflib.get_close_matches(
                name, KNOWN_AXES + tuple(_AXIS_ALIASES), n=1)
            suffix = (f" — did you mean {hint[0]!r}?" if hint
                      else f"; sweepable axes: {sorted(KNOWN_AXES)}")
            raise KeyError(f"unknown sweep axis {raw_name!r}{suffix}")
        if any(name == n for n, _ in axes):
            raise ValueError(f"sweep axis {raw_name!r} duplicates "
                             f"{name!r} (aliases resolve to one axis)")
        if not isinstance(values, (list, tuple)) or len(values) == 0:
            raise ValueError(f"sweep axis {raw_name!r} needs a non-empty "
                             f"list of values; got {values!r}")
        if name in CATEGORICAL_AXES:
            values = _categorical_values(name, values)
        elif name == "seed" or name in COHORT_AXES:
            values = tuple(int(v) for v in values)
        else:
            values = tuple(float(v) for v in values)
        if len(set(values)) != len(values):
            raise ValueError(f"sweep axis {raw_name!r} repeats values "
                             f"{values!r}; the grid would duplicate lanes")
        axes.append((name, tuple(values)))
    return SweepSpec(axes=tuple(axes))


def expand(fl: FLConfig, spec: SweepSpec) -> List[FLConfig]:
    """The S per-trajectory configs, in the grid's row-major order."""
    return [dataclasses.replace(fl, **coord) for coord in spec.coords()]


def scalar_plane(fls: List[FLConfig], device) -> Dict[str, Any]:
    """The per-lane hyper dict on ``device``: one (S,) tensor per sweepable
    scalar, int64 for the seed, f32 for the rest (swept axes vary per lane,
    unswept ones repeat the base value). Every sweepable scalar is in it, as
    in the single-run executor's, so both sides consume the same scalars as
    runtime values."""
    hyper = {"seed": torch.tensor([fl.seed for fl in fls], dtype=torch.int64,
                                  device=device)}
    for name in SCALAR_AXES:
        hyper[name] = torch.tensor([float(getattr(fl, name)) for fl in fls],
                                   dtype=torch.float32, device=device)
    return hyper


def root_keys(fls: List[FLConfig], device):
    """(S,) int64 per-trajectory root keys (lane s == the single run's
    ``determinism.root_key(seed_s)``)."""
    return determinism.root_keys([fl.seed for fl in fls], device)
