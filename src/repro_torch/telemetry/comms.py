"""Comms observatory (port of ``repro/telemetry/comms.py``) — the
job-facing face of the wire-traffic plane.

A ``comms:`` job section turns on **pure host-side** traffic accounting
(``core/netmodel.py``): per-round uplink/downlink byte totals gated by the
real cohort masks / async accept flags, and a simulated wall-clock that
composes LinkModel transfer times with the virtual clock's compute
durations. Nothing device-side changes — comms-on trajectories are bitwise
comms-off.

Outputs:

- ``comms.csv`` — tidy per-round rows (``round`` + the columns
  ``core.netmodel.COMMS_COLUMNS``), written by ``core/probes.ProbeTable``;
- ``sim_time_s`` / ``cum_bytes`` columns joined onto the executor's result
  rows, so eval metrics plot directly as time-to-accuracy and
  bytes-to-accuracy curves;
- ``Executor._comms_summaries()``: the run-level totals.

- the ``comms:*`` Perfetto counter tracks (``COUNTER_COLUMNS``) and the
  run-level ``comms_total`` counters of the flight recorder.

Job section::

    comms:
      enabled: true          # presence of the section already enables
      out_dir: runs/exp1     # comms.csv target (else the executor's ckpt_dir)
      pods: 4                # hierarchical backbone pods (byte model only)

LinkModel knobs (per-client bandwidth tiers + latency) live in the
``runtime:`` section — they are ``ClientSystemModel`` fields
(``up_mbps`` / ``down_mbps`` / ``link_tiers`` / ``link_tier_factor`` /
``latency_s``), drawn from a dedicated Philox tag so schedules stay
prefix-stable with the link model on or off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# re-exported so executor/test code has one import surface for the plane
from repro_torch.core.netmodel import COMMS_COLUMNS, LaneComms  # noqa: F401

# the cumulative columns the flight recorder streams as Perfetto counter
# tracks per launch
COUNTER_COLUMNS = ("cum_up_bytes", "cum_down_bytes", "sim_time_s")
# the columns joined onto the executor's result rows (the
# time-to-accuracy / bytes-to-accuracy x-axes)
RESULT_COLUMNS = ("sim_time_s", "cum_bytes")


@dataclasses.dataclass(frozen=True)
class CommsSpec:
    """Parsed ``comms:`` job section (validated by ``core/jobs.load_job``).

    ``enabled`` turns the accounting plane on; ``out_dir`` receives
    ``comms.csv`` (falls back to the executor's ``ckpt_dir`` — rows stay in
    memory when neither is set); ``pods`` is the hierarchical backbone width
    the byte model bills cross-pod hops for."""
    enabled: bool = False
    out_dir: Optional[str] = None
    pods: int = 1

    def __post_init__(self):
        if int(self.pods) < 1:
            raise ValueError(f"comms.pods must be >= 1, got {self.pods}")

    @classmethod
    def from_job(cls, job) -> "CommsSpec":
        """Build from a job's ``comms:`` section (absent -> disabled)."""
        c = (getattr(job, "raw", None) or {}).get("comms") or {}
        return cls(enabled=bool(c) and bool(c.get("enabled", True)),
                   out_dir=c.get("out_dir"),
                   pods=int(c.get("pods", 1)))
