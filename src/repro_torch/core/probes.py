"""Round-probe tables (port of the host half of ``repro/core/probes.py``):
``ProbeTable``, the append-only csv writer, and ``read_probes``, its reader.
The executor writes ``comms.csv`` with them.

The probe catalogue itself (the seven in-round diagnostics, their ``(R, P)``
stacking and the rounds' ``metrics["probes"]``) arrives with the rest of
ROADMAP A11; ``core/jobs.load_job`` refuses a ``probes:`` section until then.
"""
from __future__ import annotations

import csv
import pathlib
from typing import Optional


class ProbeTable:
    """Append-only csv writer (one row per round): ``probes.csv`` in the
    JAX package, ``comms.csv`` here.

    The column set is fixed, so columns never grow: the file truncates on
    the first flush of a process (one file per run) and every later flush
    appends only the new rows."""

    def __init__(self, path, lead):
        self.path = pathlib.Path(path)
        self.lead = list(lead)
        self._fieldnames = None
        self._fh = None
        self._writer = None

    def flush(self, rows) -> Optional[pathlib.Path]:
        """Append ``rows`` (the new rows only — the caller buffers). The
        file handle stays open across flushes (a boundary-per-round run
        would otherwise pay an open/close per round); every flush ends on
        a flushed handle, so the csv is readable mid-run."""
        if not rows:
            return self.path if self._fieldnames else None
        if self._fieldnames is None:
            self._fieldnames = self.lead + sorted(
                {k for r in rows for k in r} - set(self.lead))
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._open("w")
            self._writer.writeheader()
        elif self._fh is None:                 # flushed again after close()
            self._open("a")
        self._writer.writerows(rows)
        self._fh.flush()
        return self.path

    def _open(self, mode: str):
        self._fh = open(self.path, mode, newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self._fieldnames)

    def close(self) -> None:
        """Close the file handle; a later ``flush`` appends again."""
        if self._fh is not None:
            self._fh.close()
            self._fh = self._writer = None


def read_probes(csv_path) -> list:
    """Read a ``probes.csv`` back into tidy rows (floats where numeric,
    ints for round/traj, categorical coordinates as strings)."""
    def cell(k, v):
        if k in ("round", "traj", "seed", "bucket", "lane"):
            return int(float(v))
        try:
            return float(v)
        except ValueError:
            return v
    with open(csv_path, newline="") as f:
        return [{k: cell(k, v) for k, v in row.items() if v != ""}
                for row in csv.DictReader(f)]
