"""Performance Logger + FL-Dashboard (paper component 6); a copy of
``repro/metrics/logger.py``.

Collects per-round model metrics and host resource usage into JSONL + CSV;
``dashboard()`` renders the terminal summary the paper's web dashboard shows.
"""
from __future__ import annotations

import csv
import json
import pathlib
import resource
import sys
import time
from typing import Optional


def _rss_mb(ru_maxrss: int) -> float:
    """``ru_maxrss`` -> MB. getrusage reports kilobytes on Linux but BYTES
    on macOS (see getrusage(2) on each) — without normalizing, Darwin
    dashboards read 1024x too large."""
    return ru_maxrss / (2**20 if sys.platform == "darwin" else 1024)


def host_usage() -> dict:
    """Host resource snapshot (CPU seconds + peak RSS, platform-normalized)
    — shared by the per-round logger rows and the flight recorder's
    per-launch host counters so the two can never disagree on units."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": round(usage.ru_utime + usage.ru_stime, 3),
            "max_rss_mb": round(_rss_mb(usage.ru_maxrss), 1)}


class PerformanceLogger:
    """Per-round metric rows (plus host usage), optionally mirrored to JSONL."""

    def __init__(self, out_dir=None, run_name: str = "run"):
        self.rows = []
        self.run_name = run_name
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self._t0 = time.time()
        if self.out_dir:
            self.out_dir.mkdir(parents=True, exist_ok=True)

    def log_round(self, round_idx: int, **metrics):
        """Append one round's row (wall clock, host usage, metrics)."""
        row = {
            "round": round_idx,
            "wall_s": round(time.time() - self._t0, 3),
            **host_usage(),
            **{k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in metrics.items()},
        }
        self.rows.append(row)
        if self.out_dir:
            with open(self.out_dir / f"{self.run_name}.jsonl", "a") as f:
                f.write(json.dumps(row) + "\n")
        return row

    def to_csv(self, path=None):
        """Write every row to CSV (default: ``<out_dir>/<run_name>.csv``)."""
        if path is None:
            if self.out_dir is None:
                raise ValueError(
                    "PerformanceLogger.to_csv needs an explicit path when "
                    "the logger was constructed with out_dir=None")
            path = self.out_dir / f"{self.run_name}.csv"
        keys = sorted({k for r in self.rows for k in r})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)
        return path

    def series(self, key: str):
        """One metric's values across the logged rounds."""
        return [r.get(key) for r in self.rows]

    def dashboard(self) -> str:
        """Terminal summary: last/min/max of every numeric metric."""
        if not self.rows:
            return "(no rounds logged)"
        keys = [k for k in self.rows[-1] if k not in ("round",)]
        lines = [f"== FL dashboard: {self.run_name} "
                 f"({len(self.rows)} rounds) =="]
        last = self.rows[-1]
        for k in keys:
            vals = [r.get(k) for r in self.rows if isinstance(r.get(k), (int, float))]
            if vals and isinstance(last.get(k), (int, float)):
                lines.append(f"  {k:>14}: last={last[k]:.4f} "
                             f"min={min(vals):.4f} max={max(vals):.4f}")
        return "\n".join(lines)
