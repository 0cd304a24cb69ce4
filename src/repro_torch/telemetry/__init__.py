"""Observability planes (port of ``repro/telemetry/``): the flight recorder
(``recorder.py``: nested monotonic-clock spans over the chunk-boundary seams
of the sync, async and campaign round loops, per-launch counters, a
``telemetry.jsonl`` per run dir), its Chrome-trace/Perfetto exporter and
terminal report (``trace.py``, ``python -m repro_torch.telemetry.trace
<run_dir>``), and the comms plane (``comms.py`` with its byte model
``core/netmodel.py``).

Everything here is host-side Python, so the round loops' trajectories are
bitwise the same with telemetry on or off (``tests/test_torch_telemetry.py``).
"""
from repro_torch.telemetry.recorder import FlightRecorder, read_events

__all__ = ["FlightRecorder", "read_events"]
