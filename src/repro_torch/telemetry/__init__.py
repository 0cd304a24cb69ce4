"""Observability planes (port of ``repro/telemetry/``): the flight recorder
(``recorder.py``: nested monotonic-clock spans over the chunk-boundary seams
of the sync, async and campaign round loops, per-launch counters, a
``telemetry.jsonl`` per run dir), its Chrome-trace/Perfetto exporter and
terminal report (``trace.py``, ``python -m repro_torch.telemetry.trace
<run_dir>``), the layer spans inside a launch (``recorder.layer_span``,
``layer_count``, ``layer_times``: on under ``torch.profiler`` or an
enabled recorder's launch), and the comms plane (``comms.py`` with its byte model
``core/netmodel.py``).

Everything here is host-side Python, so the round loops' trajectories are
bitwise the same with telemetry on or off (``tests/test_torch_telemetry.py``).
"""
from repro_torch.telemetry.recorder import (FlightRecorder, layer_count, layer_span,
                                            layer_times, layers_on, read_events,
                                            reset_layer_times)

__all__ = ["FlightRecorder", "layer_count", "layer_span", "layer_times", "layers_on",
           "read_events", "reset_layer_times"]
