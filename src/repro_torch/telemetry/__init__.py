"""Observability planes (port of ``repro/telemetry/``), the comms plane
only for now: ``telemetry/comms.py`` and its byte model
``core/netmodel.py``. The flight recorder (``recorder.py``, ``trace.py``)
and its Perfetto counter tracks are not yet ported (ROADMAP A11), and
``core/jobs.load_job`` refuses a ``telemetry:`` section.
"""
