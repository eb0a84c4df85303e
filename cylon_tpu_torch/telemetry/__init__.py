"""Telemetry of the port (counterpart of cylon_tpu.telemetry). So far only
the environment-knob registry (``knobs``); spans, metrics and the rest
are queued in ROADMAP.md."""
