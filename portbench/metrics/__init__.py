"""One module a per-layer metric (``metrics/<name>.py``, the name in
``BENCHMARK.json``): ``UNIT``, ``LAYER``, ``MOVES`` and ``read(r)``,
which takes the traced run's reading (``harness.Reading``) and returns
the metric's number, or None where the run has nothing it reads. A
share of a roofline is never clamped and never read as 0."""
