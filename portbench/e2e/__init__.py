"""One module an end-to-end metric (``e2e/<name>.py``, the name in
``BENCHMARK.json``): ``UNIT`` and ``read(r)`` over the untraced run's
reading (``harness.Reading``): host-clock times of the window."""
