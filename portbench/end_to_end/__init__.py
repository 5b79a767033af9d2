"""End-to-end metric readers: ``<metric>.py`` for each ``end_to_end`` entry of
``BENCHMARK.json``, found by the metric's name.

A reader exposes ``read(window) -> float | None`` where ``window`` is a
``harness.Window``: the work the window completed by unit (as the cell's kind
counts it), its seconds on the host's clock, each call's seconds and the
run's set-up seconds.  A reader whose unit the cell does not count returns
``None``, and the metric is left out of the line.
"""
