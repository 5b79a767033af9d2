"""Per-layer metric readers: ``<metric>.py`` for each ``per_layer`` entry of
``BENCHMARK.json``, found by the metric's name.

A reader exposes ``read(ctx) -> float | None`` where ``ctx`` is a
``harness.Readings`` (the traced stretch, the work it completed, the
unprofiled window's rates of the same run, the configuration, the traffic
mix and the card's peaks).  A reader that finds nothing to read returns
``None`` and the metric is left out of the result's line; a share of a
roofline or of a peak is never returned as 0.  A reader may name entries of
the program to open a span around in the traced stretch (``SPANS``, see
``spans.py``).
"""
