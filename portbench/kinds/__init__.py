"""Kinds of cell: ``<kind>.py`` holds everything that differs between kinds
of work, for a configuration whose ``kind`` is ``<kind>``: the inputs made
from the seed, the program driven through its own entry, the count of work,
and the numbers compared with the plain reference.  The harness around it
(set-up clock, window, traced stretch, metric readers, result line) is the
same for every kind.

A kind module exposes ``NUMBERS`` (the compared numbers' names, each with a
limit in the configuration's ``limits``) and ``Run(cell, seed, device,
precision, load)``, built in set-up, where ``load(folder, name)`` loads
``portbench/<folder>/<name>.py`` of the checkout.  A ``Run`` has:

- ``program``: the system under test (per-layer readers' spans may name its
  attributes);
- ``checked()``: the first call of the window's own entry, from the inputs
  made from the seed, keeping what the comparison reads; part of set-up;
- ``call()``: one call of the same entry, enqueued; returns what
  ``finish`` reads;
- ``finish(pending) -> (attempted, failed, work)``: reads the call's
  results back; ``work`` counts what completed, by unit (``steps``,
  ``samples``, ...), which the end-to-end and per-layer readers divide;
- ``close()``: frees the program and its state (the comparison's copies
  stay);
- ``compare() -> {number: value}``: runs the reference and compares.
"""
