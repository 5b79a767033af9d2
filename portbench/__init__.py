"""The benchmark of ``reagent_tpu_torch`` on one NVIDIA card.

``python3 portbench/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints
one JSON line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own (``configs/``, ``traffic/``,
``metrics/``), found by the name that ``BENCHMARK.json`` gives it; see
``README.md``.  Nothing here imports JAX or the JAX package, and nothing under
``reference/`` imports the program.
"""
