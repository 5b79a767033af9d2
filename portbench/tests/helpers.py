"""Cells at a size a CPU test holds: the configurations' widths as they are,
a small table and minibatch (the fused update's minibatch stays a multiple of
its block of 1,024 rows, halved too)."""

import shutil
from pathlib import Path

from portbench import harness

ROOT = harness.ROOT
CPU_MINIBATCH = {"fused_dqn": 2048, "qrdqn": 128}  # by adapter


def small(cell, rows=5000, steps_per_call=3):
    cell.traffic = dict(cell.traffic, rows=rows, steps_per_call=steps_per_call,
                        minibatch=CPU_MINIBATCH[cell.config["adapter"]])
    return cell


def cells():
    return [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]


def copy_benchmark(dest: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's folder, copied under ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest
