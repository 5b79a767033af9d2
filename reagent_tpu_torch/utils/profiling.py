"""Tracing / profiling helpers.

Port of ``reagent_tpu/utils/profiling.py``.  ``trace`` records a
``torch.profiler`` trace over the CPU and, where a card is present, CUDA
activities, and writes it into ``log_dir`` as a Chrome trace
(``trace.json``, viewable in Perfetto or ``chrome://tracing``); JAX's writes
an xprof trace.  ``StepTimer.measure`` synchronises the device of the
tensors it is given before it stops the clock, as ``jax.block_until_ready``
does, and ``annotate`` names a region of the trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a Chrome trace of the block into ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _cuda_devices(tree: Any, found: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (tensors, mappings,
    sequences and dataclasses, nested)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)
    return found


def block_until_ready(tree: Any) -> Any:
    """Wait for the work that produces ``tree``'s CUDA tensors."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


class StepTimer:
    """Blocking wall-clock timer for steps (synchronises the device)."""

    def __init__(self):
        self.times: list = []

    @contextlib.contextmanager
    def measure(self, result_to_block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if result_to_block_on is not None:
            block_until_ready(result_to_block_on)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        arr = np.asarray(self.times[1:] or self.times)  # drop the first (warm-up) step
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p99_s": float(np.percentile(arr, 99)),
            "steps_per_s": float(1.0 / max(arr.mean(), 1e-12)),
        }


def annotate(name: str):
    """Named region in the trace."""
    return torch.profiler.record_function(name)
