"""Tracing / profiling helpers.

Port of ``reagent_tpu/utils/profiling.py``.  ``trace`` records a
``torch.profiler`` trace over the CPU and, where a card is present, CUDA
activities, and writes it into ``log_dir`` as a Chrome trace
(``trace.json``, viewable in Perfetto or ``chrome://tracing``); JAX's writes
an xprof trace.  ``StepTimer.measure`` synchronises the device of the
tensors it is given before it stops the clock, as ``jax.block_until_ready``
does, and ``annotate`` names a region of the trace.

``annotate(name)`` opens a span only while a profiler runs; otherwise it
returns one shared context manager that does nothing, so a span on the hot
path costs a flag read.  torch gives no cheap way to read a running
profiler's activities, so the gate is the profiler's flag alone, and the
span is torch's fast record function (``_RecordFunctionFast``, which torch
opens around its compiled kernels): under a profile that records the host
it is a host event of the span's name, nested in whatever span is open
around it on the same thread; under a profile of the device alone it
records nothing and costs next to nothing.  ``record_function`` costs about
ten microseconds a span even there, which at five spans a step raised the
device's idle share of a DQN refresh on an H100 by about 1.5 points, and
some versions of torch draw its spans on the device's timeline too.  A
training step is not a request, so spans carry no step identifier.

The program's spans, the layer each marks, and what reads it:

- ``reagent.loop.step``: one whole step of ``training.scan_loop.
  run_sampled_steps`` (the draw, the gather, the train step).  Read by
  ``host_us_per_step``: the host's own time a step, the span's length less
  the time its thread spent inside the CUDA runtime's and driver's calls,
  where a device-paced loop waits for room in the launch queue.
- ``reagent.loop.sample``: the step's ``torch.randint`` of row indices.
- ``reagent.loop.gather``: the step's gather of the minibatch from the
  table (``batch_of``: a packed-row gather or one gather a field).
- ``reagent.fused_dqn.stage``: ``FusedDQNTrainer.train_step``'s layout of
  the batch as contiguous float32 for the fused update (Adam's scalars
  stay outside).  The last three are read by ``batch_us_per_step``, the
  device time a step of the operations launched inside them.
- ``reagent.k1``: K1's CUDA route in ``ops.fused_dqn_offline.
  fused_dqn_offline_update`` (``launch_cuda``: the C entry's marshalling
  and its launches).  Read by ``k1_host_us_per_update``, the span's length less the
  time inside the CUDA runtime's and driver's calls, as for the step; the
  operations under it are K1's.
- ``reagent.k5``: K5's CUDA route in ``ops.quantile_huber``: the forward
  with its mean in ``quantile_huber_loss``, and the backward, which runs on
  autograd's thread.  The operations under it are K5's; a reader of them
  takes the span's intervals from every thread, or it misses the backward.
- ``reagent.optim.update``: ``optim.union.Rule.update``, every rule's step.
- ``reagent.optim.soft_update``: ``optim.soft_update.soft_update``, the
  target network's Polyak average.  Both are read by
  ``optimizer_launches_per_step``, the device operations a step launched
  inside them.

To profile a refresh, run its loop inside ``with trace(log_dir):`` and open
``log_dir/trace.json``: each device operation lies under the span whose
host interval launched it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

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


_OFF = contextlib.nullcontext()  # the span of ``annotate`` while no profiler runs
_span = torch._C._profiler._RecordFunctionFast


def annotate(name: str):
    """Named region in the trace while a profiler runs; else a shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return _span(name)
    return _OFF
