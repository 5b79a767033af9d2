"""Multi-process input assembly and data-parallel scaling measurement.

Port of ``reagent_tpu/parallel/scaling.py`` (``analytic_dp_allreduce_model``
:38, ``host_shard_batch`` :87, ``measure_scaling_efficiency`` :104-144):

* ``host_shard_batch`` puts this rank's locally loaded rows on its device,
  after one ``all_gather`` of the row counts checks that every rank of the
  data group passes as many (JAX assembles a global array from the
  processes' local shards);
* ``measure_scaling_efficiency`` runs the data-parallel step on the first n
  ranks for each n of ``device_counts`` and reports weak-scaling efficiency,
  with the card synchronised around each timed window.  On one card it
  measures world size 1 only: no scaling.
* ``analytic_dp_allreduce_model`` keeps JAX's ring all-reduce formula but
  takes the link rate and the hop latency as required arguments: JAX's
  defaults describe another interconnect.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from reagent_tpu_torch.parallel.data_parallel import (
    Mesh,
    all_gather_rows,
    leaves,
    make_data_parallel_train_step,
    make_mesh,
    map_leaves,
    replicate,
    shard_batch,
)


def analytic_dp_allreduce_model(
    param_bytes: float,
    compute_time_s: float,
    device_counts: Sequence[int],
    *,
    link_bytes_per_s: float,
    hop_latency_s: float,
) -> Dict[int, Dict[str, float]]:
    """Predicted data-parallel weak-scaling efficiency.

    A ring all-reduce moves ``2(n-1)/n * param_bytes`` through each rank's
    link (reduce-scatter + all-gather), so a step's overhead is that volume
    over ``link_bytes_per_s`` plus the ring's sequential hop latencies:
    ``2(n-1)`` hops on a 1-D ring, ``~4(sqrt(n)-1)`` on a 2-D torus (the
    layout JAX's formula assumes beyond 16 ranks).  The predicted efficiency
    is ``compute / (compute + allreduce)``."""
    out: Dict[int, Dict[str, float]] = {}
    for n in device_counts:
        if n <= 1:
            out[n] = {"allreduce_s": 0.0, "predicted_efficiency": 1.0}
            continue
        hops = 2.0 * (n - 1) if n <= 16 else 4.0 * (np.sqrt(n) - 1.0)
        ar = 2.0 * (n - 1) / n * param_bytes / link_bytes_per_s + hop_latency_s * float(hops)
        out[n] = {"allreduce_s": ar, "predicted_efficiency": compute_time_s / (compute_time_s + ar)}
    return out


def host_shard_batch(local_batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """This rank's locally loaded rows (numpy or tensors) on its device: its
    shard of a global batch of ``local * ranks`` rows over ``axis``.  Raises
    ``ValueError`` unless every rank of the axis passes as many rows."""
    rows = leaves(local_batch)[0].shape[0]
    device = mesh.device
    counts = all_gather_rows(torch.tensor([rows], device=device), mesh.groups[axis],
                             mesh.axis_size(axis))
    if bool((counts != rows).any()):
        raise ValueError(f"the ranks pass {counts.tolist()} rows; each must pass as many")
    return map_leaves(lambda x, _: torch.as_tensor(x).to(device), local_batch)


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def measure_scaling_efficiency(
    trainer: Any,
    trainer_state: Any,
    batch_for: Callable[[int], Any],
    device_counts: Optional[Sequence[int]] = None,
    num_steps: int = 50,
    axis: str = "data",
    device="cuda",
) -> Dict[int, Dict[str, float]]:
    """Weak-scaling sweep: ``batch_for(n)`` is the global batch for n ranks.
    Every rank of the default group calls it; for each n the first n ranks
    time ``num_steps`` data-parallel steps (after one untimed) and report
    ``{"steps_per_s", "samples_per_s", "efficiency"}``, efficiency the step
    rate over the first count's (ideal 1.0).  The others only join the
    groups' creation, and their dict lacks that n."""
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    results: Dict[int, Dict[str, float]] = {}
    base_rate = None
    for n in device_counts:
        mesh = make_mesh(n_devices=n, axis_names=(axis,), device=device)
        if not mesh.contains_rank:
            continue
        step = make_data_parallel_train_step(trainer, mesh, axis=axis)
        state = replicate(trainer_state, mesh)
        global_batch = batch_for(n)
        batch = shard_batch(global_batch, mesh, axis)
        state, _ = step(state, batch)  # untimed: the first call's allocations
        _sync(mesh)
        t0 = time.perf_counter()
        for _ in range(num_steps):
            state, _ = step(state, batch)
        _sync(mesh)
        rate = num_steps / (time.perf_counter() - t0)
        if base_rate is None:
            base_rate = rate
        results[n] = {"steps_per_s": rate,
                      "samples_per_s": rate * int(leaves(global_batch)[0].shape[0]),
                      "efficiency": rate / base_rate}
    return results
