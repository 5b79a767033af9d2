"""Data-parallel training over ``torch.distributed``.

Port of ``reagent_tpu/parallel/data_parallel.py`` (``make_mesh`` :20,
``replicate`` :37, ``shard_batch`` :42, ``make_data_parallel_train_step``
:53-87).  JAX lays a ``jax.sharding.Mesh`` over its devices, replicates the
trainer state, shards the batch over the ``data`` axis, and XLA inserts the
gradient all-reduce.  Here a ``Mesh`` is a small object over an initialised
default process group: this rank, the mesh's shape and one process group
for each axis (and one for the whole mesh); every rank holds its own copy of
the replicated state and its own contiguous rows of the batch.

The step equals the single-device step on the whole batch.  The port's
autograd trainers step through ``optimizer.update(grads, opt_state,
params)``; the step runs a shallow copy of the trainer whose optimizers
first all-reduce each gradient dict as one flat bucket over the data group
and divide it by the group's size (every loss is a mean over the batch), and
then averages the step's scalar metrics, means over the batch, in one
all-reduce; a per-row metric is all-gathered in rank order.
``FusedDQNTrainer`` (K1/K2) computes its update inside the kernel and has no
gradient to reduce: its step all-gathers the batch rows over the data group
and runs the whole update on every rank, which is what XLA does with JAX's
kernel (JAX's DP step of the fused trainer gives its single-device update).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from reagent_tpu_torch.optim.union import Rule
from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class Mesh:
    """Ranks ``0 .. size - 1`` of the default group laid out row-major in
    ``shape``, one name an axis.  ``groups[axis]`` is the group of the ranks
    that share this rank's coordinates on every other axis; ``group`` spans
    the mesh.  A rank outside the mesh has ``coords`` None."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    coords: Optional[Dict[str, int]]
    groups: Dict[str, Any]
    group: Any
    device: torch.device

    @property
    def contains_rank(self) -> bool:
        return self.coords is not None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.shape}")
        return self.coords[axis]


def mesh_device(device="cuda") -> torch.device:
    """This rank's device: its card (``LOCAL_RANK`` modulo the cards, as a
    launcher sets it) or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def build_mesh(shape: Sequence[int], axis_names: Sequence[str], device="cuda") -> Mesh:
    """A mesh of the first ``prod(shape)`` ranks.  Every rank of the default
    group must call it, in the same order: ``new_group`` is collective."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group)")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    n, world, rank = int(np.prod(shape)), dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}")
    grid = np.arange(n).reshape(shape)
    coords = ({a: int(c) for a, c in zip(axis_names, np.unravel_index(rank, shape))}
              if rank < n else None)
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    whole = dist.new_group(list(range(n)))
    return Mesh(axis_names, shape, rank, coords, groups, whole if rank < n else None,
                mesh_device(device))


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              device="cuda") -> Mesh:
    """A 1-D data mesh over the first ``n_devices`` ranks (all by default);
    with two axis names, ``(hosts, ranks a host)``, the ranks a host from
    ``LOCAL_WORLD_SIZE`` (a launcher sets it; one host without it)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if len(axis_names) == 1:
        return build_mesh((n,), axis_names, device)
    if len(axis_names) != 2:
        raise ValueError(f"make_mesh lays out one or two axes, not {tuple(axis_names)}")
    local = min(int(os.environ.get("LOCAL_WORLD_SIZE", n)), n)
    hosts = max(1, n // local)
    if n % hosts:
        raise ValueError(f"{n} ranks do not divide over {hosts} hosts")
    return build_mesh((hosts, n // hosts), axis_names, device)


# ------------------------------------------------------------- tree helpers


def map_leaves(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``tree`` with ``fn(leaf, path)`` on every tensor and numpy array (the
    path of field names and dict keys down to it); anything else (``None``,
    numbers) passes through."""
    if isinstance(tree, (Tensor, np.ndarray)):
        return fn(tree, path)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, x, path + (str(i),)) for i, x in enumerate(tree))
    return tree


def leaves(tree: Any):
    out = []
    map_leaves(lambda x, _: out.append(x), tree)
    return out


def _on(x, device) -> Tensor:
    return torch.as_tensor(x).to(device)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` on this rank's device, broadcast from the
    mesh's first rank (a copy: the caller's tensors are untouched)."""

    def put(x, _):
        t = _on(x, mesh.device).clone()
        dist.broadcast(t, src=0, group=mesh.group)
        return t

    return map_leaves(put, tree)


def rows_of(x, index: int, size: int, device) -> Tensor:
    """Block ``index`` of ``size`` contiguous row blocks of ``x`` on ``device``."""
    t = _on(x, device)
    if t.ndim == 0:
        return t
    if t.shape[0] % size:
        raise ValueError(f"{t.shape[0]} rows do not divide over {size} ranks")
    n = t.shape[0] // size
    return t[index * n:(index + 1) * n].contiguous()


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """This rank's contiguous rows of every leaf of ``batch`` along the
    ``axis`` of the mesh, on its device; a scalar leaf is kept whole."""
    index, size = mesh.axis_index(axis), mesh.axis_size(axis)
    return map_leaves(lambda x, _: rows_of(x, index, size, mesh.device), batch)


# ------------------------------------------------------------- collectives


def all_reduce_mean(tensors: Dict[str, Tensor], group, size: int) -> Dict[str, Tensor]:
    """The mean over the group of a dict of tensors, reduced as one flat
    bucket (one all-reduce)."""
    names = list(tensors)
    dtypes = {tensors[k].dtype for k in names}
    if len(dtypes) != 1:
        raise ValueError(f"one bucket holds one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([tensors[k].reshape(-1) for k in names])
    dist.all_reduce(flat, group=group)
    flat = flat / size
    out, offsets = {}, itertools.accumulate([tensors[k].numel() for k in names], initial=0)
    for k, start in zip(names, offsets):
        out[k] = flat[start:start + tensors[k].numel()].reshape(tensors[k].shape)
    return out


def all_gather_rows(x: Tensor, group, size: int) -> Tensor:
    """The rows of every rank of the group, concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def mean_metrics(metrics: Dict[str, Any], group, size: int) -> Dict[str, Any]:
    """The step's scalar metrics (means over the rank's rows) averaged over
    the group in one all-reduce; a per-row metric gathered in rank order."""
    scalars = {k: v for k, v in metrics.items()
               if isinstance(v, Tensor) and v.ndim == 0 and v.is_floating_point()}
    out = dict(metrics)
    if scalars:
        names = list(scalars)
        stacked = torch.stack([scalars[k] for k in names]).to(torch.float32)
        dist.all_reduce(stacked, group=group)
        stacked = stacked / size
        out.update({k: stacked[i].to(scalars[k].dtype) for i, k in enumerate(names)})
    for k, v in metrics.items():
        if isinstance(v, Tensor) and v.ndim > 0:
            out[k] = all_gather_rows(v, group, size)
    return out


class _ReducedGradients:
    """An update rule whose ``update`` first averages the gradients over a
    process group (one flat all-reduce), then steps as ``rule`` does."""

    def __init__(self, rule: Rule, group, size: int):
        self.rule, self.group, self.size = rule, group, size

    def update(self, grads, state, params):
        return self.rule.update(all_reduce_mean(grads, self.group, self.size), state, params)

    def __getattr__(self, name):
        return getattr(self.rule, name)


def with_reduced_gradients(trainer: Any, group, size: int) -> Any:
    """A shallow copy of ``trainer`` whose every update rule averages its
    gradients over ``group`` first; raises ``ValueError`` for a trainer with
    none."""
    out = copy.copy(trainer)
    rules = [k for k, v in vars(trainer).items() if isinstance(v, Rule)]
    if not rules:
        raise ValueError(f"{type(trainer).__name__} has no update rule whose gradients "
                         "a data-parallel step could reduce")
    for k in rules:
        setattr(out, k, _ReducedGradients(getattr(trainer, k), group, size))
    return out


def make_data_parallel_train_step(trainer: Any, mesh: Mesh, axis: str = "data") -> Callable:
    """``(state, batch) -> (state, metrics)`` with the state replicated
    (``replicate``) and the batch this rank's rows (``shard_batch``); the
    new state is the single-device step's on the whole batch, on every rank."""
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    group, size = mesh.groups[axis], mesh.axis_size(axis)
    if isinstance(trainer, FusedDQNTrainer):
        def fused_step(state, batch):
            whole = map_leaves(lambda x, _: x if x.ndim == 0 else all_gather_rows(
                x, group, size), batch)
            return trainer.train_step(state, whole)

        return fused_step
    reduced = with_reduced_gradients(trainer, group, size)

    def step(state, batch):
        state, metrics = reduced.train_step(state, batch)
        return state, mean_metrics(metrics, group, size)

    return step
