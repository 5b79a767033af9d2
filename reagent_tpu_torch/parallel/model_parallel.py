"""Model-parallel embedding tables composed with data parallelism.

Port of ``reagent_tpu/parallel/model_parallel.py`` (``make_2d_mesh`` :28,
``embedding_specs`` :54, ``shard_state`` :71, ``make_model_parallel_train_step``
:79-116).  The embedding tables are sharded by row over a ``model`` axis,
the dense trunk is replicated and the batch is sharded over the ``data``
axis of a 2-D (data, model) mesh.  JAX's SPMD partitioner inserts the
gather and the psum of the sharded lookups; here each ``EmbeddingBag`` of
the trainer's networks looks up this rank's block of rows during the step
(``models/embedding_bag.py``: ids hashed or clamped against the global
size, an id outside the block contributes zero, the pooled sums all-reduced
over the model group with an identity backward, a mean divided by the
global count).  Every state leaf whose path holds ``embedding`` (the
parameters, the targets, the Adam moments) keeps this model rank's rows, so
the optimizer's update is shard-local.  The gradients, the table's included,
are averaged over the data group only: the model ranks of a data group
compute the same dense gradients.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from reagent_tpu_torch.models.embedding_bag import EmbeddingBag, RowShard
from reagent_tpu_torch.parallel.data_parallel import (
    Mesh,
    build_mesh,
    map_leaves,
    mean_metrics,
    with_reduced_gradients,
)

EMBEDDING_PARAM_NAME = "embedding"


def make_2d_mesh(n_devices: Optional[int] = None, data_parallel: Optional[int] = None,
                 axis_names: Sequence[str] = ("data", "model"), device="cuda") -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` ranks;
    ``data_parallel`` defaults to half of them (at least 1)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    dp = data_parallel if data_parallel is not None else max(1, n // 2)
    if n % dp:
        raise ValueError(f"{n} devices not divisible by data_parallel={dp}")
    return build_mesh((dp, n // dp), axis_names, device)


def _is_embedding_path(path) -> bool:
    return any(EMBEDDING_PARAM_NAME in str(k).split(".") for k in path)


def _is_table(path, x) -> bool:
    return _is_embedding_path(path) and x.ndim >= 2


def embedding_specs(tree: Any, model_axis: str = "model") -> Any:
    """The tree with each tensor's placement: ``(model_axis, None, ...)`` for
    a table's rows sharded over the model axis, ``()`` for replicated.  The
    optimizer's moments mirror the parameters' names, so their tables are
    sharded alike."""
    return map_leaves(lambda x, path: (model_axis, *[None] * (x.ndim - 1))
                      if _is_table(path, x) else (), tree)


def _table_rows(table_size: int, size: int) -> int:
    if table_size % size:
        raise ValueError(f"a table of {table_size} rows does not divide over {size} model ranks")
    return table_size // size


def shard_state(state: Any, mesh: Mesh, model_axis: str = "model") -> Any:
    """This rank's piece of the trainer state, on its device: each table
    leaf's block of rows for this rank's model index, every other leaf
    whole.  Every rank passes the same state (one init, as JAX's one
    controller places one state)."""
    index, size = mesh.axis_index(model_axis), mesh.axis_size(model_axis)

    def put(x, path):
        t = torch.as_tensor(x).to(mesh.device)
        if not _is_table(path, t):
            return t.clone()
        rows = _table_rows(t.shape[0], size)
        return t[index * rows:(index + 1) * rows].clone()

    return map_leaves(put, state)


def embedding_bags(trainer: Any):
    """The ``EmbeddingBag``s of the trainer's networks, each once."""
    seen = {}
    for value in vars(trainer).values():
        if isinstance(value, nn.Module):
            for m in value.modules():
                if isinstance(m, EmbeddingBag):
                    seen[id(m)] = m
    return list(seen.values())


@contextlib.contextmanager
def sharded_lookups(bags, index: int, size: int, group):
    """Every bag looks up rows ``[index * rows, (index + 1) * rows)`` of its
    table and sums over ``group`` inside the block."""
    try:
        for bag in bags:
            rows = _table_rows(bag.table_size, size)
            bag.row_shard = RowShard(start=index * rows, rows=rows, group=group)
        yield
    finally:
        for bag in bags:
            bag.row_shard = None


def make_model_parallel_train_step(trainer: Any, mesh: Mesh, data_axis: str = "data",
                                   model_axis: str = "model") -> Callable:
    """``(state, batch) -> (state, metrics)`` on a (data, model) mesh: the
    state from ``shard_state``, the batch this rank's rows over the data
    axis (``shard_batch``).  The new state's tables are this rank's rows of
    the single-device step's, the rest the single-device step's."""
    data_group, data_size = mesh.groups[data_axis], mesh.axis_size(data_axis)
    model_group, model_size = mesh.groups[model_axis], mesh.axis_size(model_axis)
    model_index = mesh.axis_index(model_axis)
    reduced = with_reduced_gradients(trainer, data_group, data_size)
    bags = embedding_bags(trainer)

    def step(state, batch):
        with sharded_lookups(bags, model_index, model_size, model_group):
            state, metrics = reduced.train_step(state, batch)
        return state, mean_metrics(metrics, data_group, data_size)

    return step
