"""Device-resident multi-step training loops.

Port of ``reagent_tpu/training/scan_loop.py``.  The offline workflow builds
one minibatch per train step on the host; these loops instead keep the
(preprocessed) training table on the device and run K train steps on
minibatches gathered from it there.  Where JAX compiles a ``lax.scan``,
PyTorch runs eagerly: each loop is a plain Python loop over device tensors
that reads no value on the host, so the host only enqueues work and touches
the result once per K steps.  Indices come from ``torch.randint`` with an
explicit generator on the dataset's device, and the metrics come back
stacked ``[K]`` on the device.

Works with any trainer exposing the standard two-argument
``train_step(state, batch) -> (state, metrics)`` (``DQNTrainer``,
``QRDQNTrainer``, ``FusedDQNTrainer``); other signatures are rejected with a
clear error.  Semantics are exactly K sequential ``train_step`` calls.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional

import torch

Tensor = torch.Tensor


def _raw_train_step(trainer: Any) -> Callable:
    """The class's ``train_step``, after checking that it has the standard
    ``(self, state, batch)`` form."""
    raw = type(trainer).train_step
    params = [
        p
        for p in inspect.signature(raw).parameters.values()
        if p.default is inspect.Parameter.empty
        and p.kind
        in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]
    if len(params) != 3:  # self, state, batch
        raise TypeError(
            f"{type(trainer).__name__}.train_step has signature "
            f"{inspect.signature(raw)}; the scan loop needs the standard "
            "(state, batch) -> (state, metrics) form"
        )
    return raw


def tree_leaves(tree: Any) -> List[Tensor]:
    """The tensors of a batch (dataclasses, dicts, tuples and lists of
    tensors), in field order."""
    if isinstance(tree, Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return []


def tree_map(fn: Callable[[Tensor], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every tensor; anything else (``None``,
    numbers) is passed through."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                     for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def stack_metrics(per_step: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    """K per-step metric dicts as one dict of ``[K, ...]`` device tensors."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def check_num_steps(num_steps: int) -> None:
    """Refuse a loop of fewer than one step.  JAX's length-0 ``lax.scan``
    returns the state and ``(0,)`` metrics; the port learns a step's metric
    keys only by running one, so it raises instead."""
    if num_steps < 1:
        raise ValueError(f"a training loop needs at least one step, got num_steps={num_steps}")


def run_sampled_steps(
    step: Callable, state: Any, batch_of: Callable[[Tensor], Any], num_steps: int,
    minibatch_size: int, num_rows: int, generator: torch.Generator,
):
    """``num_steps`` calls of ``step(state, batch_of(idx))``, each on
    ``minibatch_size`` row indices drawn uniformly with replacement from
    ``[0, num_rows)`` on the generator's device; no host read."""
    check_num_steps(num_steps)
    per_step = []
    for _ in range(num_steps):
        idx = torch.randint(
            0, num_rows, (minibatch_size,), generator=generator, device=generator.device)
        state, m = step(state, batch_of(idx))
        per_step.append(m)
    return state, stack_metrics(per_step)


def make_scanned_train_fn(trainer: Any) -> Callable:
    """``(state, batches) -> (state, metrics)`` running one train step per
    leading-axis slice of ``batches``.

    ``batches`` is any batch whose tensors carry a leading ``[K, ...]`` axis
    (K stacked minibatches).  ``metrics`` leaves are ``[K]``-stacked.
    """
    raw_step = _raw_train_step(trainer)

    def run(state, batches):
        num_steps = tree_leaves(batches)[0].shape[0]
        check_num_steps(num_steps)
        per_step = []
        for k in range(num_steps):
            state, m = raw_step(trainer, state, tree_map(lambda x: x[k], batches))
            per_step.append(m)
        return state, stack_metrics(per_step)

    return run


def make_sampled_train_fn(
    trainer: Any,
    dataset: Any,
    minibatch_size: int,
    num_steps: int,
    num_rows: Optional[int] = None,
    allow_static_leaves: bool = False,
) -> Callable:
    """``(state, generator) -> (state, metrics)``: ``num_steps`` train steps,
    each on a uniformly sampled minibatch gathered from the device-resident
    ``dataset`` (a batch with leading axis ``[N, ...]``).  ``generator`` is a
    ``torch.Generator`` on the dataset's device.

    The equivalent of the reference's ``OfflineReplayBufferDataset`` epoch
    (gym/datasets/replay_buffer_dataset.py:150-206): sample-with-replacement
    minibatches over a fixed corpus.
    """
    raw_step = _raw_train_step(trainer)
    check_num_steps(num_steps)
    leaves = tree_leaves(dataset)
    if num_rows is None:
        num_rows = leaves[0].shape[0]

    # every batched tensor must be per-row ([num_rows, ...]); 0-d tensors and
    # (with allow_static_leaves) fixed per-dataset tensors such as a [D]
    # normalization vector are passed through whole instead of gathered
    def is_static(x: Tensor) -> bool:
        return x.ndim < 1 or (allow_static_leaves and x.shape[0] != num_rows)

    bad = [
        (i, tuple(x.shape))
        for i, x in enumerate(leaves)
        if x.ndim >= 1 and x.shape[0] != num_rows and not allow_static_leaves
    ]
    if bad:
        raise ValueError(
            f"dataset leaves {bad} do not have leading dim num_rows={num_rows}; "
            "every batched leaf must be stacked per-row for minibatch "
            "gathering (pass allow_static_leaves=True to carry fixed "
            "per-dataset arrays through whole)"
        )

    def gather(idx):
        return tree_map(lambda x: x if is_static(x) else x[idx], dataset)

    def run(state, generator):
        return run_sampled_steps(
            lambda s, b: raw_step(trainer, s, b), state, gather, num_steps,
            minibatch_size, num_rows, generator)

    return run
