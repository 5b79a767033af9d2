"""Functional sum tree for prioritized sampling.

Port of ``reagent_tpu/replay/sum_tree.py`` (reference:
reagent/replay_memory/sum_tree.py:30).  The tree is a tuple of per-level
tensors on the device (``levels[0]`` the leaves, padded to a power of two;
``levels[-1]`` the root); ``set`` scatters the leaves and rebuilds every
level by pairwise sums, and a query descends the levels for a whole batch
at once.  Where the JAX functions take a key, these take a
``torch.Generator`` or the uniforms themselves (``u``), so a caller can feed
JAX's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from reagent_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class SumTreeState:
    levels: Tuple[Tensor, ...]  # levels[0] = leaves [L], levels[-1] = root [1]

    @property
    def leaves(self) -> Tensor:
        return self.levels[0]

    @property
    def total(self) -> Tensor:
        return self.levels[-1][0]


def _rebuild_from(leaves: Tensor) -> Tuple[Tensor, ...]:
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = cur.reshape(-1, 2).sum(dim=1)
        levels.append(cur)
    return tuple(levels)


def last_writes(indices: Tensor) -> Tensor:
    """Mask of the entries of ``indices`` that no later entry repeats, so
    that a scatter of the kept ones is the last write to each index on any
    device (a CUDA ``index_put_`` of repeated indices keeps any of them)."""
    same = indices[:, None] == indices[None, :]
    return ~torch.triu(same, diagonal=1).any(dim=1)


class SumTree:
    """Static configuration + pure ops over ``SumTreeState``."""

    def __init__(self, capacity: int, device="cuda"):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = int(capacity)
        self._leaf_count = 1 << int(math.ceil(math.log2(max(capacity, 1))))
        self.device = resolve_device(device)

    @property
    def capacity(self) -> int:
        return self._capacity

    def init(self) -> SumTreeState:
        return SumTreeState(levels=_rebuild_from(
            torch.zeros(self._leaf_count, dtype=torch.float32, device=self.device)))

    def set(self, state: SumTreeState, indices, values) -> SumTreeState:
        """Batched priority write (the last write wins on a repeated index)."""
        indices = torch.atleast_1d(torch.as_tensor(indices, device=self.device)).to(torch.int64)
        values = torch.broadcast_to(torch.atleast_1d(torch.as_tensor(
            values, dtype=torch.float32, device=self.device)), indices.shape)
        keep = last_writes(indices)
        leaves = state.leaves.clone()
        leaves[indices[keep]] = values[keep]
        return SumTreeState(levels=_rebuild_from(leaves))

    def get(self, state: SumTreeState, indices) -> Tensor:
        return state.leaves[torch.as_tensor(indices, device=self.device).to(torch.int64)]

    def sample_from_query(self, state: SumTreeState, query: Tensor) -> Tensor:
        """Descend the tree for each query value in [0, total)."""
        query = torch.as_tensor(query, dtype=torch.float32, device=self.device)
        idx = torch.zeros(query.shape, dtype=torch.int64, device=self.device)
        for level in reversed(range(len(state.levels) - 1)):
            left = state.levels[level][2 * idx]
            go_right = query >= left
            query = torch.where(go_right, query - left, query)
            idx = 2 * idx + go_right.to(torch.int64)
        return torch.clamp(idx, max=self._capacity - 1).to(torch.int32)

    def sample(self, state: SumTreeState, generator: Optional[torch.Generator] = None,
               shape=(), u: Optional[Tensor] = None) -> Tensor:
        """Indices in proportion to their priority; ``u`` uniforms in [0, 1)
        of ``shape``, drawn from ``generator`` where not given."""
        if u is None:
            u = torch.rand(shape, generator=generator, device=self.device)
        return self.sample_from_query(state, u * state.total)

    def stratified_sample(self, state: SumTreeState, generator: Optional[torch.Generator] = None,
                          batch_size: int = 1, u: Optional[Tensor] = None) -> Tensor:
        """One sample per equal-mass segment (reference sum_tree.py:133)."""
        if u is None:
            u = torch.rand((batch_size,), generator=generator, device=self.device)
        bounds = torch.arange(batch_size, dtype=torch.float32, device=self.device) / batch_size
        q = (bounds + u / batch_size) * state.total
        return self.sample_from_query(state, q)
