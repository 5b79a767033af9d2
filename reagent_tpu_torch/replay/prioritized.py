"""Prioritized experience replay (Schaul et al. 2015), on the device.

Port of ``reagent_tpu/replay/prioritized.py`` (reference:
reagent/replay_memory/prioritized_replay_buffer.py:30).  Priorities live in
the state beside the circular buffer's; a new transition takes the largest
priority seen so far (ref :71-75) and is written where the base buffer's
``add`` wrote it, past any stack padding (:72-80).  Sampling is stratified
inverse-CDF over ``priority * is_valid`` (:84-95): one cumsum, one
``searchsorted(side="right")`` of a draw in each of ``batch_size``
equal-mass segments, then ``% capacity``.  The rows come through the base
buffer's ``sample``, so K4 (``ops/nstep_replay.py``) serves their n-step
reward, steps and terminal, and the batch also carries each row's
``sampling_probabilities``.

The draws come from a ``torch.Generator`` on the buffer's device, or are
given (``u``: ``batch_size`` uniforms in [0, 1)), so a caller can feed JAX's.
A float32 cumsum on the card sums in another order than on the CPU, so a
query that lands on a segment's boundary may pick the neighbouring index
there; with priorities whose prefix sums are exact in float32 both pick
the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from reagent_tpu_torch.replay.circular import ReplayBuffer, ReplayBufferState
from reagent_tpu_torch.replay.sum_tree import last_writes

Tensor = torch.Tensor


@dataclasses.dataclass
class PrioritizedReplayBufferState:
    buffer: ReplayBufferState
    priorities: Tensor  # float32 [capacity]
    max_priority: Tensor  # float32 scalar

    @property
    def size(self) -> Tensor:
        return self.buffer.size


class PrioritizedReplayBuffer(ReplayBuffer):
    """The prioritized variant; ``ReplayBuffer``'s API over a wrapped state."""

    def init(self, **example_transition) -> PrioritizedReplayBufferState:  # type: ignore[override]
        return PrioritizedReplayBufferState(
            buffer=super().init(**example_transition),
            priorities=torch.zeros((self.capacity,), dtype=torch.float32, device=self.device),
            max_priority=torch.ones((), dtype=torch.float32, device=self.device))

    def add(  # type: ignore[override]
        self, state: PrioritizedReplayBufferState, priority: Optional[Tensor] = None,
        **transition,
    ) -> PrioritizedReplayBufferState:
        """Append one transition at ``priority`` (the largest seen so far
        by default), writing the state's tensors in place."""
        priority = state.max_priority if priority is None else torch.as_tensor(
            priority, dtype=torch.float32, device=self.device)
        base = super().add(state.buffer, **transition)
        cur = torch.remainder(base.add_count - 1, self.capacity).to(torch.int64).reshape(1)
        state.priorities.index_put_((cur,), priority.reshape(1))
        return PrioritizedReplayBufferState(
            buffer=base, priorities=state.priorities,
            max_priority=torch.maximum(state.max_priority, priority))

    def _mass(self, state: PrioritizedReplayBufferState) -> Tensor:
        return state.priorities * state.buffer.is_valid.to(torch.float32)

    def sample_index_batch_prioritized(
        self, state: PrioritizedReplayBufferState, generator: Optional[torch.Generator],
        batch_size: int, u: Optional[Tensor] = None,
    ) -> Tensor:
        """int32 [batch_size]: one index from each equal-mass segment."""
        csum = torch.cumsum(self._mass(state), dim=0)
        total = csum[-1]
        bounds = torch.arange(batch_size, dtype=torch.float32, device=self.device) / batch_size
        if u is None:
            u = torch.rand((batch_size,), generator=generator, device=self.device)
        q = (bounds + u / batch_size) * total
        idx = torch.searchsorted(csum, q, right=True)
        return torch.remainder(idx, self.capacity).to(torch.int32)

    def sample(  # type: ignore[override]
        self,
        state: PrioritizedReplayBufferState,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        indices: Optional[Tensor] = None,
        u: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        bs = batch_size or self.batch_size
        if indices is None:
            indices = self.sample_index_batch_prioritized(state, generator, bs, u)
        batch = super().sample(state.buffer, generator, bs, indices=indices)
        batch["sampling_probabilities"] = self.sampling_probabilities(state, indices)[:, None]
        return batch

    def sampling_probabilities(self, state: PrioritizedReplayBufferState, indices) -> Tensor:
        """Each index's priority over the valid entries' total (at least
        1e-12)."""
        idx = torch.as_tensor(indices, device=self.device).to(torch.int64)
        return state.priorities[idx] / torch.clamp(torch.sum(self._mass(state)), min=1e-12)

    def set_priority(self, state: PrioritizedReplayBufferState, indices, priorities
                     ) -> PrioritizedReplayBufferState:
        """Write ``priorities`` at ``indices`` (the last write wins on a
        repeated index), in place."""
        indices = torch.as_tensor(indices, device=self.device).to(torch.int64).reshape(-1)
        priorities = torch.as_tensor(priorities, dtype=torch.float32,
                                     device=self.device).reshape(-1)
        keep = last_writes(indices)
        state.priorities.index_put_((indices[keep],), priorities[keep])
        return dataclasses.replace(
            state, max_priority=torch.maximum(state.max_priority, torch.max(priorities)))

    def get_priority(self, state: PrioritizedReplayBufferState, indices) -> Tensor:
        return state.priorities[torch.as_tensor(indices, device=self.device).to(torch.int64)]
