"""Device-resident replay memory: the circular, packed-row and prioritized
buffers and the sum tree."""

from reagent_tpu_torch.replay.circular import ReplayBuffer, ReplayBufferState
from reagent_tpu_torch.replay.packed import PackedReplayBuffer, PackedReplayBufferState
from reagent_tpu_torch.replay.prioritized import (
    PrioritizedReplayBuffer,
    PrioritizedReplayBufferState,
)
from reagent_tpu_torch.replay.sum_tree import SumTree, SumTreeState

__all__ = [
    "PackedReplayBuffer",
    "PackedReplayBufferState",
    "PrioritizedReplayBuffer",
    "PrioritizedReplayBufferState",
    "ReplayBuffer",
    "ReplayBufferState",
    "SumTree",
    "SumTreeState",
]
