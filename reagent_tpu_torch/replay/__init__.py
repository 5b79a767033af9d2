"""Device-resident replay memory: the circular and the packed-row buffers."""

from reagent_tpu_torch.replay.circular import ReplayBuffer, ReplayBufferState
from reagent_tpu_torch.replay.packed import PackedReplayBuffer, PackedReplayBufferState

__all__ = [
    "PackedReplayBuffer",
    "PackedReplayBufferState",
    "ReplayBuffer",
    "ReplayBufferState",
]
