"""Typed training batches as tensor dataclasses.

Port of the batch types the DQN and actor-critic paths use from
``reagent_tpu/core/types.py`` (``FeatureData`` :179, ``ActorOutput`` :246,
``ExtraData`` :255, ``DiscreteDqnInput`` :290, ``ParametricDqnInput`` :315,
``PolicyNetworkInput`` :329, ``PolicyGradientInput`` :338).  Fields hold ``torch.Tensor``s (or ``None``); ``.to(device)`` moves
every tensor field, recursing into nested batches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


class _TensorDataClass:
    def to(self, device) -> "_TensorDataClass":
        def move(v):
            if isinstance(v, (Tensor, _TensorDataClass)):
                return v.to(device)
            return v

        return dataclasses.replace(
            self, **{f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )


@dataclasses.dataclass
class FeatureData(_TensorDataClass):
    """Dense features for one entity (reference types.py:314)."""

    float_features: Tensor

    def get_tiled_batch(self, num_tiles: int) -> "FeatureData":
        """Each row repeated ``num_tiles`` times in place, [b, d] -> [b*t, d]
        (``[s0, s0, s1, s1, ...]``, as ``jnp.repeat``; reference
        types.py:350), the layout of max-over-possible-actions Q."""
        return FeatureData(
            float_features=self.float_features.repeat_interleave(num_tiles, dim=0))


@dataclasses.dataclass
class ActorOutput(_TensorDataClass):
    """A sampler's output (reference types.py:247)."""

    action: Tensor
    log_prob: Optional[Tensor] = None
    squashed_mean: Optional[Tensor] = None


@dataclasses.dataclass
class ExtraData(_TensorDataClass):
    """Logged metadata riding alongside a batch (reference types.py:442)."""

    mdp_id: Optional[Tensor] = None
    sequence_number: Optional[Tensor] = None
    action_probability: Optional[Tensor] = None
    max_num_actions: Optional[int] = None
    metrics: Optional[Tensor] = None


@dataclasses.dataclass
class DiscreteDqnInput(_TensorDataClass):
    """Reference types.py:774.  ``action`` is one-hot [b, num_actions]."""

    state: FeatureData
    next_state: FeatureData
    reward: Tensor
    time_diff: Optional[Tensor]
    step: Optional[Tensor]
    not_terminal: Tensor
    action: Tensor = None
    next_action: Tensor = None
    possible_actions_mask: Tensor = None
    possible_next_actions_mask: Tensor = None
    extras: ExtraData = dataclasses.field(default_factory=ExtraData)


@dataclasses.dataclass
class ParametricDqnInput(_TensorDataClass):
    """Reference types.py:868: actions are feature vectors.  The possible
    actions are ``[b * max_num_actions, action_dim]``, row ``i * M + j``
    the j-th possible action of row i."""

    state: FeatureData
    next_state: FeatureData
    reward: Tensor
    time_diff: Optional[Tensor]
    step: Optional[Tensor]
    not_terminal: Tensor
    action: FeatureData = None
    next_action: FeatureData = None
    possible_actions: FeatureData = None
    possible_actions_mask: Tensor = None
    possible_next_actions: FeatureData = None
    possible_next_actions_mask: Tensor = None
    extras: Optional[ExtraData] = None
    weight: Optional[Tensor] = None


@dataclasses.dataclass
class PolicyNetworkInput(_TensorDataClass):
    """Continuous-control transition batch (reference types.py:901):
    ``action`` and ``next_action`` hold the dense action features."""

    state: FeatureData
    next_state: FeatureData
    reward: Tensor
    time_diff: Optional[Tensor]
    step: Optional[Tensor]
    not_terminal: Tensor
    action: FeatureData = None
    next_action: FeatureData = None
    extras: ExtraData = dataclasses.field(default_factory=ExtraData)


@dataclasses.dataclass
class PolicyGradientInput(_TensorDataClass):
    """One full episode, padded to a fixed length (reference types.py:920).

    ``action`` is one-hot [T, num_actions]; ``reward`` and ``log_prob`` are
    [T].  ``valid_mask`` [T] marks the real steps of an episode padded to
    ``max_steps`` (the JAX package's static shapes, kept so an episode stays
    on the device); None means every step is real."""

    state: FeatureData
    action: Tensor
    reward: Tensor
    log_prob: Tensor
    possible_actions_mask: Optional[Tensor] = None
    valid_mask: Optional[Tensor] = None

    def batch_size(self) -> int:
        return self.state.float_features.shape[0]
