"""Typed training batches as tensor dataclasses.

Port of the batch types the DQN and actor-critic paths use from
``reagent_tpu/core/types.py`` (``FeatureData`` :179, ``GaussianSamplerScore``
:237, ``ActorOutput`` :246, ``ExtraData`` :255, ``DiscreteDqnInput`` :290,
``ParametricDqnInput`` :315, ``PolicyNetworkInput`` :329,
``PolicyGradientInput`` :338, ``MemoryNetworkInput`` :377,
``MemoryNetworkOutput`` :389).  Fields hold ``torch.Tensor``s (or
``None``); ``.to(device)`` moves every tensor field, recursing into nested
batches.
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
class GaussianSamplerScore(_TensorDataClass):
    """A gaussian policy head's (loc, log-scale) (reference
    reagent/gym/types.py GaussianSamplerScore; JAX types.py:237)."""

    loc: Tensor
    scale_log: Tensor


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


@dataclasses.dataclass
class MemoryNetworkInput(_TensorDataClass):
    """World-model training sequences (reference types.py:1004): every
    leading dim is [seq_len, batch, ...]; ``action`` is a ``FeatureData``."""

    state: FeatureData
    next_state: FeatureData
    reward: Tensor
    time_diff: Optional[Tensor]
    step: Optional[Tensor]
    not_terminal: Tensor
    action: FeatureData = None
    valid_step: Optional[Tensor] = None
    extras: ExtraData = dataclasses.field(default_factory=ExtraData)

    def batch_size(self) -> int:
        return self.state.float_features.shape[0]


@dataclasses.dataclass
class MemoryNetworkOutput(_TensorDataClass):
    """MDN-RNN forward output (reference types.py:1045): the mixture's
    ``mus``/``sigmas`` [T, B, G, S] and ``logpi`` [T, B, G], the reward and
    not-terminal logits [T, B], the last layer's final hidden and cell state
    [B, H] and its hidden state at every step [T, B, H]."""

    mus: Tensor
    sigmas: Tensor
    logpi: Tensor
    reward: Tensor
    not_terminal: Tensor
    last_step_hidden: Tensor
    last_step_cell: Tensor
    all_steps_hidden: Tensor
