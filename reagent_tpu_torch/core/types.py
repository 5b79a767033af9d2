"""Typed training batches as tensor dataclasses.

Port of the batch types the DQN paths use from ``reagent_tpu/core/types.py``
(``FeatureData`` :179, ``ActorOutput`` :246, ``ExtraData`` :255,
``DiscreteDqnInput`` :290).  Fields hold ``torch.Tensor``s (or ``None``);
``.to(device)`` moves every tensor field, recursing into nested batches.
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
