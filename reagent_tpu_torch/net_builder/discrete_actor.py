"""Discrete-actor net builders.

Port of ``reagent_tpu/net_builder/discrete_actor.py`` (``FullyConnected``
:13; reference: net_builder/discrete_actor/): a logits network over the
discrete actions, registered in ``DISCRETE_ACTOR_NET_BUILDERS``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import DISCRETE_ACTOR_NET_BUILDERS
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.net_builder.base import state_dim_of


@DISCRETE_ACTOR_NET_BUILDERS.register()
@dataclasses.dataclass
class FullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [128, 64])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])

    def build_actor(
        self,
        state_normalization_data: Optional[NormalizationData],
        num_actions: int,
        state_dim: Optional[int] = None,
    ) -> FullyConnectedDQN:
        return FullyConnectedDQN(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=num_actions,
            sizes=list(self.sizes),
            activations=list(self.activations),
        )
