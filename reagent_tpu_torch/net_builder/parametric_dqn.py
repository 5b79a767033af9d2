"""Parametric-DQN net builders: the critic Q(s, a) of the actor-critic
managers.

Port of ``reagent_tpu/net_builder/parametric_dqn.py:16`` (reference:
net_builder/parametric_dqn/).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import PARAMETRIC_DQN_NET_BUILDERS
from reagent_tpu_torch.models.critic import FullyConnectedCritic
from reagent_tpu_torch.net_builder.base import state_dim_of


@PARAMETRIC_DQN_NET_BUILDERS.register()
@dataclasses.dataclass
class FullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [128, 64])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    use_batch_norm: bool = False
    use_layer_norm: bool = False

    def build_q_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        action_normalization_data: Optional[NormalizationData],
        output_dim: int = 1,
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
    ) -> FullyConnectedCritic:
        return FullyConnectedCritic(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=state_dim_of(action_normalization_data, action_dim),
            sizes=list(self.sizes),
            activations=list(self.activations),
            use_batch_norm=self.use_batch_norm,
            use_layer_norm=self.use_layer_norm,
            output_dim=output_dim,
        )
