"""QR-DQN net builders.

Port of ``reagent_tpu/net_builder/quantile_dqn.py`` (reference:
net_builder/quantile_dqn/).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import QR_DQN_NET_BUILDERS
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.dueling_q_network import DuelingQNetwork
from reagent_tpu_torch.net_builder.base import state_dim_of


@QR_DQN_NET_BUILDERS.register()
@dataclasses.dataclass
class QuantileFullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    num_atoms: int = 51

    def build_q_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        output_dim: int,
        state_dim: Optional[int] = None,
    ) -> FullyConnectedDQN:
        # emits action_dim * num_atoms outputs; the trainer reshapes
        return FullyConnectedDQN(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=output_dim * self.num_atoms,
            sizes=list(self.sizes),
            activations=list(self.activations),
        )


@QR_DQN_NET_BUILDERS.register()
@dataclasses.dataclass
class DuelingQuantile:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    num_atoms: int = 51

    def build_q_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        output_dim: int,
        state_dim: Optional[int] = None,
    ) -> DuelingQNetwork:
        return DuelingQNetwork(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=output_dim,
            layers=list(self.sizes),
            activations=list(self.activations),
            num_atoms=self.num_atoms,
        )
