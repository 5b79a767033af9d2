"""Value-network net builders.

Port of ``reagent_tpu/net_builder/value.py``: ``Seq2RewardNetBuilder``
(:16; reference net_builder/value/seq2reward_rnn.py:14-33) and
``FullyConnected`` (:40; reference net_builder/value/fully_connected.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import VALUE_NET_BUILDERS
from reagent_tpu_torch.models.seq2reward_model import Seq2RewardNetwork
from reagent_tpu_torch.models.value import ValueNetwork
from reagent_tpu_torch.net_builder.base import state_dim_of


@VALUE_NET_BUILDERS.register()
@dataclasses.dataclass
class Seq2RewardNetBuilder:
    """Builds the Seq2Reward LSTM value net."""

    action_dim: int = 2
    num_hiddens: int = 64
    num_hidden_layers: int = 2

    def build_value_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        state_dim: Optional[int] = None,
    ) -> Seq2RewardNetwork:
        return Seq2RewardNetwork(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=self.action_dim,
            num_hiddens=self.num_hiddens,
            num_hidden_layers=self.num_hidden_layers,
        )


@VALUE_NET_BUILDERS.register()
@dataclasses.dataclass
class FullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [128, 64])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])

    def build_value_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        state_dim: Optional[int] = None,
    ) -> ValueNetwork:
        return ValueNetwork(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            sizes=list(self.sizes),
            activations=list(self.activations),
        )
