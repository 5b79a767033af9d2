"""Discrete-DQN net builders.

Port of ``reagent_tpu/net_builder/discrete_dqn.py``: ``FullyConnected`` (:21)
only; ``Dueling`` and ``FullyConnectedWithEmbedding`` wait for later slices
(``ROADMAP.md`` §1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import DISCRETE_DQN_NET_BUILDERS
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.preprocessing.normalization import get_num_output_features


def state_dim_of(
    normalization_data: Optional[NormalizationData], fallback: Optional[int] = None
) -> int:
    if normalization_data is not None and normalization_data.dense_normalization_parameters:
        return get_num_output_features(normalization_data.dense_normalization_parameters)
    if fallback is None:
        raise ValueError("need normalization data or an explicit state_dim")
    return fallback


@DISCRETE_DQN_NET_BUILDERS.register()
@dataclasses.dataclass
class FullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    dropout_ratio: float = 0.0
    use_batch_norm: bool = False

    def build_q_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        output_dim: int,
        state_dim: Optional[int] = None,
    ) -> FullyConnectedDQN:
        return FullyConnectedDQN(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=output_dim,
            sizes=list(self.sizes),
            activations=list(self.activations),
            dropout_ratio=self.dropout_ratio,
            use_batch_norm=self.use_batch_norm,
        )
