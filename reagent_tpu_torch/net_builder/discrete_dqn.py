"""Discrete-DQN net builders.

Port of ``reagent_tpu/net_builder/discrete_dqn.py``: ``FullyConnected`` (:21),
``Dueling`` (:47) and ``FullyConnectedWithEmbedding`` (:65).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import DISCRETE_DQN_NET_BUILDERS
from reagent_tpu_torch.models.dqn import FullyConnectedDQN
from reagent_tpu_torch.models.dueling_q_network import DuelingQNetwork
from reagent_tpu_torch.models.embedding_bag import SparseDQN
from reagent_tpu_torch.net_builder.base import state_dim_of


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


@DISCRETE_DQN_NET_BUILDERS.register()
@dataclasses.dataclass
class Dueling:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])

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
        )


@DISCRETE_DQN_NET_BUILDERS.register()
@dataclasses.dataclass
class FullyConnectedWithEmbedding:
    """Dense and sparse (ID-list) state features -> Q-values: a
    ``SparseDQN`` (reference
    net_builder/discrete_dqn/fully_connected_with_embedding.py).

    ``embedding_configs``: one (name, table_size, embedding_dim) per sparse
    feature; the overarch is ``sizes`` with the first activation on every
    hidden layer, as JAX's builder builds it."""

    sizes: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    embedding_configs: List[List] = dataclasses.field(default_factory=list)

    def build_q_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        output_dim: int,
        state_dim: Optional[int] = None,
    ) -> SparseDQN:
        return SparseDQN(
            state_dense_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=output_dim,
            configs=tuple(tuple(c) for c in self.embedding_configs),
            overarch_dims=list(self.sizes),
            activation=self.activations[0] if self.activations else "relu",
        )
