"""Continuous-actor net builders.

Port of ``reagent_tpu/net_builder/continuous_actor.py``
(``GaussianFullyConnected`` :20, ``FullyConnected`` :43,
``DirichletFullyConnected`` :68; reference: net_builder/continuous_actor/).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import CONTINUOUS_ACTOR_NET_BUILDERS
from reagent_tpu_torch.models.actor import (
    DirichletFullyConnectedActor,
    FullyConnectedActor,
    GaussianFullyConnectedActor,
)
from reagent_tpu_torch.net_builder.base import state_dim_of


@CONTINUOUS_ACTOR_NET_BUILDERS.register()
@dataclasses.dataclass
class GaussianFullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [128, 64])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    use_layer_norm: bool = False

    def build_actor(
        self,
        state_normalization_data: Optional[NormalizationData],
        action_normalization_data: Optional[NormalizationData],
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
    ) -> GaussianFullyConnectedActor:
        return GaussianFullyConnectedActor(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=state_dim_of(action_normalization_data, action_dim),
            sizes=list(self.sizes),
            activations=list(self.activations),
            use_layer_norm=self.use_layer_norm,
        )


@CONTINUOUS_ACTOR_NET_BUILDERS.register()
@dataclasses.dataclass
class FullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [128, 64])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    action_activation: str = "tanh"
    exploration_variance: Optional[float] = None

    def build_actor(
        self,
        state_normalization_data: Optional[NormalizationData],
        action_normalization_data: Optional[NormalizationData],
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
    ) -> FullyConnectedActor:
        return FullyConnectedActor(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=state_dim_of(action_normalization_data, action_dim),
            sizes=list(self.sizes),
            activations=list(self.activations),
            action_activation=self.action_activation,
            exploration_variance=self.exploration_variance,
        )


@CONTINUOUS_ACTOR_NET_BUILDERS.register()
@dataclasses.dataclass
class DirichletFullyConnected:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [128, 64])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])

    def build_actor(
        self,
        state_normalization_data: Optional[NormalizationData],
        action_normalization_data: Optional[NormalizationData],
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
    ) -> DirichletFullyConnectedActor:
        return DirichletFullyConnectedActor(
            state_dim=state_dim_of(state_normalization_data, state_dim),
            action_dim=state_dim_of(action_normalization_data, action_dim),
            sizes=list(self.sizes),
            activations=list(self.activations),
        )
