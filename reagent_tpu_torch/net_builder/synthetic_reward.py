"""Synthetic-reward net builders.

Port of ``reagent_tpu/net_builder/synthetic_reward.py`` (the six builders
:21-207; reference net_builder/synthetic_reward/): each builds a
``SyntheticRewardNet`` (``SyntheticRewardSparseArchNet`` for the sparse
arch) over the normalized state width and the action width, the number of
discrete action names where they are given.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from reagent_tpu_torch.core.parameters import NormalizationData
from reagent_tpu_torch.core.registry import SYNTHETIC_REWARD_NET_BUILDERS
from reagent_tpu_torch.models.synthetic_reward import (
    NGramConvolutionalNetwork,
    NGramFullyConnectedNetwork,
    SequenceSyntheticRewardNet,
    SingleStepSyntheticRewardNet,
    SyntheticRewardNet,
    TransformerSyntheticRewardNet,
)
from reagent_tpu_torch.models.synthetic_reward_sparse import (
    SparseArchSyntheticRewardNet,
    SyntheticRewardSparseArchNet,
)
from reagent_tpu_torch.net_builder.base import state_dim_of


def _dims(state_normalization_data, action_normalization_data, discrete_action_names,
          state_dim, action_dim):
    sd = state_dim_of(state_normalization_data, state_dim)
    ad = (len(discrete_action_names) if discrete_action_names
          else state_dim_of(action_normalization_data, action_dim))
    return sd, ad


@SYNTHETIC_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class SingleStepSyntheticReward:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [64, 32])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    last_layer_activation: str = "linear"

    def build_synthetic_reward_network(
        self,
        state_normalization_data: Optional[NormalizationData],
        action_normalization_data: Optional[NormalizationData] = None,
        discrete_action_names: Optional[List[str]] = None,
        state_dim: Optional[int] = None,
        action_dim: Optional[int] = None,
    ) -> SyntheticRewardNet:
        sd, ad = _dims(state_normalization_data, action_normalization_data,
                       discrete_action_names, state_dim, action_dim)
        return SyntheticRewardNet(SingleStepSyntheticRewardNet(
            state_dim=sd, action_dim=ad, sizes=list(self.sizes),
            activations=list(self.activations),
            last_layer_activation=self.last_layer_activation))


@SYNTHETIC_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class NGramSyntheticReward:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [64, 32])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    context_size: int = 3
    last_layer_activation: str = "linear"

    def build_synthetic_reward_network(
        self, state_normalization_data=None, action_normalization_data=None,
        discrete_action_names=None, state_dim=None, action_dim=None,
    ) -> SyntheticRewardNet:
        sd, ad = _dims(state_normalization_data, action_normalization_data,
                       discrete_action_names, state_dim, action_dim)
        return SyntheticRewardNet(NGramFullyConnectedNetwork(
            state_dim=sd, action_dim=ad, sizes=list(self.sizes),
            activations=list(self.activations), context_size=self.context_size,
            last_layer_activation=self.last_layer_activation))


@SYNTHETIC_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class NGramConvNetSyntheticReward:
    sizes: List[int] = dataclasses.field(default_factory=lambda: [64, 32])
    activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    context_size: int = 3
    conv_dims: List[int] = dataclasses.field(default_factory=lambda: [32])
    conv_height_kernels: List[int] = dataclasses.field(default_factory=lambda: [2])
    last_layer_activation: str = "linear"

    def build_synthetic_reward_network(
        self, state_normalization_data=None, action_normalization_data=None,
        discrete_action_names=None, state_dim=None, action_dim=None,
    ) -> SyntheticRewardNet:
        sd, ad = _dims(state_normalization_data, action_normalization_data,
                       discrete_action_names, state_dim, action_dim)
        return SyntheticRewardNet(NGramConvolutionalNetwork(
            state_dim=sd, action_dim=ad, sizes=list(self.sizes),
            activations=list(self.activations), context_size=self.context_size,
            conv_dims=tuple(self.conv_dims), conv_height_kernels=tuple(self.conv_height_kernels),
            last_layer_activation=self.last_layer_activation))


@SYNTHETIC_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class SequenceSyntheticReward:
    lstm_hidden_size: int = 64
    lstm_num_layers: int = 1
    last_layer_activation: str = "linear"

    def build_synthetic_reward_network(
        self, state_normalization_data=None, action_normalization_data=None,
        discrete_action_names=None, state_dim=None, action_dim=None,
    ) -> SyntheticRewardNet:
        sd, ad = _dims(state_normalization_data, action_normalization_data,
                       discrete_action_names, state_dim, action_dim)
        return SyntheticRewardNet(SequenceSyntheticRewardNet(
            state_dim=sd, action_dim=ad, lstm_hidden_size=self.lstm_hidden_size,
            lstm_num_layers=self.lstm_num_layers,
            last_layer_activation=self.last_layer_activation))


@SYNTHETIC_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class TransformerSyntheticReward:
    d_model: int = 64
    nhead: int = 1
    num_encoder_layers: int = 2
    dim_feedforward: int = 128
    last_layer_activation: str = "linear"

    def build_synthetic_reward_network(
        self, state_normalization_data=None, action_normalization_data=None,
        discrete_action_names=None, state_dim=None, action_dim=None,
    ) -> SyntheticRewardNet:
        sd, ad = _dims(state_normalization_data, action_normalization_data,
                       discrete_action_names, state_dim, action_dim)
        return SyntheticRewardNet(TransformerSyntheticRewardNet(
            state_dim=sd, action_dim=ad, d_model=self.d_model, nhead=self.nhead,
            num_encoder_layers=self.num_encoder_layers, dim_feedforward=self.dim_feedforward,
            last_layer_activation=self.last_layer_activation))


@SYNTHETIC_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class SparseArchSyntheticReward:
    dense_sizes: List[int] = dataclasses.field(default_factory=lambda: [64, 16])
    dense_activations: List[str] = dataclasses.field(default_factory=lambda: ["relu", "relu"])
    overall_sizes: List[int] = dataclasses.field(default_factory=lambda: [32])
    overall_activations: List[str] = dataclasses.field(default_factory=lambda: ["relu"])
    embedding_configs: List[List] = dataclasses.field(default_factory=list)
    last_layer_activation: str = "sigmoid"

    def build_synthetic_reward_network(
        self, state_normalization_data=None, action_normalization_data=None,
        discrete_action_names=None, state_dim=None, action_dim=None,
    ) -> SyntheticRewardSparseArchNet:
        sd, ad = _dims(state_normalization_data, action_normalization_data,
                       discrete_action_names, state_dim, action_dim)
        return SyntheticRewardSparseArchNet(SparseArchSyntheticRewardNet(
            state_dim=sd, action_dim=ad, dense_sizes=list(self.dense_sizes),
            dense_activations=list(self.dense_activations),
            overall_sizes=list(self.overall_sizes),
            overall_activations=list(self.overall_activations),
            embedding_configs=tuple(tuple(c) for c in self.embedding_configs),
            last_layer_activation=self.last_layer_activation))
