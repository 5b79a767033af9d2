"""Slate-reward net builders.

Port of ``reagent_tpu/net_builder/slate_reward.py`` (``SlateRewardGRU`` :23,
``SlateRewardTransformer`` :47; reference net_builder/slate_reward/
slate_reward_gru.py:14-37 and slate_reward_transformer.py:14-41): the nets
of ``models/seq2slate_reward.py`` that predict the reward of a (state,
ranked slate) for Seq2Slate's simulation and reward-model training.
"""

from __future__ import annotations

import dataclasses

from reagent_tpu_torch.core.registry import SLATE_REWARD_NET_BUILDERS
from reagent_tpu_torch.models.seq2slate_reward import (
    Seq2SlateGRURewardNet,
    Seq2SlateTransformerRewardNet,
)


@SLATE_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class SlateRewardGRU:
    dim_model: int = 16
    num_stacked_layers: int = 2
    fit_slate_wise_reward: bool = True

    def build_slate_reward_network(
        self, state_dim: int, candidate_dim: int, candidate_size: int, slate_size: int
    ) -> Seq2SlateGRURewardNet:
        return Seq2SlateGRURewardNet(
            state_dim=state_dim,
            candidate_dim=candidate_dim,
            num_hiddens=self.dim_model,
            num_layers=self.num_stacked_layers,
        )

    @property
    def expect_slate_wise_reward(self) -> bool:
        return self.fit_slate_wise_reward


@SLATE_REWARD_NET_BUILDERS.register()
@dataclasses.dataclass
class SlateRewardTransformer:
    num_heads: int = 2
    dim_model: int = 16
    dim_feedforward: int = 16
    num_stacked_layers: int = 2
    fit_slate_wise_reward: bool = True

    def build_slate_reward_network(
        self, state_dim: int, candidate_dim: int, candidate_size: int, slate_size: int
    ) -> Seq2SlateTransformerRewardNet:
        return Seq2SlateTransformerRewardNet(
            state_dim=state_dim,
            candidate_dim=candidate_dim,
            num_stacked_layers=self.num_stacked_layers,
            num_heads=self.num_heads,
            dim_model=self.dim_model,
            dim_feedforward=self.dim_feedforward,
        )

    @property
    def expect_slate_wise_reward(self) -> bool:
        return self.fit_slate_wise_reward
