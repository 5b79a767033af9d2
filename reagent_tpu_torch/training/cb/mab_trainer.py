"""MAB trainer: CBInput batches into a MAB algorithm's state.

Port of ``reagent_tpu/training/cb/mab_trainer.py`` (reference
reagent/training/cb/mab_trainer.py:12-28): a CB trainer whose step is the
closed-form MAB update, per-arm sums through a one-hot product.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from reagent_tpu_torch.core.types import CBInput
from reagent_tpu_torch.mab.mab_algorithm import MABAlgo, MABState

Tensor = torch.Tensor


class MABTrainer:
    def __init__(self, scorer: MABAlgo):
        assert isinstance(scorer, MABAlgo)
        self.scorer = scorer

    def init(self, device="cuda") -> MABState:
        return self.scorer.init(device)

    def train_step(self, state: MABState, batch: CBInput) -> Tuple[MABState, Dict[str, Tensor]]:
        """Fold the batch's (action [B, 1], reward [B, 1], weight) into the
        per-arm sums."""
        assert batch.action is not None and batch.reward is not None
        rewards = batch.reward.reshape(-1)
        weight = batch.weight.reshape(-1) if batch.weight is not None else torch.ones_like(rewards)
        onehot = F.one_hot(batch.action.reshape(-1).to(torch.int64),
                           self.scorer.n_arms).to(rewards.dtype)
        state = self.scorer.add_batch_observations(
            state,
            n_obs_per_arm=torch.sum(onehot * weight[:, None], dim=0),
            sum_reward_per_arm=torch.sum(onehot * (weight * rewards)[:, None], dim=0),
            sum_reward_squared_per_arm=torch.sum(onehot * (weight * rewards ** 2)[:, None], dim=0),
        )
        return state, {"num_obs": state.total_n_obs_per_arm.sum()}

    def score(self, state: MABState, draws: Optional[Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tensor:
        return self.scorer.get_scores(state, draws, generator)
