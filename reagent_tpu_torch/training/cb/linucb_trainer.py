"""LinUCB contextual-bandit trainer.

Port of ``reagent_tpu/training/cb/linucb_trainer.py`` (reference
reagent/training/cb/linucb_trainer.py:19, arXiv:1003.0146).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from reagent_tpu_torch.core.types import CBInput
from reagent_tpu_torch.models.linear_regression import LinearRegressionUCB, LinUCBState
from reagent_tpu_torch.training.cb.utils import chosen_arm_features

Tensor = torch.Tensor


class LinUCBTrainer:
    """Updates the joint LinUCB regression from logged (context, arm, reward)."""

    def __init__(self, scorer: LinearRegressionUCB):
        self.scorer = scorer

    def init(self, device="cuda") -> LinUCBState:
        return self.scorer.init(device)

    def train_step(self, state: LinUCBState, batch: CBInput
                   ) -> Tuple[LinUCBState, Dict[str, Tensor]]:
        assert batch.action is not None and batch.reward is not None
        state = self.scorer.update(state, chosen_arm_features(batch), batch.reward, batch.weight)
        return state, {"num_obs": state.num_obs}

    def on_epoch_end(self, state: LinUCBState) -> LinUCBState:
        """Solve the coefficients, then discount (ref linucb_trainer.py:92-99)."""
        return self.scorer.apply_discounting(self.scorer.calculate_coefs(state))

    def score(self, state: LinUCBState, batch: CBInput,
              ucb_alpha: Optional[float] = None) -> Tensor:
        """UCB score per arm: [B, num_arms]."""
        B, K, D = batch.context_arm_features.shape
        out = self.scorer.forward(state, batch.context_arm_features.reshape(B * K, D), ucb_alpha)
        return out["ucb"].reshape(B, K)
