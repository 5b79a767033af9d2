"""Disjoint LinUCB trainer: one regression per arm.

Port of ``reagent_tpu/training/cb/disjoint_linucb_trainer.py`` (reference
reagent/training/cb/disjoint_linucb_trainer.py:19).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from reagent_tpu_torch.core.types import CBInput
from reagent_tpu_torch.models.linear_regression import (
    DisjointLinearRegressionUCB,
    DisjointLinUCBState,
)
from reagent_tpu_torch.training.cb.utils import chosen_arm_features

Tensor = torch.Tensor


class DisjointLinUCBTrainer:
    def __init__(self, scorer: DisjointLinearRegressionUCB):
        self.scorer = scorer

    def init(self, device="cuda") -> DisjointLinUCBState:
        return self.scorer.init(device)

    def train_step(self, state: DisjointLinUCBState, batch: CBInput
                   ) -> Tuple[DisjointLinUCBState, Dict[str, Tensor]]:
        assert batch.action is not None and batch.reward is not None
        # the chosen arm's features
        state = self.scorer.update(state, batch.action.reshape(-1), chosen_arm_features(batch),
                                   batch.reward)
        return state, {"num_obs": state.num_obs}

    def on_epoch_end(self, state: DisjointLinUCBState) -> DisjointLinUCBState:
        return self.scorer.calculate_coefs(state)
