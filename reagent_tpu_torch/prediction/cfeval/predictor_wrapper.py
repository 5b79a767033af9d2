"""Counterfactual-evaluation serving wrapper: per-action reward predictions
and a mask.

Port of ``reagent_tpu/prediction/cfeval/predictor_wrapper.py`` (:16-32;
reference reagent/prediction/cfeval/predictor_wrapper.py:16-44): wraps a
reward model with a DQN-shaped head over the actions and returns
``(predictions [B, A], ones uint8 [B, A])``.  A prediction of another shape
raises ``ValueError``, where JAX asserts.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from reagent_tpu_torch.prediction.predictor_wrapper import DiscreteDqnWithPreprocessor

Tensor = torch.Tensor


class BanditRewardNetPredictorWrapper:
    def __init__(self, reward_model_with_preprocessor: DiscreteDqnWithPreprocessor,
                 action_names: List[str]) -> None:
        self.reward_model_with_preprocessor = reward_model_with_preprocessor
        self.action_names = list(action_names)

    def __call__(self, values: Tensor, presence: Tensor) -> Tuple[Tensor, Tensor]:
        preds = self.reward_model_with_preprocessor(values, presence)
        B, A = preds.shape[0], len(self.action_names)
        if tuple(preds.shape) != (B, A):
            raise ValueError(f"Invalid shape {tuple(preds.shape)} != ({B}, {A})")
        return preds, torch.ones_like(preds, dtype=torch.uint8)
