"""CB offline-evaluation helpers.

Port of ``reagent_tpu/evaluation/cb/utils.py`` (reference
reagent/evaluation/cb/utils.py:9-47).
"""

from __future__ import annotations

from typing import Optional

import torch

from reagent_tpu_torch.core.types import CBInput

Tensor = torch.Tensor


def add_importance_weights(batch: CBInput, model_actions: Tensor,
                           max_importance_weight: Optional[float] = None) -> CBInput:
    """Zero weight where the logged action differs from the model's; 1 /
    p_logged elsewhere (the logged log-prob, else 1 / the slate size from
    ``arm_presence`` or the number of arms), clipped at
    ``max_importance_weight``."""
    logged_actions = batch.action
    assert logged_actions is not None
    assert logged_actions.shape == model_actions.shape, (logged_actions.shape,
                                                         model_actions.shape)
    if batch.log_prob is not None:
        logged_action_prob = torch.exp(batch.log_prob)
    elif batch.arm_presence is not None:
        logged_action_prob = 1.0 / torch.sum(batch.arm_presence, dim=1, keepdim=True)
    else:
        logged_action_prob = 1.0 / (
            torch.ones_like(logged_actions, dtype=torch.float32)
            * batch.context_arm_features.shape[1])
    importance_weights = 1.0 / logged_action_prob
    if max_importance_weight is not None:
        importance_weights = torch.clamp(importance_weights, max=max_importance_weight)
    return batch.replace(importance_weight=(logged_actions == model_actions).to(torch.float32)
                         * importance_weights)


def effective_weight(batch: CBInput) -> Tensor:
    """weight * importance_weight (reference CBInput.effective_weight)."""
    assert batch.importance_weight is not None
    weight = (batch.weight if batch.weight is not None
              else torch.ones_like(batch.importance_weight))
    return weight * batch.importance_weight
