"""Batch-constrained Q-learning imitator gating.

Port of ``reagent_tpu/models/bcq.py`` (reference: reagent/models/bcq.py):
actions whose imitator probability is below ``drop_threshold`` times the
row's largest have their Q-values driven to the ``-3.4e38`` sentinel.
"""

from __future__ import annotations

import torch
from torch import nn

# the fill of a dropped action: finite, below every real Q-value
DROPPED_Q_VALUE = -3.4e38


class BatchConstrainedDQN(nn.Module):
    """Functional gating: combine externally computed q and imitator logits."""

    def __init__(self, drop_threshold: float = 0.1):
        super().__init__()
        self.drop_threshold = drop_threshold

    def forward(self, q_values: torch.Tensor, imitator_logits: torch.Tensor) -> torch.Tensor:
        return bcq_mask_q_values(q_values, imitator_logits, self.drop_threshold)


def bcq_mask_q_values(
    q_values: torch.Tensor, imitator_logits: torch.Tensor, drop_threshold: float
) -> torch.Tensor:
    """Mask Q-values of actions the imitator deems unlikely (reference
    dqn_trainer.py:46-56)."""
    probs = torch.softmax(imitator_logits, dim=1)
    max_prob = probs.max(dim=1, keepdim=True).values
    allowed = probs >= drop_threshold * max_prob
    return torch.where(allowed, q_values, torch.full_like(q_values, DROPPED_Q_VALUE))
